"""tpu_rt_torch's inverse rendering (opt/inverse.py, opt/checkpoint.py),
its reference shims (compat.py) and the optical wavefront's gradient,
against tpu_rt's, on the CPU.

Tolerances, and why:

* parameter recovery: tpu_rt's own bars (tests/test_parallel_and_grad.py
  :137-245): the loss at least halved (impedance) or cut by 30%
  (roughness), the parameter within 1.5 of 7 and 0.25 of 0.7; the same
  bars for the roughness through the kernel route's fastgrad;
* a deterministic loss (written in both frameworks): the two Adam loops
  agree to float32 rounding over 12 steps, every loss within rtol 1e-5,
  every parameter within rtol 1e-5 plus 1e-4 of the learning rate
  (optax's adam and torch's Adam take the same steps, eps outside the
  square root, bias-corrected; the order of their float32 operations
  differs, and Adam's step m / sqrt(v) normalizes the gradient, so where
  the gradient is near 0 its rounding moves the step by a share of lr:
  3.1e-5 relative, 2.6e-6 absolute seen at lr 0.05);
* a loop carried from tpu_rt into the port (3 + 3 steps against tpu_rt's
  6): the same bounds;
* checkpoints: a resumed loop's first losses equal the uninterrupted
  loop's exactly (the same operations in the same order);
* the path tracer's gradient of the mean radiance with respect to the
  BSDF table, fed tpu_rt's draws: rtol 1e-3 and atol 1e-6 of the largest
  (1e-4 seen): the forward agrees to rtol 1e-4 on 99% of the lanes
  (tests/test_torch_wavefront.py), and on this cbox every lane follows
  tpu_rt's path.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_rt
import tpu_rt_torch
from tpu_rt import compat as compat_j
from tpu_rt.integrator import path as path_j
from tpu_rt.opt import checkpoint as ckpt_j
from tpu_rt.opt import inverse as inv_j
from tpu_rt.sensor import camera as cam_j
from tpu_rt_torch import compat
from tpu_rt_torch.integrator import path as path_t
from tpu_rt_torch.integrator import ultrasound as wave_t
from tpu_rt_torch.ops import us_kernel
from tpu_rt_torch.opt import checkpoint, inverse
from torch_port_scenes import plate_desc, usmain_desc

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
CBOX = os.path.join(HERE, "assets", "cbox", "cbox.xml")


def _plate(impedance, roughness, angles, z=0.008, scale=0.02, n_elements=16, time_samples=600,
           max_depth=2):
    """The plate scenes of tests/test_parallel_and_grad.py:137-245 and
    tests/test_opt_extras.py:50-72."""
    st = tpu_rt_torch.ScalarTransform4f
    return tpu_rt_torch.load_dict({
        "type": "scene",
        "integrator": {"type": "ultrasound_integrator", "max_depth": max_depth,
                       "n_elements": n_elements, "time_samples": time_samples,
                       "pitch": 0.0005, "angles": np.asarray(angles, np.float32)},
        "sensor": {"type": "ultrasound_sensor", "num_elements_lateral": n_elements,
                   "pitch": 0.0005, "radius": float("inf"), "to_world": st()},
        "plate": {"type": "rectangle",
                  "to_world": st().translate([0, 0, z]) @ st().rotate([0, 1, 0], 180)
                  @ st().scale([scale, scale, 1]),
                  "bsdf": {"type": "ultrasound_bsdf", "impedance": impedance,
                           "roughness": roughness}},
    })


def _rf_loss(scene, key, value, rpp):
    target = inverse.set_param(scene, key, value)
    ch_t, _ = wave_t.simulate_acquisition(target, seed=0, rays_per_pair=rpp, device="cpu")

    def loss_fn(sc):
        ch, _ = wave_t.simulate_acquisition(sc, seed=0, rays_per_pair=rpp, device="cpu")
        return ((ch - ch_t) ** 2).mean() * 1e6

    return loss_fn


def test_inverse_rendering_recovers_impedance():
    """The twin of tests/test_parallel_and_grad.py::
    test_inverse_rendering_recovers_impedance, at its bars."""
    scene = _plate(4.0, 0.5, [0.0])
    key = "plate.bsdf.impedance"
    assert key in inverse.traverse(scene)
    out, losses = inverse.optimize(scene, [key], _rf_loss(scene, key, 7.0, 4), n_iters=30,
                                   lr=0.15, bounds=(1.0, 10.0))
    recovered = float(inverse.get_param(out, key))
    assert losses[-1] < losses[0] * 0.5, f"loss did not decrease: {losses[:3]}...{losses[-3:]}"
    assert abs(recovered - 7.0) < 1.5, f"recovered impedance {recovered} != 7.0"


def test_inverse_rendering_recovers_roughness():
    """The twin of tests/test_parallel_and_grad.py::
    test_inverse_rendering_recovers_roughness (USMain.py:262-289's key and
    start), at its bars."""
    scene = _plate(7.8, 0.1, [-5.0, 5.0])
    key = "plate.bsdf.roughness"
    out, losses = inverse.optimize(scene, [key], _rf_loss(scene, key, 0.7, 8), n_iters=25,
                                   lr=2e-2, bounds=(1e-4, 1.0))
    recovered = float(inverse.get_param(out, key))
    assert losses[-1] < losses[0] * 0.7, f"loss: {losses[0]:.3g}->{losses[-1]:.3g}"
    assert abs(recovered - 0.7) < 0.25, f"recovered roughness {recovered} != 0.7"


@pytest.mark.parametrize("seed", [0, 1])
def test_inverse_rendering_recovers_roughness_through_fastgrad(seed):
    """The roughness twin through the kernel route: the RF of
    ops/us_kernel.py::simulate_acquisition_fastgrad (K10's plain version as
    the primal, the wavefront's gradient on its own stream), at tpu_rt's
    bars, with 32 rays a pair.  fastgrad's gradient is an estimate
    independent of the primal, so at the test's 8 rays a pair neither
    package's fastgrad holds the roughness bar (tpu_rt 0.3091, the port
    0.3712 at seed 0: tests/torch_fastgrad_witness.py)."""
    scene = _plate(7.8, 0.1, [-5.0, 5.0])
    key = "plate.bsdf.roughness"
    target = inverse.set_param(scene, key, 0.7)
    ch_t, _ = us_kernel.simulate_acquisition_fastgrad(target, seed=seed, rays_per_pair=32,
                                                      device="cpu")

    def loss_fn(sc):
        ch, _ = us_kernel.simulate_acquisition_fastgrad(sc, seed=seed, rays_per_pair=32,
                                                        device="cpu")
        return ((ch - ch_t) ** 2).mean() * 1e6

    out, losses = inverse.optimize(scene, [key], loss_fn, n_iters=25, lr=2e-2,
                                   bounds=(1e-4, 1.0))
    recovered = float(inverse.get_param(out, key))
    assert losses[-1] < losses[0] * 0.7, f"loss: {losses[0]:.3g}->{losses[-1]:.3g}"
    assert abs(recovered - 0.7) < 0.25, f"recovered roughness {recovered} != 0.7"


KEYS = ("plate.bsdf.impedance", "plate.bsdf.roughness", "ultrasound.attenuation")


def _det_loss(p, lib):
    """A deterministic loss of three parameters, in numpy-like ``lib``
    (jnp or torch)."""
    imp, rough, att = p
    return (imp - 5.5) ** 2 + 10.0 * (rough - 0.3) ** 2 + lib.sin(imp * rough) + (att - 0.9) ** 2


def _tpu_rt_loop(n_iters, lr=0.05, path=None, every=3):
    sj = tpu_rt.load_dict(plate_desc(tpu_rt.ScalarTransform4f, impedance=3.0, roughness=0.6))
    out, losses = inv_j.optimize(
        sj, list(KEYS), lambda sc: _det_loss([inv_j.get_param(sc, k) for k in KEYS], jnp),
        n_iters=n_iters, lr=lr, bounds=(1e-4, 10.0), checkpoint_path=path,
        checkpoint_every=every)
    return [float(inv_j.get_param(out, k)) for k in KEYS], losses


def _port_loop(n_iters, lr=0.05, path=None):
    st = tpu_rt_torch.load_dict(plate_desc(tpu_rt_torch.ScalarTransform4f, impedance=3.0,
                                           roughness=0.6))
    out, losses = inverse.optimize(
        st, list(KEYS), lambda sc: _det_loss([inverse.get_param(sc, k) for k in KEYS], torch),
        n_iters=n_iters, lr=lr, bounds=(1e-4, 10.0), checkpoint_path=path)
    return [float(inverse.get_param(out, k)) for k in KEYS], losses


def test_optimize_trajectory_matches_tpu_rt():
    """12 Adam steps on a deterministic loss of a BSDF slot pair and an
    ultrasound key: torch's Adam against optax's, step for step."""
    want_p, want_l = _tpu_rt_loop(12)
    got_p, got_l = _port_loop(12)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    np.testing.assert_allclose(got_p, want_p, rtol=1e-5, atol=1e-4 * 0.05)
    assert want_l[-1] < 0.7 * want_l[0]  # the loop moves toward the minimum


def test_adam_state_carries_a_tpu_rt_loop_into_the_port():
    """3 steps in tpu_rt (its checkpoint read by tpu_rt), its optax state
    turned into a torch Adam state_dict (``adam_state_from_arrays``), then
    3 more in the port: tpu_rt's 6-step loop."""
    want_p, want_l = _tpu_rt_loop(6)
    with tempfile.TemporaryDirectory() as td:
        path_j_ck, path_t_ck = os.path.join(td, "j.pkl"), os.path.join(td, "t.pt")
        _tpu_rt_loop(3, path=path_j_ck)
        params, opt_state, losses, it = ckpt_j.load_checkpoint(path_j_ck)
        adam = opt_state[0]
        arrays = {k: np.asarray(params[k]) for k in KEYS}
        sd = checkpoint.adam_state_from_arrays(
            arrays, {k: np.asarray(adam.mu[k]) for k in KEYS},
            {k: np.asarray(adam.nu[k]) for k in KEYS}, int(adam.count), lr=0.05)
        checkpoint.save_checkpoint(path_t_ck, {k: torch.tensor(v) for k, v in arrays.items()},
                                   sd, losses, it)
        got_p, got_l = _port_loop(6, path=path_t_ck)
    assert it == 3 and len(got_l) == 6
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    np.testing.assert_allclose(got_p, want_p, rtol=1e-5, atol=1e-4 * 0.05)


def test_checkpoint_roundtrip():
    """tests/test_opt_extras.py::test_checkpoint_roundtrip in the port's
    format."""
    params = {"a": torch.tensor([1.0, 2.0]), "b": torch.tensor(3.0)}
    opt = torch.optim.Adam([params["a"].clone().requires_grad_()], lr=0.1)
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "ck.pt")
        checkpoint.save_checkpoint(p, params, opt.state_dict(), [0.5, 0.4], 7)
        assert not os.path.exists(p + ".tmp")
        params2, opt2, losses, it = checkpoint.load_checkpoint(p)
        np.testing.assert_allclose(params2["a"].numpy(), [1.0, 2.0])
        assert float(params2["b"]) == 3.0 and opt2["param_groups"][0]["lr"] == 0.1
        assert losses == [0.5, 0.4] and it == 7
        assert checkpoint.load_checkpoint(p + ".nope") is None


def test_optimize_resumes_from_checkpoint():
    """tests/test_opt_extras.py::test_optimize_resumes_from_checkpoint: 6
    iterations saved every 3, then resumed to 10, continue the loop."""
    scene = _plate(3.0, 0.3, [0.0], z=0.005, scale=0.01, n_elements=8, time_samples=400,
                   max_depth=1)
    key = "plate.bsdf.impedance"
    loss_fn = _rf_loss(scene, key, 6.0, 1)
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "opt.ckpt")
        _, losses1 = inverse.optimize(scene, [key], loss_fn, n_iters=6, lr=0.2,
                                      bounds=(1.0, 10.0), checkpoint_path=p, checkpoint_every=3)
        assert os.path.exists(p)
        _, losses2 = inverse.optimize(scene, [key], loss_fn, n_iters=10, lr=0.2,
                                      bounds=(1.0, 10.0), checkpoint_path=p, checkpoint_every=3)
        assert len(losses2) == 10 and losses2[:6] == losses1
        _, straight = inverse.optimize(scene, [key], loss_fn, n_iters=10, lr=0.2,
                                       bounds=(1.0, 10.0))
        assert losses2 == straight


@pytest.mark.parametrize("which", ["cbox", "usmain"])
def test_traverse_keys_match_tpu_rt(which):
    if which == "cbox":
        sj, st = tpu_rt.load_file(CBOX, res=8, spp=1), tpu_rt_torch.load_file(CBOX, res=8, spp=1)
    else:
        sj = tpu_rt.load_dict(usmain_desc(tpu_rt.ScalarTransform4f))
        st = tpu_rt_torch.load_dict(usmain_desc(tpu_rt_torch.ScalarTransform4f))
    assert st.ids == sj.ids
    assert inverse.traverse(st) == inv_j.traverse(sj) == list(compat.traverse(st))
    assert list(compat_j.traverse(sj)) == list(compat.traverse(st))
    for k in inverse.traverse(st):
        np.testing.assert_allclose(inverse.get_param(st, k).numpy(),
                                   np.asarray(inv_j.get_param(sj, k)), rtol=1e-7)


def test_params_update_and_set_param_carry_gradients():
    """compat's Params.update() returns a scene with the changed value;
    set_param copies the BSDF table (the old scene keeps its value) and
    passes a gradient on to the value it sets."""
    st = tpu_rt_torch.load_dict(usmain_desc(tpu_rt_torch.ScalarTransform4f))
    params = compat.traverse(st)
    params["flat_plate.bsdf.roughness"] = 0.25
    params["ultrasound.pitch"] = 2e-4
    sc = params.update()
    assert sc is params.scene
    assert float(inverse.get_param(sc, "flat_plate.bsdf.roughness")) == np.float32(0.25)
    assert float(sc.ultrasound.pitch) == np.float32(2e-4)
    assert float(inverse.get_param(st, "flat_plate.bsdf.roughness")) == np.float32(0.7)
    v = torch.tensor(0.4, requires_grad=True)
    sc2 = inverse.set_param(st, "wall_back.bsdf.impedance", v)
    (sc2.bsdf_params * 3.0).sum().backward()
    assert float(v.grad) == 3.0 and not st.bsdf_params.requires_grad


def test_ultra_integrator_fills_its_buffers():
    """compat.UltraIntegrator against tpu_rt's: the wavefront's buffers of
    the same shapes, the same transmit delays and ray count."""
    sj = tpu_rt.load_dict(plate_desc(tpu_rt.ScalarTransform4f))
    st = tpu_rt_torch.load_dict(plate_desc(tpu_rt_torch.ScalarTransform4f))
    ij, it = compat_j.scene_integrator(sj), compat.scene_integrator(st, device="cpu")
    assert ij.simulate_acquisition(rays_per_pair=2) and it.simulate_acquisition(rays_per_pair=2)
    assert tuple(it.channel_buf.shape) == ij.channel_buf.shape == (3, 16, 800)
    np.testing.assert_allclose(it.transmission_delays_buf.numpy(),
                               ij.transmission_delays_buf, rtol=0, atol=1e-12)
    assert it.ray_count == ij.ray_count == 3 * 16 * 2 * 3
    assert it.channel_buf.abs().sum() > 0 and (it.fs, it.pitch) == (ij.fs, ij.pitch)
    ch, _ = wave_t.simulate_acquisition(st, seed=0, rays_per_pair=2, device="cpu")
    assert torch.equal(it.channel_buf, ch)
    assert it.simulate_acquisition_parallel(rays_per_pair=1)
    assert it.ray_count == 3 * 16 * 3


def test_path_gradients_finite_and_match_tpu_rt():
    """The twin of tests/test_parallel_and_grad.py::test_path_gradients_finite
    (whose original reads the reference repository's cbox) on the in-repo cbox, 16x16,
    depth 6, three seeds: the port's gradient of the mean radiance with
    respect to the BSDF table is finite, reaches the diffuse
    reflectances, and equals jax.grad of tpu_rt's path_trace fed the same
    draws."""
    sj = tpu_rt.load_file(CBOX, res=16, spp=1).replace(max_depth=6)
    st = tpu_rt_torch.load_file(CBOX, res=16, spp=1).replace(max_depth=6)
    xy = (jnp.stack(jnp.meshgrid(jnp.arange(16), jnp.arange(16), indexing="xy"), -1)
          .reshape(-1, 2).astype(jnp.float32) + 0.5)
    o, d = cam_j.sample_ray(sj.camera, xy)

    def loss(params, key):
        L, _ = path_j.path_trace(sj.replace(bsdf_params=params), o, d, key)
        return jnp.mean(L)

    grad_j = jax.jit(jax.grad(loss))
    n_iters = path_t.n_bounces(st)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(grad_j(sj.bsdf_params, key))
        u = np.stack([np.asarray(jax.random.uniform(k, (o.shape[0], 8)))
                      for k in jax.random.split(key, n_iters)])
        p = st.bsdf_params.clone().requires_grad_()
        L, _ = path_t.path_trace(st.replace(bsdf_params=p), torch.from_numpy(np.array(o)),
                                 torch.from_numpy(np.array(d)), uniforms=torch.from_numpy(u))
        L.mean().backward()
        g = p.grad.numpy()
        assert np.isfinite(g).all(), f"non-finite gradient at seed {seed}"
        assert np.abs(g[:3, :3]).sum() > 0  # the diffuse reflectances
        np.testing.assert_allclose(g, want, rtol=1e-3, atol=1e-6 * np.abs(want).max())


def test_render_of_a_scene_requiring_grad_takes_the_wavefront():
    """render() of a path scene in the film kernel's scope, and of a mesh
    scene (K7's plain version, t detached), whose BSDF table requires
    grad: through the wavefront, a finite, non-zero gradient; the same
    scene without autograd still takes the film kernel."""
    for path, res in ((CBOX, 8), (os.path.join(HERE, "assets", "mesh", "mesh_gi.xml"), 8)):
        st = tpu_rt_torch.load_file(path, res=res, spp=1)
        p = st.bsdf_params.clone().requires_grad_()
        img = tpu_rt_torch.render(st.replace(bsdf_params=p), device="cpu")
        img.mean().backward()
        assert bool(torch.isfinite(p.grad).all()) and p.grad.abs().sum() > 0, path
        with torch.no_grad():
            img2 = tpu_rt_torch.render(st.replace(bsdf_params=p), device="cpu")
        assert not img2.requires_grad
