"""Gradients of tpu_rt_torch's ultrasound path against tpu_rt's jax.grad,
on the CPU: the acoustic wavefront, the B-mode frame (DAS, envelope, log),
the DAS's adjoint, the kernel route's fastgrad, and the per-scene caches
under autograd.

Inputs are made with numpy from a seed or by the scene helpers.
Tolerances, and why:

* the acquisition's gradient fed tpu_rt's own threefry draws
  (``uniforms=``): each component within 1e-3 relative of jax.grad's on
  the plate (largest seen 7.6e-5), 2e-2 on the USMain-class scene (7.5e-3
  seen; 4.9e-3 at USMain's full width).  The forward agrees to every RF
  sample within 1e-3 of the largest |RF| (tests/test_torch_us_wavefront.py):
  XLA contracts the time of flight's multiply-adds into FMAs, so a time
  index moves by an ulp, up to 9.8e-4 of a sample, and moves that share
  of an echo between its taps; the gradient of sum(ch^2) weighs each tap
  by its own value, so it moves by that order too, and more where its
  terms cancel: the sampling rate's and the sound speed's reach each echo
  through its two taps with opposite signs.  The plate's echoes sit far
  from a sample's edge;
* the B-mode MSE's gradient on the same RF: the images differ by up to
  1.7e-4 (float32 FFTs and the sums in another order), and the log's
  derivative 20 / (ln 10 env) amplifies that at dim pixels, where a pixel
  within rounding of the 60 dB floor is clamped in one package and not in
  the other.  So for the RF: the L1 difference within 1e-3 of the L1 norm
  (2.4e-4 seen), 99.9% of entries within 1e-3 of the largest (99.97%
  seen), every entry within 2e-2 of it; for the geometry (element x and
  z, the angles, c and fs) each within 2e-3 of its largest (5.6e-4 seen).
  tpu_rt's matmul form computes the image from hat weights of a windowed
  index (t_f - 64 q), rounded apart from the gather form's weight, and its
  image differs from the port's gather form by up to 1.2e-3; against it
  the RF's L1 difference is held within 5e-3 (1.7e-3 seen), 99.5% of
  entries within 1e-3 of the largest (99.875% seen) and every entry
  within 0.5 of it (0.29 seen, at a pixel on the floor), the geometry
  within 2e-3 (5.7e-4 seen);
* the adjoint identity <DAS(x), y> = <x, DAS^T(y)> in float32: within
  1e-5 of sum |DAS(x) y| (the rounding of float32 sums of that many
  terms; 3e-7 seen);
* fastgrad: the primal equals the kernel's plain version exactly, and its
  gradient the wavefront's at the same seed exactly (the same operations
  replayed); two frames of one scene give each a fresh scene's gradient,
  exactly.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_rt
import tpu_rt_torch
from tpu_rt.integrator import ultrasound as wave_j
from tpu_rt.sensor.transducer import element_geometry as element_geometry_j
from tpu_rt.us import beamform as beam_j
from tpu_rt_torch.integrator import ultrasound as wave_t
from tpu_rt_torch.ops import us_kernel
from tpu_rt_torch.us import beamform as beam_t
from tpu_rt_torch.us import pipeline
from test_torch_us_wavefront import tpu_rt_draws
from torch_port_scenes import plate_desc, usmain_desc

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
US_KEYS = ("pitch", "sound_speed", "attenuation", "frequency", "sampling_rate")
SMALL = dict(x_bounds=(-0.004, 0.004), z_bounds=(0.008, 0.012))


def usmain_narrow_desc(st):
    """USMain (64 elements, 10 000 samples, depth 10, its plate and back
    wall) at 3 angles."""
    desc = usmain_desc(st)
    desc["integrator"].update(angles=np.linspace(-15, 15, 3))
    return desc


def _pair(desc_fn):
    return (tpu_rt.load_dict(desc_fn(tpu_rt.ScalarTransform4f)),
            tpu_rt_torch.load_dict(desc_fn(tpu_rt_torch.ScalarTransform4f)))


def _with_leaves(scene, us_keys=(), bsdf=True):
    """The scene with its BSDF table and the named ultrasound tensors as
    new leaves that require grad; returns (scene, {name: leaf})."""
    leaves = {k: getattr(scene.ultrasound, k).clone().requires_grad_() for k in us_keys}
    if bsdf:
        leaves["bsdf_params"] = scene.bsdf_params.clone().requires_grad_()
        scene = scene.replace(bsdf_params=leaves["bsdf_params"])
    us = scene.ultrasound.replace(**{k: leaves[k] for k in us_keys})
    return scene.replace(ultrasound=us), leaves


# (scene, seed, rays per pair, rtol)
ACQ_GRAD = {"plate": (plate_desc, 0, 2, 1e-3), "usmain_narrow": (usmain_narrow_desc, 4, 1, 2e-2)}


@pytest.mark.parametrize("case", sorted(ACQ_GRAD))
def test_acquisition_gradient_matches_tpu_rt_fed_its_draws(case):
    """d sum(ch^2) with respect to the BSDF table (impedance, roughness,
    exterior impedance) and the ultrasound keys, jax.grad of tpu_rt's
    acquisition against autograd of the port's fed the same draws."""
    desc, seed, rpp, rtol = ACQ_GRAD[case]
    sj, st = _pair(desc)

    def loss_j(params, us):
        sc = sj.replace(bsdf_params=params, ultrasound=sj.ultrasound.replace(**us))
        ch, _ = wave_j.simulate_acquisition(sc, seed=seed, rays_per_pair=rpp)
        return jnp.sum(ch * ch)

    g_p, g_us = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(
        sj.bsdf_params, {k: getattr(sj.ultrasound, k) for k in US_KEYS})
    sc, leaves = _with_leaves(st, US_KEYS)
    ch, _ = wave_t.simulate_acquisition(sc, seed=seed, rays_per_pair=rpp, device="cpu",
                                        uniforms=tpu_rt_draws(seed, st.ultrasound, rpp))
    (ch * ch).sum().backward()
    want = np.asarray(g_p)[:, :3]
    got = leaves["bsdf_params"].grad.numpy()[:, :3]
    assert np.abs(want[0, :2]).min() > 0, "impedance and roughness get no gradient"
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    for k in US_KEYS:
        w, g = float(g_us[k]), float(leaves[k].grad)
        assert w != 0.0 and abs(g - w) <= rtol * abs(w), (k, g, w)


def _frame_inputs():
    """tpu_rt's acquisition of the plate (the RF, and a target B-mode from
    another seed) and the DAS's geometry on the small grid."""
    sj = tpu_rt.load_dict(plate_desc(tpu_rt.ScalarTransform4f))
    us = sj.ultrasound
    ch, _ = wave_j.simulate_acquisition(sj, seed=0, rays_per_pair=2)
    ch_t, _ = wave_j.simulate_acquisition(sj, seed=1, rays_per_pair=2)
    step = float(us.sound_speed) / float(us.frequency) / 4.0
    xg, zg = beam_j.grid_scan(*SMALL["x_bounds"], *SMALL["z_bounds"], step, step)
    pos, _ = element_geometry_j(us.n_elements, us.pitch, us.radius, 0.0)
    geo = (pos[:, 0], pos[:, 2], us.angles, us.sound_speed, us.sampling_rate)
    return ch, ch_t, xg, zg, geo


@pytest.mark.parametrize("method", ["gather", "matmul"])
def test_frame_gradient_matches_tpu_rt(method):
    """jax.grad of a B-mode MSE through tpu_rt's bmode_pipeline (its gather
    or matmul DAS) against autograd through the port's gather form on the
    same RF: with respect to the RF, the element positions, the angles
    and, for the gather form, c and fs (tpu_rt's matmul form reads c and
    fs as numbers to size its window)."""
    ch, ch_t, xg, zg, (ex, ez, ang, c, fs) = _frame_inputs()
    target = beam_j.bmode_pipeline(ch_t, ang, ex, fs, c, xg, zg, method=method, elem_z=ez)
    n_geo = 5 if method == "gather" else 3

    def loss_j(rf, ex_, ez_, ang_, *cf):
        c_, fs_ = cf if cf else (c, fs)
        img = beam_j.bmode_pipeline(rf, ang_, ex_, fs_, c_, xg, zg, method=method, elem_z=ez_)
        return jnp.mean((img - target) ** 2)

    args = (ch, ex, ez, ang, c, fs)[:1 + n_geo]
    fn = jax.grad(loss_j, argnums=tuple(range(1 + n_geo)))
    want = [np.asarray(g) for g in (jax.jit(fn) if method == "gather" else fn)(*args)]
    ins = [torch.from_numpy(np.array(x)).requires_grad_() for x in (ch, ex, ez, ang, c, fs)]
    img = beam_t.bmode_pipeline(ins[0], ins[3], ins[1], ins[5], ins[4],
                                torch.from_numpy(np.array(xg)), torch.from_numpy(np.array(zg)),
                                method="gather", elem_z=ins[2])
    ((img - torch.from_numpy(np.array(target))) ** 2).mean().backward()
    got = [x.grad.numpy() for x in ins]
    l1, share, worst = {"gather": (1e-3, 0.999, 2e-2), "matmul": (5e-3, 0.995, 0.5)}[method]
    d, big = np.abs(got[0] - want[0]), np.abs(want[0]).max()
    assert big > 0 and d.sum() <= l1 * np.abs(want[0]).sum()
    assert (d <= 1e-3 * big).mean() >= share and d.max() <= worst * big
    for name, g, w in zip(("elem_x", "elem_z", "angles", "c", "fs"), got[1:], want[1:]):
        scale = np.abs(w).max()
        assert scale > 0 and np.abs(g - w).max() <= 2e-3 * scale, name


def _das_case(seed=3, A=3, E=12, T=500, convex=True):
    rng = np.random.default_rng(seed)
    rf = torch.from_numpy(rng.normal(size=(A, E, T)).astype(np.float32))
    ex = torch.linspace(-0.003, 0.003, E)
    ez = (ex ** 2 * 20.0) if convex else torch.zeros(E)
    ang = torch.tensor(np.linspace(-10, 10, A), dtype=torch.float32)
    xg, zg = beam_t.grid_scan(-0.004, 0.004, 0.002, 0.007, 0.0002, 0.0001)
    c, fs = torch.tensor(1540.0), torch.tensor(50e6)
    return rf, ex, ez, ang, c, fs, xg, zg


@pytest.mark.parametrize("convex", [False, True])
def test_das_adjoint_identity_and_plain_adjoint(convex):
    """<DAS(x), y> = <x, DAS^T(y)> with DAS^T = ``das_adjoint`` (on the
    CPU its plain version, autograd of the gather form), and
    ``das_adjoint_plain``'s geometric cotangents, chained to the angles
    and c, equal autograd through ``das_beamform_plain``."""
    rf, ex, ez, ang, c, fs, xg, zg = _das_case(convex=convex)
    y = torch.from_numpy(np.random.default_rng(4).normal(size=(xg.numel(), zg.numel()))
                         .astype(np.float32))
    out = beam_t.das_beamform(rf, ang, ex, fs, c, xg, zg, elem_z=ez)
    rad = ang * np.float32(np.pi / 180)
    sin_a, cos_a = torch.sin(rad), torch.cos(rad)
    grads = beam_t.das_adjoint(rf, ex, ez, sin_a, cos_a, 1.0 / c, fs, xg, zg, y)
    lhs = (out.double() * y.double()).sum().item()
    rhs = (rf.double() * grads[0].double()).sum().item()
    assert abs(lhs - rhs) <= 1e-5 * (out.double() * y.double()).abs().sum().item()

    ins = [x.clone().requires_grad_() for x in (rf, ex, ez, ang, c, fs)]
    out = beam_t.das_beamform_plain(ins[0], ins[3], ins[1], ins[5], ins[4], xg, zg,
                                    elem_z=ins[2])
    (out * y).sum().backward()
    d_rf, d_ex, d_ez, d_sin, d_cos, d_inv_c, d_fs = grads
    d_ang = (d_sin * cos_a - d_cos * sin_a) * np.float32(np.pi / 180)
    d_c = -d_inv_c / (c * c)
    for got, leaf in ((d_rf, ins[0]), (d_ex, ins[1]), (d_ez, ins[2]), (d_ang, ins[3]),
                      (d_c, ins[4]), (d_fs, ins[5])):
        np.testing.assert_allclose(got.numpy(), leaf.grad.numpy(), rtol=1e-4,
                                   atol=1e-5 * leaf.grad.abs().max().item())


def test_fastgrad_primal_is_the_kernel_and_gradient_the_wavefront():
    """tests/test_pallas_us.py::test_us_fastgrad_vjp_matches_xla_grad: the
    primal equals the kernel route's acquisition (its plain version on the
    CPU) bit for bit; the gradient equals the wavefront's VJP at the same
    seed applied to the cotangent at the kernel's primal, bit for bit."""
    st = tpu_rt_torch.load_dict(plate_desc(tpu_rt_torch.ScalarTransform4f))
    assert pipeline.in_kernel_scope(st)
    sc, leaves = _with_leaves(st, ("pitch",))
    ch, tx = us_kernel.simulate_acquisition_fastgrad(sc, seed=0, rays_per_pair=2, device="cpu")
    ch_k, tx_k = us_kernel.simulate_acquisition(st, seed=0, rays_per_pair=2, device="cpu")
    assert torch.equal(ch.detach(), ch_k) and torch.equal(tx.detach(), tx_k)
    assert ch.requires_grad and ch_k.abs().sum() > 0
    g_fast = torch.autograd.grad((ch * ch).sum() * 1e3, list(leaves.values()))

    sc2, leaves2 = _with_leaves(st, ("pitch",))
    ch_w, _ = wave_t.simulate_acquisition(sc2, seed=0, rays_per_pair=2, device="cpu")
    g_ref = torch.autograd.grad(ch_w, list(leaves2.values()), 2.0 * ch_k * 1e3)
    for a, b in zip(g_fast, g_ref):
        assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    assert g_fast[1][0, :2].abs().min() > 0  # impedance and roughness


def test_us_render_kernel_route_backpropagates():
    """C6: ``us_render(use_kernel=True)`` of a scene whose BSDF table
    requires grad returns a B-mode whose backward fills the gradient; the
    forward equals the frame without autograd."""
    st = tpu_rt_torch.load_dict(plate_desc(tpu_rt_torch.ScalarTransform4f))
    sc, leaves = _with_leaves(st)
    img, ch, tx = pipeline.us_render(sc, rays_per_pair=2, device="cpu", **SMALL)
    img0, ch0, _ = pipeline.us_render(st, rays_per_pair=2, device="cpu", **SMALL)
    assert torch.equal(img.detach(), img0) and torch.equal(ch.detach(), ch0)
    assert img.std().item() > 0.05  # the grid holds the plate's echo
    (img * img).mean().backward()
    g = leaves["bsdf_params"].grad
    assert bool(torch.isfinite(g).all()) and g[0, :2].abs().min() > 0
    img_j = pipeline.us_render_jit(sc, rays_per_pair=2, device="cpu")
    assert img_j.requires_grad and img_j.dim() == 2


@pytest.mark.parametrize("what", ["pitch", "sound_speed", "bsdf_params"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_two_frames_of_one_scene_backpropagate(what, use_kernel):
    """C7: two frames of one scene, with ``what`` requiring grad, both
    backpropagate, each with the gradient of a freshly built scene at the
    same seed; a frame without autograd after them equals one before."""
    def build():
        st = tpu_rt_torch.load_dict(plate_desc(tpu_rt_torch.ScalarTransform4f))
        keys = () if what == "bsdf_params" else (what,)
        return st, _with_leaves(st, keys, bsdf=what == "bsdf_params")

    def frame_grad(sc, leaf):
        img, _, _ = pipeline.us_render(sc, seed=1, rays_per_pair=2, device="cpu",
                                       use_kernel=use_kernel, **SMALL)
        return torch.autograd.grad((img * img).mean(), leaf)[0]

    st, (sc, leaves) = build()
    before = pipeline.us_render(st, seed=1, rays_per_pair=2, device="cpu",
                                use_kernel=use_kernel, **SMALL)[0]
    grads = [frame_grad(sc, leaves[what]) for _ in range(2)]
    _, (fresh, fresh_leaves) = build()
    want = frame_grad(fresh, fresh_leaves[what])
    for g in grads:
        assert torch.equal(g, want) and bool(torch.isfinite(g).all()) and g.abs().sum() > 0
    after = pipeline.us_render(st, seed=1, rays_per_pair=2, device="cpu",
                               use_kernel=use_kernel, **SMALL)[0]
    assert torch.equal(before, after)


def test_grad_path_never_imports_jax():
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "import tpu_rt_torch as tt\n"
        "from tpu_rt_torch.opt import checkpoint, inverse\n"
        "from tpu_rt_torch import compat\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'tests')!r})\n"
        "from torch_port_scenes import plate_desc\n"
        "sc = tt.load_dict(plate_desc(tt.ScalarTransform4f))\n"
        "key = 'plate.bsdf.roughness'\n"
        "assert key in compat.traverse(sc)\n"
        "out, losses = inverse.optimize(sc, [key], lambda s: (inverse.get_param(s, key) - 0.3)"
        " ** 2, n_iters=2)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'tpu_rt')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
