"""tpu_rt_torch's acoustic wavefront (the ultrasound acquisition as one
PyTorch pass a bounce) against tpu_rt's, on the CPU, and the routes of
``us_render``.

Inputs are made with numpy from a seed, or by the scene helpers of
``torch_port_scenes.py``.  Tolerances, and why:

* the acoustic BSDF sample: rtol 1e-5 (atol 1e-5 on direction
  components near 0) and the same lobe on every lane: the two packages
  round sqrt, sin and cos differently by an ulp;
* rays of the transducer samplers: 1e-6 (float32 sin / cos);
* the acquisition fed tpu_rt's own threefry draws (``uniforms=``): total
  |RF| within 1e-3; every RF sample within 1e-3 of the largest |RF|: XLA
  on the CPU contracts the time of flight's multiply-adds into FMAs, so a
  time index moves by an ulp, which below sample 16 384 is up to 2^-10 =
  9.8e-4 of a sample and moves that share of an echo's pressure from one
  tap to the other (the largest difference on these cases is 5.4e-4); at
  1e-4 of the largest |RF|, at least 60% of the non-zero samples (the rest
  are such moved taps: 72-83% agree on these cases).  On these seeds no lane takes the other branch (a
  roulette or lobe draw, or a shadow ray grazing an edge, one an ulp
  from its threshold): such a lane would move a whole echo, far past
  1e-3 of the largest |RF|;
* ``us_render`` against tpu_rt's ``us_render(use_pallas=False)`` on the
  same draws: its DAS is the matmul form, the port's the gather form, and
  the log compression amplifies the noise floor's moved taps, so at least
  97% of pixels within 1e-3 (98.8% on this seed), the mean within 1e-4
  and every pixel within 0.05 (3 dB of the 60 dB range);
* the physics twins keep tpu_rt's own bounds (tests/test_ultrasound.py,
  tests/test_pulse_and_film.py).
"""

import functools
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
from tpu_rt.bsdf import acoustic as acoustic_j
from tpu_rt.integrator import ultrasound as wave_j
from tpu_rt.sensor import transducer as trans_j
from tpu_rt.us.pipeline import us_render as jax_us_render
from tpu_rt_torch.bsdf import acoustic as acoustic_t
from tpu_rt_torch.integrator import ultrasound as wave_t
from tpu_rt_torch.ops import us_kernel
from tpu_rt_torch.sensor import transducer as trans_t
from tpu_rt_torch.us import beamform as beam_t
from tpu_rt_torch.us import pipeline
from torch_port_scenes import usmain_desc, usmain_mesh_desc, usmain_scatterers_desc

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(x_bounds=(-0.004, 0.004), z_bounds=(0.046, 0.054))


def _pair(desc_fn, **kw):
    return (tpu_rt.load_dict(desc_fn(tpu_rt.ScalarTransform4f, **kw)),
            tpu_rt_torch.load_dict(desc_fn(tpu_rt_torch.ScalarTransform4f, **kw)))


def tpu_rt_draws(seed, us, rays_per_pair, jitter=False):
    """What tpu_rt's ``simulate_acquisition`` draws for ``seed``, in the
    layout of the port's ``uniforms=``: per bounce (split(key, max_depth))
    the receive element (fold_in 0), the lobe sample (1), the microfacet
    pair (2) and the roulette sample (3); the jitter from fold_in(key, 999)."""
    n = us.n_angles * us.n_elements * rays_per_pair
    key = jax.random.PRNGKey(seed)
    recv, u = [], []
    for k in jax.random.split(key, us.max_depth):
        recv.append(np.asarray(jax.random.randint(jax.random.fold_in(k, 0), (n,), 0,
                                                  us.n_elements)))
        u.append(np.concatenate([
            np.asarray(jax.random.uniform(jax.random.fold_in(k, 1), (n,)))[:, None],
            np.asarray(jax.random.uniform(jax.random.fold_in(k, 2), (n, 2))),
            np.asarray(jax.random.uniform(jax.random.fold_in(k, 3), (n,)))[:, None]], 1))
    out = {"recv": torch.from_numpy(np.stack(recv)), "u": torch.from_numpy(np.stack(u))}
    if jitter:
        out["jitter"] = torch.from_numpy(
            np.array(jax.random.uniform(jax.random.fold_in(key, 999), (n, 2))))
    return out


def test_acoustic_sample_matches_tpu_rt():
    """Entering and leaving, total internal reflection (leaving a 7.8
    medium into 1.2), alpha at both clips (0 -> 1e-3, 2 -> 1) and an
    exterior impedance of 0 (-> 1.2)."""
    rng = np.random.default_rng(21)
    n = 4096
    params = np.zeros((n, 16), np.float32)
    params[:, 0] = rng.choice([1.2, 1.8, 7.8], n)
    params[:, 1] = rng.choice([0.0, 0.05, 0.5, 2.0], n)
    params[:, 2] = rng.choice([0.0, 1.5], n)
    wi = rng.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    s1 = rng.uniform(size=n).astype(np.float32)
    s2 = rng.uniform(size=(n, 2)).astype(np.float32)
    active = rng.uniform(size=n) < 0.9
    want = acoustic_j.sample(jnp.asarray(params), jnp.asarray(wi), jnp.asarray(s1),
                             jnp.asarray(s2), jnp.asarray(active))
    got = acoustic_t.sample(torch.from_numpy(params), torch.from_numpy(wi),
                            torch.from_numpy(s1), torch.from_numpy(s2),
                            torch.from_numpy(active))
    np.testing.assert_array_equal(got.reflected.numpy(), np.asarray(want.reflected))
    np.testing.assert_array_equal(got.valid.numpy(), active)
    np.testing.assert_allclose(got.wo.numpy(), np.asarray(want.wo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.amplitude.numpy(), np.asarray(want.amplitude), rtol=1e-5)
    leaving_tir = (wi[:, 2] < 0) & (params[:, 0] == np.float32(7.8))
    transmitted = ~got.reflected.numpy()
    assert transmitted[wi[:, 2] > 0].mean() > 0.2 and transmitted[leaving_tir].mean() < 0.2
    assert (got.amplitude.numpy()[~active] == 0).all()


@pytest.mark.parametrize("layout", ["linear", "convex"])
def test_plane_wave_rays_with_jitter_match_tpu_rt(layout):
    sj, st = _pair(usmain_desc, radius={"linear": float("inf"), "convex": 0.02}[layout])
    us = st.ultrasound
    jit = np.random.default_rng(3).uniform(size=(us.n_angles * us.n_elements, 2))
    jit = jit.astype(np.float32)
    want = trans_j.plane_wave_rays(sj.ultrasound, jitter=jnp.asarray(jit))
    got = trans_t.plane_wave_rays(us, jitter=torch.from_numpy(jit))
    for k in ("o", "d", "tx_delay", "angle_idx", "elem_idx", "trans_normal"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
    centred = trans_t.plane_wave_rays(us)["o"]
    assert (got["o"] - centred).abs().max().item() > 1e-4  # the jitter moved the origins


def test_transducer_samplers_match_tpu_rt_fed_the_same_uniforms():
    """``emitter_sample_ray`` and ``sensor_sample_ray`` fed the uniforms
    that tpu_rt's draw from their key (split(key, 3)); then the port's own
    draws from a generator: unit directions, weights in range, the
    hemisphere's mean cosine."""
    sj, st = _pair(usmain_desc, radius=0.02, opening_angle=30.0)
    n, key = 2048, jax.random.PRNGKey(8)
    k1, k2, k3 = jax.random.split(key, 3)
    uj = (np.asarray(jax.random.randint(k1, (n,), 0, st.ultrasound.n_elements)),
          np.asarray(jax.random.uniform(k2, (n, 2))), np.asarray(jax.random.uniform(k3, (n,))))
    want = trans_j.emitter_sample_ray(sj.ultrasound, key, n)
    got = trans_t.emitter_sample_ray(st.ultrasound, n,
                                     uniforms=tuple(torch.from_numpy(np.array(x)) for x in uj))
    for w, g, name in zip(want, got, ("o", "d", "delay", "weight")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=name)

    us_ = (np.asarray(jax.random.uniform(k1, (n,))), np.asarray(jax.random.uniform(k2, (n, 2))),
           np.asarray(jax.random.uniform(k3, (n, 2))))
    want = trans_j.sensor_sample_ray(sj.ultrasound, key, n, time=1e-7)
    got = trans_t.sensor_sample_ray(st.ultrasound, n, time=1e-7,
                                    uniforms=tuple(torch.from_numpy(np.array(x)) for x in us_))
    for w, g, name in zip(want, got, ("o", "d", "weight")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=name)

    gen = torch.Generator()
    gen.manual_seed(1)
    o, d, delay, weight = trans_t.emitter_sample_ray(st.ultrasound, 20000, gen=gen)
    assert bool(torch.isfinite(o).all()) and bool((weight >= 0).all())
    assert (weight > 0).float().mean().item() > 0.9
    assert torch.allclose(d.norm(dim=-1), torch.ones(20000), atol=1e-5)
    o, d, weight = trans_t.sensor_sample_ray(st.ultrasound, 20000, gen=gen)
    assert bool((d[:, 2] > 0).all()) and float(weight.max()) <= 1.0
    assert abs(float(d[:, 2].mean()) - 0.5) < 0.02  # uniform hemisphere: E[cos] = 1/2


ACQ = {"linear": dict(), "convex": dict(radius=0.02)}
ACQ_CASES = {"linear": ("linear", False, True), "convex": ("convex", False, True),
             "jittered": ("linear", True, True), "impulse": ("linear", False, False)}


@pytest.mark.parametrize("case", sorted(ACQ_CASES))
def test_acquisition_matches_tpu_rt_fed_its_draws(case):
    """USMain at 2 rays a pair, 10 bounces; linear and convex arrays, the
    jittered apertures and the impulse deposit (``deposit_sin=False``)."""
    layout, jitter, deposit_sin = ACQ_CASES[case]
    sj, st = _pair(usmain_desc, **ACQ[layout])
    seed, rpp = 4, 2
    ch_j, tx_j = wave_j.simulate_acquisition(sj, seed=seed, rays_per_pair=rpp,
                                             jitter_elements=jitter, deposit_sin=deposit_sin)
    ch_t, tx_t = wave_t.simulate_acquisition(
        st, seed=seed, rays_per_pair=rpp, jitter_elements=jitter, deposit_sin=deposit_sin,
        device="cpu", uniforms=tpu_rt_draws(seed, st.ultrasound, rpp, jitter))
    ch_j = np.asarray(ch_j, np.float64)
    ch_t = ch_t.numpy().astype(np.float64)
    assert ch_t.shape == (5, 64, 10000) and tx_t.shape == (5, 64)
    np.testing.assert_allclose(tx_t.numpy(), np.asarray(tx_j), rtol=0, atol=1e-12)
    total = np.abs(ch_j).sum()
    assert total > 0 and abs(np.abs(ch_t).sum() - total) <= 1e-3 * total
    big = np.abs(ch_j).max()
    np.testing.assert_allclose(ch_t, ch_j, rtol=0, atol=1e-3 * big)
    nz = (ch_j != 0) | (ch_t != 0)
    assert np.isclose(ch_t[nz], ch_j[nz], rtol=0, atol=1e-4 * big).mean() >= 0.6
    rays = wave_t.simulate_acquisition.last_ray_count
    assert rays.dtype == torch.int64 and rays.dim() == 0
    assert int(rays) >= 5 * 64 * rpp  # every lane's first ray, plus its shadow rays


def test_us_render_wavefront_matches_tpu_rt(monkeypatch):
    """``us_render(use_kernel=False)`` against tpu_rt's default route,
    ``us_render(use_pallas=False)``, on the small grid, the port's
    acquisition fed the draws of tpu_rt's seed."""
    sj, st = _pair(usmain_desc)
    seed, rpp = 1, 2
    img_j, ch_j, tx_j = jax_us_render(sj, seed=seed, rays_per_pair=rpp, use_pallas=False, **SMALL)
    fed = functools.partial(wave_t.simulate_acquisition,
                            uniforms=tpu_rt_draws(seed, st.ultrasound, rpp))
    monkeypatch.setattr(pipeline.wavefront, "simulate_acquisition", fed)
    img_t, ch_t, tx_t = pipeline.us_render(st, seed=seed, rays_per_pair=rpp, device="cpu",
                                           use_kernel=False, **SMALL)
    img_j, img_t = np.asarray(img_j), img_t.numpy()
    assert img_t.shape == img_j.shape == (105, 105) and img_t.dtype == np.float32
    assert img_j.std() > 0.05  # the grid holds the plate's echo
    total = np.abs(np.asarray(ch_j, np.float64)).sum()
    assert abs(np.abs(ch_t.numpy().astype(np.float64)).sum() - total) <= 1e-3 * total
    diff = np.abs(img_t - img_j)
    assert (diff <= 1e-3).mean() >= 0.97, (diff <= 1e-3).mean()
    assert abs(img_t.mean() - img_j.mean()) <= 1e-4 and diff.max() <= 0.05


def _plate_scene(z0, max_depth=1, attenuation=0.0, roughness=0.3, n_elements=32):
    """tests/test_ultrasound.py::_scene with its flat plate at depth z0."""
    st = tpu_rt_torch.ScalarTransform4f
    return tpu_rt_torch.load_dict({
        "type": "scene",
        "integrator": {"type": "ultrasound_integrator", "max_depth": max_depth,
                       "sampling_rate": 50e6, "frequency": 5e6, "sound_speed": 1540.0,
                       "attenuation": attenuation, "main_beam_angle": 24,
                       "cutoff_angle": 30, "n_elements": n_elements, "pitch": 0.0003,
                       "time_samples": 3000, "angles": np.asarray([0.0], np.float32)},
        "sensor": {"type": "ultrasound_sensor", "num_elements_lateral": n_elements,
                   "elements_width": 0.003, "elements_height": 0.01, "pitch": 0.0003,
                   "radius": float("inf"), "center_frequency": 5e6, "sound_speed": 1540.0,
                   "directivity": 1.0, "to_world": st()},
        "plate": {"type": "rectangle",
                  "to_world": st().translate([0, 0, z0]) @ st().rotate([0, 1, 0], 180)
                  @ st().scale([0.05, 0.05, 1]),
                  "bsdf": {"type": "ultrasound_bsdf", "impedance": 7.8,
                           "roughness": roughness}},
    })


def test_simulate_acquisition_jit_is_simulate_acquisition():
    """tpu_rt's jitted entry point, kept by name: the same RF, delays and
    ray count as ``simulate_acquisition`` for the same seed."""
    sc = _plate_scene(0.01, max_depth=2)
    ch, tx = wave_t.simulate_acquisition(sc, seed=3, rays_per_pair=2, device="cpu")
    rays = int(wave_t.simulate_acquisition.last_ray_count)
    ch_j, tx_j = wave_t.simulate_acquisition_jit(sc, seed=3, rays_per_pair=2, device="cpu")
    assert ch.abs().sum().item() > 0 and torch.equal(ch_j, ch) and torch.equal(tx_j, tx)
    assert int(wave_t.simulate_acquisition.last_ray_count) == rays > 0


def test_echo_arrival_time_flat_plate():
    """tests/test_ultrasound.py:65 on the port's route: the first echo at
    2 z0 / c, the last within the aperture's spread."""
    z0 = 0.02
    ch, _ = wave_t.simulate_acquisition(_plate_scene(z0), seed=0, device="cpu")
    ch = ch.numpy()
    assert np.abs(ch).sum() > 0, "no echoes recorded"
    fs, c = 50e6, 1540.0
    t_idx = np.nonzero(np.abs(ch).sum(axis=(0, 1)))[0]
    half_ap = 0.0003 * 16
    assert t_idx.min() >= 2 * z0 / c * fs - 2
    assert t_idx.max() <= (z0 + np.sqrt(z0 ** 2 + (2 * half_ap) ** 2)) / c * fs + 2


def test_attenuation_law():
    """tests/test_ultrasound.py:94 on the port's route: the echo scales by
    exp(-alpha f_MHz d / 8.686), d the one-way distance, within 5%."""
    z0 = 0.02
    e = [np.abs(wave_t.simulate_acquisition(_plate_scene(z0, attenuation=a, roughness=0.001),
                                            seed=3, device="cpu")[0].numpy()).sum()
         for a in (0.0, 0.5)]
    assert e[0] > 0
    np.testing.assert_allclose(e[1] / e[0], np.exp(-0.5 * 5.0 * z0 / 8.686), rtol=0.05)


def test_impulse_deposit_and_pulse():
    """tests/test_pulse_and_film.py:105 on the port's route:
    ``deposit_sin=False`` then ``apply_pulse`` gives an echo of about
    ``wave_cycles`` oscillations at 2 z0 / c."""
    z0 = 0.015
    st = tpu_rt_torch.ScalarTransform4f
    scene = tpu_rt_torch.load_dict({
        "type": "scene",
        "integrator": {"type": "ultrasound_integrator", "max_depth": 1, "n_elements": 8,
                       "time_samples": 1600, "pitch": 0.0004, "frequency": 5e6,
                       "sampling_rate": 50e6, "attenuation": 0.0, "wave_cycles": 4,
                       "angles": np.asarray([0.0], np.float32)},
        "sensor": {"type": "ultrasound_sensor", "num_elements_lateral": 8, "pitch": 0.0004,
                   "radius": float("inf"), "to_world": st()},
        "plate": {"type": "rectangle",
                  "to_world": st().translate([0, 0, z0]) @ st().rotate([0, 1, 0], 180)
                  @ st().scale([0.02, 0.02, 1]),
                  "bsdf": {"type": "ultrasound_bsdf", "impedance": 7.8, "roughness": 0.01}},
    })
    ch, _ = wave_t.simulate_acquisition(scene, seed=0, deposit_sin=False, device="cpu")
    us = scene.ultrasound
    rf = beam_t.apply_pulse(ch, float(us.sampling_rate), float(us.frequency),
                            us.wave_cycles).numpy()
    sig = rf[0].sum(axis=0)
    assert np.abs(sig).sum() > 0
    peak = int(np.argmax(np.abs(sig)))
    assert abs(peak - 2 * z0 / 1540.0 * 50e6) < 30
    win = sig[peak - 30: peak + 30]
    assert np.sum(np.abs(np.diff(np.sign(win[np.abs(win) > 1e-9]))) > 0) >= 4


def _empty_desc(st):
    desc = usmain_desc(st)
    del desc["flat_plate"], desc["wall_back"]
    return desc


# the scenes outside the acquisition kernel's scope (C5): no prims; 63
# spheres (65 prims, past its 64); the speckle phantoms of 1 000 spheres
# (the chunked sweep) and 10 000 (the BVH); the 2 240-triangle knot under
# an ultrasound_bsdf (K7's plain version), each on a grid over its echoes
C5 = {
    "empty": (_empty_desc, {}, SMALL, 0),
    "spheres_65": (usmain_scatterers_desc, dict(n=63), SMALL, 65),
    "phantom_1000": (usmain_scatterers_desc, dict(n=1000, r_min=1e-4, r_max=3e-4),
                     dict(x_bounds=(-0.01, 0.01), z_bounds=(0.008, 0.02)), 1002),
    "phantom_10000": (usmain_scatterers_desc, dict(n=10000, r_min=1e-4, r_max=3e-4),
                      dict(x_bounds=(-0.01, 0.01), z_bounds=(0.008, 0.016)), 10002),
    "knot": (usmain_mesh_desc, dict(ply="knot.ply"),
             dict(x_bounds=(-0.01, 0.01), z_bounds=(0.018, 0.03)), 2241),
}


@pytest.mark.parametrize("name", sorted(C5))
def test_scenes_outside_the_kernel_render_through_the_wavefront(monkeypatch, name):
    desc_fn, kw, grid, prims = C5[name]
    st = tpu_rt_torch.load_dict(desc_fn(tpu_rt_torch.ScalarTransform4f, **kw))
    assert st.geometry.n_tris + st.geometry.n_analytic == prims
    assert us_kernel.bake_us_scene(st) is None
    calls = []
    real = pipeline.wavefront.simulate_acquisition

    def spy(*a, **k):
        calls.append(k)
        return real(*a, **k)

    monkeypatch.setattr(pipeline.wavefront, "simulate_acquisition", spy)
    img, ch, tx = pipeline.us_render(st, seed=3, rays_per_pair=1, device="cpu", **grid)
    assert len(calls) == 1 and tx.shape == (5, 64) and ch.shape == (5, 64, 10000)
    # in [0, 1] to the rounding of log_compress's (dB - min) / range
    assert bool(torch.isfinite(img).all()) and 0.0 <= img.min().item()
    assert img.max().item() <= 1.0 + 1e-6
    if prims:
        assert ch.abs().sum().item() > 0 and img.std().item() > 0.01
    else:
        assert not bool(ch.any())
    again = tpu_rt_torch.render(st, seed=3, device="cpu", rays_per_pair=1, **grid)
    torch.testing.assert_close(again, img, rtol=0, atol=0)
    assert len(calls) == 2


@pytest.mark.parametrize("use_kernel", [True, False])
def test_scene_in_the_kernel_scope_takes_the_kernel(monkeypatch, use_kernel):
    """USMain is in K10's scope: ``use_kernel=True`` (the default) runs the
    kernel's plain version on the CPU, ``use_kernel=False`` the wavefront."""
    _, st = _pair(usmain_desc)
    seen = []
    for mod, name in ((us_kernel, "us_trace_rf_plain"), (pipeline.wavefront,
                                                         "simulate_acquisition")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: (seen.append(_n),
                                                                           _r(*a, **k))[1])
    img = tpu_rt_torch.render(st, seed=2, device="cpu", rays_per_pair=1, use_kernel=use_kernel,
                              **SMALL)
    assert seen == (["us_trace_rf_plain"] if use_kernel else ["simulate_acquisition"])
    assert bool(torch.isfinite(img).all()) and img.std().item() > 0.05


def test_scatterer_phantom_path_never_imports_jax():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'tests')!r})\n"
        "import tpu_rt_torch as tt\n"
        "from torch_port_scenes import usmain_scatterers_desc\n"
        "sc = tt.load_dict(usmain_scatterers_desc(tt.ScalarTransform4f, n=300))\n"
        "img = tt.render(sc, device='cpu', x_bounds=(-0.004, 0.004), z_bounds=(0.01, 0.02))\n"
        "assert img.dim() == 2 and bool(img.isfinite().all())\n"
        "from tpu_rt_torch.opt import checkpoint, inverse\n"
        "from tpu_rt_torch import compat\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'tpu_rt')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
