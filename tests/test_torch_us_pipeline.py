"""tpu_rt_torch's ultrasound pipeline against tpu_rt's, on the CPU: the
loader's ultrasound configuration, the transducer, DAS beamforming (gather
and matmul forms), envelope, log compression, the B-mode pipeline, the
ultraspy facades and the end-to-end ``us_render``.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, and why: rays and element positions to 1e-6 (float32 sin/cos
of the two libraries).  DAS, envelope and B-mode to rtol 1e-5 with an atol
of 1e-4 of the largest magnitude: XLA on the CPU fuses the delay's
multiply-adds, torch rounds each operation, so a time index differs by an
ulp (3e-5 samples near sample 256), which moves a linearly interpolated
white-noise RF sample by up to about 1e-4 of its scale; sums are also
taken in another order.  ``us_render`` runs tpu_rt's kernel
route in interpret mode; the images are log-compressed, where the noise
floor amplifies ulp differences of the RF, so at least 99% of pixels
agree within 1e-3 and the mean within 1e-4.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_rt
import tpu_rt_torch
from test_torch_scene import tpu_rt_arrays
from tpu_rt.ops import pallas_us
from tpu_rt.sensor import transducer as jt
from tpu_rt.us import api as japi
from tpu_rt.us import beamform as jb
from tpu_rt.us.pipeline import us_render as jax_us_render
from tpu_rt_torch.ops import us_kernel
from tpu_rt_torch.scene import scene_from_arrays
from tpu_rt_torch.scene import types as TT
from tpu_rt_torch.sensor import transducer as tt_
from tpu_rt_torch.us import api as tapi
from tpu_rt_torch.us import beamform as tb
from tpu_rt_torch.us.pipeline import us_render
from torch_port_scenes import usmain_desc

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RADII = {"linear": float("inf"), "convex": 0.02}
# the plate of the USMain scene crosses x = 0 at z = 50 mm; a small grid
# around it (the grid size of tests/test_pallas_us.py:131, moved to the echo)
SMALL = dict(x_bounds=(-0.004, 0.004), z_bounds=(0.046, 0.054))


def _scenes(layout="linear"):
    desc_j = usmain_desc(tpu_rt.ScalarTransform4f, radius=RADII[layout])
    desc_t = usmain_desc(tpu_rt_torch.ScalarTransform4f, radius=RADII[layout])
    return tpu_rt.load_dict(desc_j), tpu_rt_torch.load_dict(desc_t)


def _close(got, want, rtol=1e-5, atol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * np.abs(want).max())


@pytest.mark.parametrize("layout", ["linear", "convex"])
def test_load_dict_ultrasound_config_matches_tpu_rt(layout):
    sj, st = _scenes(layout)
    assert st.integrator == TT.INTEGRATOR_ULTRASOUND == sj.integrator
    assert st.max_depth == sj.max_depth and st.camera is None
    uj, ut = sj.ultrasound, st.ultrasound
    for f in dataclasses.fields(TT.UltrasoundConfig):
        a, b = getattr(ut, f.name), getattr(uj, f.name)
        if f.type == "torch.Tensor":
            assert a.dtype == torch.float32, f.name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f.name)
        else:
            assert a == b, f.name
    np.testing.assert_array_equal(st.bsdf_params.numpy(), np.asarray(sj.bsdf_params))
    np.testing.assert_array_equal(st.bsdf_type.numpy(), np.asarray(sj.bsdf_type))


@pytest.mark.parametrize("where", ["top_level", "in_shape"])
def test_transducer_emitter_props_match_tpu_rt(where):
    """An ``ultrasound_emitter`` block configures the acquisition (its
    opening angle and element size); inside a shape with an intensity it is
    also an area light, whose rectangle becomes two triangles."""
    def desc(st):
        d = usmain_desc(st, radius=0.02)
        em = {"type": "ultrasound_emitter", "opening_angle": 30.0,
              "element_width": 0.002, "number_of_rays_per_element": 3}
        if where == "in_shape":
            em["intensity"] = 2.0
            d["wall_back"]["emitter"] = em
        else:
            d["probe"] = em
        return d

    sj = tpu_rt.load_dict(desc(tpu_rt.ScalarTransform4f))
    st = tpu_rt_torch.load_dict(desc(tpu_rt_torch.ScalarTransform4f))
    assert st.ultrasound.opening_angle == 30.0 == sj.ultrasound.opening_angle
    assert st.ultrasound.number_of_rays_per_element == 3
    assert float(st.ultrasound.elements_width) == np.float32(0.003)  # the sensor's wins
    arrays_j, meta_j = tpu_rt_arrays(sj)
    arrays_t, meta_t = tpu_rt_arrays(st)
    assert meta_t == meta_j
    for k, v in arrays_j.items():
        np.testing.assert_array_equal(arrays_t[k], v, err_msg=k)
    assert (st.geometry.n_tris, st.emitters.n_area) == ((2, 1) if where == "in_shape" else (0, 0))
    bj, bt = pallas_us.bake_us_scene(sj), us_kernel.bake_us_scene(st)
    assert [(p.kind, p.data, p.bsdf, p.emitter) for p in bt.prims] == \
        [(p.kind, p.data, p.bsdf, p.emitter) for p in bj.prims]


def test_scene_from_arrays_carries_ultrasound_state():
    sj, st = _scenes("convex")
    carried = scene_from_arrays(*tpu_rt_arrays(sj))
    for f in dataclasses.fields(TT.UltrasoundConfig):
        a, b = getattr(carried.ultrasound, f.name), getattr(st.ultrasound, f.name)
        if f.type == "torch.Tensor":
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f.name)
        else:
            assert a == b, f.name
    assert us_kernel.bake_us_scene(carried) == us_kernel.bake_us_scene(st)


@pytest.mark.parametrize("layout", ["linear", "convex"])
def test_plane_wave_rays_match_tpu_rt(layout):
    sj, st = _scenes(layout)
    want, got = jt.plane_wave_rays(sj.ultrasound), tt_.plane_wave_rays(st.ultrasound)
    for k in ("o", "d", "tx_delay", "angle_idx", "elem_idx", "trans_normal",
              "x_elem", "elem_pos"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("radius,opening", [(float("inf"), 0.0), (0.0, 0.0),
                                            (0.03, 0.0), (0.03, 40.0)])
def test_element_geometry_matches_tpu_rt(radius, opening):
    pj, nj = jt.element_geometry(48, np.float32(3e-4), radius, opening)
    pt, nt = tt_.element_geometry(48, np.float32(3e-4), radius, opening)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0, atol=1e-6)


def _rf_case():
    """A seeded RF [2, 8, 256] and a 9 x 7 grid whose delays land inside
    the trace (fs 50 MHz, c 1540 m/s, pitch 0.3 mm)."""
    rng = np.random.default_rng(7)
    rf = rng.standard_normal((2, 8, 256)).astype(np.float32)
    angles = np.array([-10.0, 10.0], np.float32)
    ex = ((np.arange(8) - 3.5) * 3e-4).astype(np.float32)
    ez = (1e-4 * rng.random(8)).astype(np.float32)
    xg = np.linspace(-1e-3, 1e-3, 9).astype(np.float32)
    zg = np.linspace(5e-4, 3e-3, 7).astype(np.float32)
    return rf, angles, ex, ez, 50e6, 1540.0, xg, zg


@pytest.mark.parametrize("method", ["gather", "matmul"])
@pytest.mark.parametrize("convex", [False, True])
def test_das_matches_tpu_rt(method, convex):
    rf, angles, ex, ez, fs, c, xg, zg = _rf_case()
    ez = ez if convex else None
    jf = jb.das_beamform if method == "gather" else jb.das_beamform_matmul
    tf = tb.das_beamform if method == "gather" else tb.das_beamform_matmul
    want = jf(jnp.asarray(rf), jnp.asarray(angles), jnp.asarray(ex), fs, c,
              jnp.asarray(xg), jnp.asarray(zg),
              elem_z=None if ez is None else jnp.asarray(ez))
    got = tf(torch.from_numpy(rf), angles, ex, fs, c, torch.from_numpy(xg),
             torch.from_numpy(zg), elem_z=ez)
    assert got.dtype == torch.float32 and got.shape == (9, 7)
    _close(got, want)
    assert np.abs(np.asarray(want)).max() > 0


def test_envelope_log_compress_bmode_match_tpu_rt():
    img = np.random.default_rng(11).standard_normal((9, 8)).astype(np.float32)
    for axis in (0, 1):
        _close(tb.hilbert_envelope(torch.from_numpy(img), axis=axis),
               jb.hilbert_envelope(jnp.asarray(img), axis=axis))
    env = np.abs(img) + 1e-3
    _close(tb.log_compress(torch.from_numpy(env), 40.0), jb.log_compress(jnp.asarray(env), 40.0))
    rf, angles, ex, ez, fs, c, xg, zg = _rf_case()
    for method in ("matmul", "gather"):
        want = jb.bmode_pipeline(jnp.asarray(rf), jnp.asarray(angles), jnp.asarray(ex), fs, c,
                                 jnp.asarray(xg), jnp.asarray(zg), method=method,
                                 elem_z=jnp.asarray(ez))
        got = tb.bmode_pipeline(torch.from_numpy(rf), angles, ex, fs, c, torch.from_numpy(xg),
                                torch.from_numpy(zg), method=method, elem_z=ez)
        assert got.shape == (7, 9)
        _close(got, want)


def test_pulse_matches_tpu_rt():
    rf = np.random.default_rng(5).standard_normal((2, 3, 200)).astype(np.float32)
    _close(tb.pulse_kernel(50e6, 5e6), jb.pulse_kernel(50e6, 5e6))
    _close(tb.apply_pulse(torch.from_numpy(rf), 50e6, 5e6), jb.apply_pulse(jnp.asarray(rf), 50e6, 5e6))


def test_ultraspy_facades_match_tpu_rt():
    rf, angles, _, _, fs, c, xg, zg = _rf_case()
    for kind, radius in (("linear", float("inf")), ("convex", 0.03)):
        pj = japi.build_probe(kind, 8, 3e-4, 5e6, radius=radius)
        pt = tapi.build_probe(kind, 8, 3e-4, 5e6, radius=radius)
        np.testing.assert_allclose(pt.elements_x, pj.elements_x, rtol=0, atol=1e-9)
        np.testing.assert_allclose(pt.elements_z, pj.elements_z, rtol=0, atol=1e-9)
    delays = (np.sin(np.deg2rad(angles))[:, None] * pj.elements_x[None, :] / c)
    info = {"sampling_freq": fs, "sound_speed": c, "delays": delays}
    dj = japi.DelayAndSum().automatic_setup(info, pj)
    dt = tapi.DelayAndSum().automatic_setup(info, pt)
    np.testing.assert_allclose(dt.angles_deg, dj.angles_deg, rtol=1e-6)
    sj_, st_ = japi.GridScan(xg, zg), tapi.GridScan(xg, zg)
    assert st_.shape == sj_.shape == (9, 7)
    bj, bt = dj.beamform(rf, sj_), dt.beamform(rf, st_)
    _close(bt, bj)
    _close(dt.compute_envelope(bt, st_), dj.compute_envelope(bj, sj_))


def test_us_render_matches_tpu_rt():
    """USMain at rpp 2 on the small grid: tpu_rt's kernel route (interpret
    mode) against the port's plain route."""
    sj, st = _scenes()
    img_j, ch_j, tx_j = jax_us_render(sj, seed=1, rays_per_pair=2, use_pallas=True,
                                      _forward_only=True, **SMALL)
    img_t, ch_t, tx_t = us_render(st, seed=1, rays_per_pair=2, device="cpu", **SMALL)
    img_j, ch_j = np.asarray(img_j), np.asarray(ch_j, np.float64)
    assert img_t.shape == img_j.shape and img_t.dtype == torch.float32
    np.testing.assert_array_equal(tx_t.numpy(), np.asarray(tx_j))
    ch_t = ch_t.numpy().astype(np.float64)
    assert abs(np.abs(ch_t).sum() - np.abs(ch_j).sum()) <= 1e-3 * np.abs(ch_j).sum()
    img_t = img_t.numpy()
    assert np.isfinite(img_t).all() and 0.0 <= img_t.min() and img_t.max() <= 1.0
    assert img_j.std() > 0.05  # the grid holds the plate's echo
    close = np.abs(img_t - img_j) <= 1e-3
    assert close.mean() >= 0.99, close.mean()
    assert abs(img_t.mean() - img_j.mean()) <= 1e-4


def test_render_dispatches_ultrasound_scenes():
    _, st = _scenes()
    img = tpu_rt_torch.render(st, seed=2, device="cpu", rays_per_pair=1, **SMALL)
    want = us_render(st, seed=2, rays_per_pair=1, device="cpu", **SMALL)[0]
    np.testing.assert_array_equal(img.numpy(), want.numpy())
    with pytest.raises(TypeError):
        tpu_rt_torch.render(tpu_rt_torch.load_file(
            os.path.join(ROOT, "tests", "assets", "cbox", "cbox.xml"), res=8, spp=1),
            device="cpu", rays_per_pair=1)


def test_us_path_never_imports_jax():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'tests')!r})\n"
        "import tpu_rt_torch as tt\n"
        "from torch_port_scenes import usmain_desc\n"
        "sc = tt.load_dict(usmain_desc(tt.ScalarTransform4f))\n"
        "img = tt.render(sc, device='cpu', x_bounds=(-0.002, 0.002), z_bounds=(0.048, 0.052))\n"
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
