"""The ultrasound acquisition kernel's plain PyTorch version against
tpu_rt's Pallas kernel K10 (``tpu_rt/ops/pallas_us.py``), on the CPU.

tpu_rt runs its kernel in interpret mode with tile_rows=8, as its own
tests and ``us_render`` do; the port's plain version draws the same
SplitMix32 streams, so both trace the same acquisition at the USMain
configuration (tests/torch_port_scenes.py::usmain_desc).

Tolerances, and why: XLA on the CPU contracts multiply-adds into FMAs and
divides by constants through a reciprocal, while torch rounds every
operation, so values differ by a few ulps.  The echo phase is
2 pi 5 MHz t, 10^3 - 10^4 rad, where one ulp of the time moves sin(phase)
by up to about 5e-4; so pressures are compared against 1e-4 of the
largest |pressure| (at least 99% of entries), time-sample indices to 1e-6
relative and receive elements exactly, both only where the pressure is
non-zero (a dead lane's records are don't-cares).  Deposited RF buffers:
total |RF| within 1e-3 relative, per-pair energy correlation >= 0.999.
The Cone_Box-class records differ in the same way, by one to three ulps
of the echo time, but there most first echoes come off the cone with
amplitudes near the largest, so a phase error of 4e-4 rad (three ulps of
t ~ 8e-5 s at 3 MHz) moves them by up to 1.5e-4 of the largest |pressure|:
their pressures are held to 1e-3 of it.  A ray that grazes the cone takes
its hit from the smaller root of a badly conditioned quadratic, which
XLA's contracted multiply-adds move by up to ten ulps of the time-sample
index: the cone's indices are held to rtol 2e-6.

The CUDA kernel is held to the plain version on the card by
tests/test_torch_cuda.py, which imports no JAX.
"""

import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import tpu_rt
import tpu_rt_torch
from tpu_rt.ops import pallas_us
from tpu_rt.sensor.transducer import plane_wave_rays
from tpu_rt_torch.ops import us_kernel
from torch_port_scenes import cone_box_desc, usmain_desc

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "us_usmain_rpp64_seed0.npz")
CONE_GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "us_cone_rpp64_seed0.npz")
SEED, RPP = 0, 8


def _desc(st, arc):
    """USMain; with ``arc`` True a convex array (radius 2 cm) whose elements
    a transducer emitter spreads over a 40-degree opening angle; with
    ``arc`` "cone" the Cone_Box-class scene (a cone in the 5-wall box)."""
    if arc == "cone":
        return cone_box_desc(st)
    return usmain_desc(st, radius=0.02, opening_angle=40.0) if arc else usmain_desc(st)


@functools.lru_cache(maxsize=None)
def _scenes(max_depth=10, arc=False):
    sj = tpu_rt.load_dict(_desc(tpu_rt.ScalarTransform4f, arc))
    st = tpu_rt_torch.load_dict(_desc(tpu_rt_torch.ScalarTransform4f, arc))
    return (sj.replace(ultrasound=sj.ultrasound.replace(max_depth=max_depth)),
            st.replace(ultrasound=st.ultrasound.replace(max_depth=max_depth)))


@functools.lru_cache(maxsize=None)
def _pallas_records(max_depth, arc=False, seed=SEED, rpp=RPP, tile_rows=8):
    """tpu_rt's raw K10 records [3 * D, N] and the rays [7, N] it traced:
    the set-up of ``simulate_acquisition_pallas`` (its lanes, padding and
    grid spec) up to its ``pallas_call``, in interpret mode."""
    scene = _scenes(max_depth, arc)[0]
    bs = pallas_us.bake_us_scene(scene)
    base = plane_wave_rays(scene.ultrasound)
    n = scene.ultrasound.n_angles * scene.ultrasound.n_elements * rpp

    def rep(x):
        return jnp.repeat(x, rpp, axis=0)

    o, d, tx = rep(base["o"]), rep(base["d"]), rep(base["tx_delay"])
    lanes = 128
    pad = (-n) % (tile_rows * lanes)
    if pad:
        o = jnp.concatenate([o, jnp.zeros((pad, 3))], 0)
        d = jnp.concatenate([d, jnp.broadcast_to(jnp.asarray([[0.0, 0.0, 1.0]]), (pad, 3))], 0)
        tx = jnp.concatenate([tx, jnp.full((pad,), -1e9)], 0)
    rows = (n + pad) // lanes
    comps = [x.reshape(rows, lanes)
             for x in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], tx)]
    prm = jnp.asarray(scene.bsdf_params, jnp.float32)
    bsdf_tab = jnp.stack([prm[:, 0], jnp.clip(prm[:, 1], 1e-3, 1.0),
                          jnp.where(prm[:, 2] > 0.0, prm[:, 2], 1.2)], axis=-1)
    block = pl.BlockSpec((tile_rows, lanes), lambda i, *_s: (i, 0),
                         memory_space=pltpu.VMEM)
    D = bs.max_depth
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(rows // tile_rows,),
        in_specs=[block] * 7, out_specs=[block] * (3 * D))
    outs = pl.pallas_call(
        pallas_us._build_us_kernel(bs),
        out_shape=[jax.ShapeDtypeStruct((rows, lanes), jnp.float32)] * (3 * D),
        grid_spec=grid_spec, interpret=True,
    )(jnp.asarray([seed], jnp.int32), bsdf_tab, *comps)
    records = np.stack([np.asarray(x).reshape(-1)[:n] for x in outs])
    rays = np.stack([np.asarray(x).reshape(-1)[:n] for x in comps])
    return records, rays


def check_records(got, want, ptol=1e-4, trtol=1e-6):
    """The module docstring's record tolerances (``ptol``: the pressure
    budget, a share of the largest |pressure|; ``trtol``: the time-sample
    indices' relative budget)."""
    pw, pg = want[0::3], got[0::3]
    close = np.abs(pg - pw) <= ptol * np.abs(pw).max()
    assert close.mean() >= 0.99, f"only {close.mean():.5f} of pressures agree"
    nz = (pw != 0.0) & (pg != 0.0)
    assert nz.any()
    np.testing.assert_allclose(got[1::3][nz], want[1::3][nz], rtol=trtol)
    np.testing.assert_array_equal(got[2::3][nz], want[2::3][nz])


def test_bake_and_tables_match_tpu_rt():
    """bake_us_scene gives tpu_rt's baked constants for the USMain dict,
    and the packed table holds the float32 values tpu_rt's kernel uses."""
    sj, st = _scenes()
    bj, bt = pallas_us.bake_us_scene(sj), us_kernel.bake_us_scene(st)
    assert bt is not None
    for f in ("layout", "n_elements", "pitch", "radius", "opening_angle",
              "sensor_rows", "trans_n", "frequency", "sound_speed", "attenuation",
              "sampling_rate", "main_beam_angle", "cutoff_angle",
              "max_path_length", "max_depth", "num_rays"):
        assert getattr(bt, f) == getattr(bj, f), f
    assert [(p.kind, p.data, p.bsdf, p.emitter) for p in bt.prims] == \
        [(p.kind, p.data, p.bsdf, p.emitter) for p in bj.prims]
    prm = np.asarray(sj.bsdf_params, np.float32)
    want_bsdf = np.stack([prm[:, 0], np.clip(prm[:, 1], np.float32(1e-3), np.float32(1.0)),
                          np.where(prm[:, 2] > 0.0, prm[:, 2], np.float32(1.2))], -1)
    np.testing.assert_array_equal(np.asarray(bt.bsdfs, np.float32), want_bsdf)

    tab = us_kernel.pack_us_tables(bt, 8, "cpu")
    t, h = np.asarray(tab.tab_list, np.float32), tab.hdr_list
    assert tab.tab.dtype == torch.float32 and np.array_equal(tab.tab.numpy(), t)
    f32 = np.float32
    f_mhz = bj.frequency * 1e-6
    want = {
        us_kernel.UG_ATT: -bj.attenuation * f_mhz,
        us_kernel.UG_DB: 8.686,
        us_kernel.UG_INV_C: 1.0 / bj.sound_speed,
        us_kernel.UG_TWO_PI_F: 2.0 * math.pi * bj.frequency,
        us_kernel.UG_COS_CUT: math.cos(bj.cutoff_angle),
        us_kernel.UG_INV_RAMP: 1.0 / max(bj.cutoff_angle - bj.main_beam_angle, 1e-9),
        us_kernel.UG_MAIN: bj.main_beam_angle,
        us_kernel.UG_CUT: bj.cutoff_angle,
        us_kernel.UG_NUM_RAYS: bj.num_rays,
        us_kernel.UG_FS: bj.sampling_rate,
        us_kernel.UG_MAX_PATH: bj.max_path_length,
        us_kernel.UG_PITCH: bj.pitch,
        us_kernel.UG_C_LIN: (bj.n_elements - 1) * 0.5,
        us_kernel.UG_E: bj.n_elements,
        us_kernel.UG_E_M1: bj.n_elements - 1.0,
    }
    for k, v in want.items():
        assert t[k] == f32(v), k
    m0, m1, m2 = bj.sensor_rows
    np.testing.assert_array_equal(
        t[us_kernel.UG_ROWS:us_kernel.UG_ROWS + 9],
        np.asarray([r[k] for r in (m0, m1, m2) for k in (0, 2, 3)], f32))
    np.testing.assert_array_equal(t[us_kernel.UG_TN:us_kernel.UG_TN + 3],
                                  np.asarray(bj.trans_n, f32))
    assert h[us_kernel.UH_N_PRIMS] == 2 and h[us_kernel.UH_N_BSDFS] == 2
    assert h[us_kernel.UH_MAX_DEPTH] == 10 and h[us_kernel.UH_N_ELEM] == 64
    assert h[us_kernel.UH_LAYOUT] == us_kernel.LAYOUT_LINEAR
    assert h[us_kernel.UH_TILE_LANES] == 1024


def test_bake_cone_box_matches_tpu_rt():
    """bake_us_scene takes the Cone_Box-class scene (it gave None while the
    sweep lacked cones), with tpu_rt's prims, and packs the cone as the
    film kernel's cone record."""
    sj, st = _scenes(10, "cone")
    bj, bt = pallas_us.bake_us_scene(sj), us_kernel.bake_us_scene(st)
    assert bt is not None and [p.kind for p in bt.prims] == ["cone"] + ["rect"] * 5
    assert [(p.kind, p.data, p.bsdf, p.emitter) for p in bt.prims] == \
        [(p.kind, p.data, p.bsdf, p.emitter) for p in bj.prims]
    tab = us_kernel.pack_us_tables(bt, 8, "cpu")
    rec = tab.tab_list[tab.hdr_list[us_kernel.UH_OFF_PRIM]:][:20]
    assert rec[0] == 3.0  # path_kernel.KIND_CONE
    np.testing.assert_array_equal(np.asarray(rec[4:16], np.float32),
                                  np.asarray(bj.prims[0].data, np.float32).ravel())


def test_bake_scope():
    """Out of scope: an optical scene (no ultrasound configuration)."""
    cbox = os.path.join(os.path.dirname(__file__), "assets", "cbox", "cbox.xml")
    assert us_kernel.bake_us_scene(tpu_rt_torch.load_file(cbox, res=16, spp=1)) is None
    with pytest.raises(ValueError):
        us_kernel.simulate_acquisition(tpu_rt_torch.load_file(cbox, res=16, spp=1),
                                       device="cpu")


@pytest.mark.parametrize("max_depth,arc", [(10, False), (3, False), (3, True), (3, "cone")],
                         ids=["depth10", "depth3", "depth3-convex-arc", "cone-box-depth3"])
def test_plain_records_match_pallas_interpret(max_depth, arc):
    """Per-bounce records of 2 560 lanes (rpp 8) on the same rays; the cone
    case sweeps the cone through the shared prim sweep."""
    want, rays = _pallas_records(max_depth, arc)
    st = _scenes(max_depth, arc)[1]
    tables = us_kernel.pack_us_tables(us_kernel.bake_us_scene(st), 8, "cpu")
    assert tables.hdr_list[us_kernel.UH_LAYOUT] == (
        us_kernel.LAYOUT_CONVEX_OPEN if arc is True else us_kernel.LAYOUT_LINEAR)
    got = us_kernel.us_trace(tables, torch.from_numpy(rays), SEED)
    assert got.shape == want.shape == (3 * max_depth, 5 * 64 * RPP)
    assert got.dtype == torch.float32
    if arc == "cone":
        check_records(got.numpy(), want, ptol=1e-3, trtol=2e-6)
    else:
        check_records(got.numpy(), want)


def test_us_trace_cpu_runs_plain_version_without_launch():
    _, rays = _pallas_records(3)
    tables = us_kernel.pack_us_tables(us_kernel.bake_us_scene(_scenes(3)[1]), 8, "cpu")
    before = us_kernel.us_trace.launches
    out = us_kernel.us_trace(tables, torch.from_numpy(rays), 7)
    assert us_kernel.us_trace.launches == before
    np.testing.assert_array_equal(
        out.numpy(), us_kernel.us_trace_plain(tables, torch.from_numpy(rays), 7).numpy())


def test_deposited_channel_matches_pallas_interpret():
    sj, st = _scenes()
    ch_j, tx_j = pallas_us.simulate_acquisition_pallas(sj, seed=SEED, rays_per_pair=RPP,
                                                       interpret=True)
    ch_t, tx_t = us_kernel.simulate_acquisition(st, seed=SEED, rays_per_pair=RPP, device="cpu")
    ch_j, ch_t = np.asarray(ch_j, np.float64), ch_t.numpy().astype(np.float64)
    assert ch_t.shape == ch_j.shape == (5, 64, 10000)
    np.testing.assert_array_equal(tx_t.numpy(), np.asarray(tx_j))
    tot_j, tot_t = np.abs(ch_j).sum(), np.abs(ch_t).sum()
    assert tot_j > 0 and abs(tot_t - tot_j) <= 1e-3 * tot_j
    corr = np.corrcoef(np.abs(ch_j).sum(2).ravel(), np.abs(ch_t).sum(2).ravel())[0, 1]
    assert corr >= 0.999, corr


def test_acquisition_matches_golden():
    """The full USMain acquisition (rpp 64, 20 480 lanes, seed 0) against
    tests/golden/us_usmain_rpp64_seed0.npz, made by tpu_rt's us_render in
    interpret mode (tests/golden/make_us_golden.py): the limits the card's
    run is held to in chip_smoke.py."""
    g = np.load(GOLDEN)
    st = tpu_rt_torch.load_dict(usmain_desc(tpu_rt_torch.ScalarTransform4f))
    ch, _ = us_kernel.simulate_acquisition(st, seed=0, rays_per_pair=64, device="cpu")
    a = np.abs(ch.numpy().astype(np.float64))
    assert np.corrcoef(a.sum(axis=(0, 1)), g["axial"])[0, 1] >= 0.999
    assert abs(a.sum() - g["total_abs"]) <= 0.01 * g["total_abs"]
    assert np.corrcoef(a.sum(axis=2).ravel(), g["pair"].ravel())[0, 1] >= 0.999


def test_cone_acquisition_matches_golden():
    """The Cone_Box-class acquisition (rpp 64, 20 480 lanes, seed 0)
    against tests/golden/us_cone_rpp64_seed0.npz (tpu_rt's us_render in
    interpret mode, tests/golden/make_us_cone_golden.py), with the limits
    of the card's gate; the first echo lies where Cone_FLoating's does
    (0.05-0.066 m, tests/test_all_scenes_smoke.py:78-93)."""
    g = np.load(CONE_GOLDEN)
    st = tpu_rt_torch.load_dict(cone_box_desc(tpu_rt_torch.ScalarTransform4f))
    ch, _ = us_kernel.simulate_acquisition(st, seed=0, rays_per_pair=64, device="cpu")
    a = np.abs(ch.numpy().astype(np.float64))
    assert np.corrcoef(a.sum(axis=(0, 1)), g["axial"])[0, 1] >= 0.999
    assert abs(a.sum() - g["total_abs"]) <= 0.01 * g["total_abs"]
    us = st.ultrasound
    first = np.nonzero(a.sum(axis=(0, 1)))[0].min() / float(us.sampling_rate)
    assert 0.05 <= first * float(us.sound_speed) / 2 <= 0.066
