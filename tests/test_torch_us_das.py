"""The ultrasound frame's two kernels on the CPU: the delay-and-sum
beamformer (``us/beamform.py::das_beamform``, whose plain version
``das_beamform_plain`` a CPU tensor runs) against tpu_rt's
``das_beamform`` and ``das_beamform_matmul``; the acquisition kernel's
deposit mode (``ops/us_kernel.py::us_trace_rf``), whose plain version is
``deposit_rf`` of ``us_trace_plain``; ``us_render`` on the CPU taking both
plain versions; and the sweep's tie rule on two coincident prims, which
the grouped kernel keeps on the card (tests/test_torch_cuda.py).

Inputs are made with numpy from a seed.  Tolerances, and why: the DAS
against tpu_rt to rtol 1e-5 with an atol of 1e-4 of the largest
magnitude, as tests/test_torch_us_pipeline.py (XLA contracts the delay's
multiply-adds, so a time index differs by an ulp, and sums go in another
order).  tpu_rt's gather form masks each tap: a tap outside [0, T) adds 0.
Its matmul form drops a pixel's pair once the delay leaves [0, T - 1], so
the two differ where one of the two taps is inside; the matmul case
therefore zeroes each trace's first and last sample, where the two forms
define the same image, while its delays still fall off both ends.  The
deposit mode's plain version and the coincident-prim records are compared
bit for bit, as are the DAS kernel's packed taps (``das_pack_plain``) to
the plain version's masked taps, pair by pair.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_rt_torch
from tpu_rt.us import beamform as jb
from tpu_rt_torch.ops import us_kernel
from tpu_rt_torch.sensor.transducer import plane_wave_rays
from tpu_rt_torch.us import beamform as tb
from tpu_rt_torch.us import pipeline
from tpu_rt_torch.utils import memo
from torch_port_scenes import usmain_desc, usmain_scatterers_desc, usmain_twin_desc

torch.set_num_threads(1)

FS, C = 50e6, 1540.0
# the small grid around the USMain plate's echo (test_torch_us_pipeline.py)
SMALL = dict(x_bounds=(-0.004, 0.004), z_bounds=(0.046, 0.054))


def _close(got, want, rtol=1e-5, atol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * np.abs(want).max())


def _case(A, E, T, convex, seed):
    """A seeded RF [A, E, T], angles, element positions and a 13 x 11 grid
    (neither a multiple of any tile) whose nearest pixels' delays lie before
    the trace (with t_offset) and whose farthest lie beyond it."""
    rng = np.random.default_rng(seed)
    rf = rng.standard_normal((A, E, T)).astype(np.float32)
    angles = np.linspace(-12.0, 9.0, A).astype(np.float32) if A > 1 else \
        np.array([7.0], np.float32)
    ex = ((np.arange(E) - (E - 1) / 2) * 3e-4).astype(np.float32)
    ez = (2e-4 * rng.random(E)).astype(np.float32) if convex else None
    xg = np.linspace(-1.1e-3, 0.9e-3, 13).astype(np.float32)
    zg = np.linspace(5e-5, 4e-3, 11).astype(np.float32)
    return rf, angles, ex, ez, xg, zg


def _delays(angles, ex, ez, xg, zg, t_offset):
    """The delays in samples, [A, E, Nx, Nz], in float64."""
    a = np.deg2rad(angles.astype(np.float64))[:, None, None, None]
    ez = np.zeros_like(ex) if ez is None else ez
    x, z = np.meshgrid(xg.astype(np.float64), zg.astype(np.float64), indexing="ij")
    t_tx = (x * np.sin(a) + z * np.cos(a)) / C
    t_rx = np.sqrt((x - ex[None, :, None, None]) ** 2 + (z - ez[None, :, None, None]) ** 2) / C
    return (t_tx + t_rx - t_offset) * FS


CASES = {  # A, E, T, convex, t_offset, seed
    "linear": (3, 5, 200, False, 5e-7, 1),
    "convex": (3, 5, 200, True, 3e-7, 2),
    "one-pair": (1, 1, 200, False, 4e-7, 3),
    "linear-no-offset": (2, 7, 240, False, 0.0, 4),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("method", ["gather", "matmul"])
def test_plain_das_matches_tpu_rt(case, method):
    A, E, T, convex, t_offset, seed = CASES[case]
    rf, angles, ex, ez, xg, zg = _case(A, E, T, convex, seed)
    tf = _delays(angles, ex, ez, xg, zg, t_offset)
    assert (tf < -1.0).any() and (tf > T).any(), "the delays must leave the trace at both ends"
    if method == "matmul":
        rf[..., 0] = rf[..., -1] = 0.0  # where the two forms define the same image
    jf = jb.das_beamform if method == "gather" else jb.das_beamform_matmul
    want = jf(jnp.asarray(rf), jnp.asarray(angles), jnp.asarray(ex), FS, C, jnp.asarray(xg),
              jnp.asarray(zg), t_offset=t_offset, elem_z=None if ez is None else jnp.asarray(ez))
    before = tb.das_beamform.launches
    got = tb.das_beamform(torch.from_numpy(rf), angles, ex, FS, C, torch.from_numpy(xg),
                          torch.from_numpy(zg), t_offset=t_offset, elem_z=ez)
    assert tb.das_beamform.launches == before  # a CPU tensor runs the plain version
    assert got.dtype == torch.float32 and got.shape == (13, 11)
    np.testing.assert_array_equal(got.numpy(), tb.das_beamform_plain(
        torch.from_numpy(rf), angles, ex, FS, C, torch.from_numpy(xg), torch.from_numpy(zg),
        t_offset=t_offset, elem_z=ez).numpy())
    _close(got, want)
    assert np.abs(np.asarray(want)).max() > 0


def test_plain_das_single_pair_is_the_two_taps():
    """A = E = 1: every pixel is the two masked taps of its delay, as
    tests/test_torch_cuda.py holds the kernel to bit for bit."""
    rf, angles, ex, _, xg, zg = _case(1, 1, 200, False, 3)
    t_offset = 4e-7
    got = tb.das_beamform_plain(torch.from_numpy(rf), angles, ex, FS, C, torch.from_numpy(xg),
                                torch.from_numpy(zg), t_offset=t_offset).numpy()
    tf = _delays(angles, ex, None, xg, zg, t_offset)[0, 0]
    i0 = np.floor(tf).astype(np.int64)
    w = tf - i0
    trace = rf[0, 0].astype(np.float64)

    def tap(i):
        return np.where((i >= 0) & (i < 200), trace[np.clip(i, 0, 199)], 0.0)

    np.testing.assert_allclose(got, tap(i0) * (1 - w) + tap(i0 + 1) * w, rtol=0,
                               atol=1e-4 * np.abs(trace).max())


def test_das_pack_plain_is_the_padded_pairs():
    """The packing pass's plain version: [A, E, T + 3, 2], entry j the
    samples j - 2 and j - 1 of the trace, zeros before it and past it;
    ``das_pack`` on a CPU tensor runs it and launches nothing."""
    rf = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 3, 51))
                          .astype(np.float32))
    before = tb.das_pack.launches
    got = tb.das_pack(rf)
    assert tb.das_pack.launches == before
    assert torch.equal(got, tb.das_pack_plain(rf)) and got.shape == (2, 3, 54, 2)
    ref = np.zeros((2, 3, 55), np.float32)
    ref[..., 2:53] = rf.numpy()
    np.testing.assert_array_equal(got[..., 0].numpy(), ref[..., :54])
    np.testing.assert_array_equal(got[..., 1].numpy(), ref[..., 1:])


@pytest.mark.parametrize("case", list(CASES))
def test_packed_taps_are_the_plain_versions_masked_taps(case):
    """Each (angle, element) pair of a case: the DAS kernel's tap, the one
    packed entry i0 + 2 of the index clamped to [-2, T] (in float32, as the
    kernel clamps it), weighted as the kernel weights it, is bit-equal to
    ``das_beamform_plain`` of that pair alone, whose delays leave the trace
    at both ends: the packing's zeros are the plain version's masks."""
    A, E, T, convex, t_offset, seed = CASES[case]
    rf, angles, ex, ez, xg, zg = _case(A, E, T, convex, seed)
    ez = np.zeros_like(ex) if ez is None else ez
    packed = tb.das_pack_plain(torch.from_numpy(rf))
    rad = torch.from_numpy(angles) * math.radians(1.0)
    inv_c, fs = 1.0 / torch.tensor(C, dtype=torch.float32), torch.tensor(FS, dtype=torch.float32)
    X, Z = torch.meshgrid(torch.from_numpy(xg), torch.from_numpy(zg), indexing="ij")
    for a in range(A):
        t_tx = (X * torch.sin(rad[a]) + Z * torch.cos(rad[a])) * inv_c
        for e in range(E):
            t_rx = torch.sqrt((X - float(ex[e])) ** 2 + (Z - float(ez[e])) ** 2) * inv_c
            t_f = (t_tx + t_rx - t_offset) * fs
            i0f = torch.floor(t_f)
            w = t_f - i0f
            i0 = torch.clamp(i0f, -2.0, float(T)).to(torch.int64)
            v = packed[a, e][i0 + 2]
            got = v[..., 0] * (1.0 - w) + v[..., 1] * w
            want = tb.das_beamform_plain(torch.from_numpy(rf[a:a + 1, e:e + 1]), angles[a:a + 1],
                                         ex[e:e + 1], FS, C, torch.from_numpy(xg),
                                         torch.from_numpy(zg), t_offset=t_offset,
                                         elem_z=ez[e:e + 1])
            assert ((i0 < 0) | (i0 >= T - 1)).any() and ((i0 >= 0) & (i0 < T - 1)).any()
            assert torch.equal(got, want), (a, e)


def _stage_entries(plan, A, E, T, xg, zg, ex, ez, angles, fs, inv_c, t_offset):
    """The entries of rf2 (``das_pack``) that the DAS kernel's stages read,
    the largest over its tiles, passes of angles and elements: (by brute
    force, every pixel's index with ``das_beamform_plain``'s arithmetic;
    by the kernel's bound, ``delay_bounds`` over the tile's box).  A
    window spans the clamped indices' entries i0 + 2, widened to even
    entries of rf2 (16-byte bounds); a stage is a pass's windows of the
    plan's ``stage_elems`` elements."""
    k_a = min(A, tb.DAS_MAX_ANGLES)
    rad = torch.from_numpy(angles) * math.radians(1.0)
    sa, ca = torch.sin(rad), torch.cos(rad)
    rows = (torch.arange(A) * E) * (T + 3)
    worst = [0, 0]
    n_pass = -(-A // k_a)
    for x0 in range(0, xg.shape[0], plan.tile_x):
        for z0 in range(0, zg.shape[0], plan.tile_z):
            xs, zs = xg[x0:x0 + plan.tile_x], zg[z0:z0 + plan.tile_z]
            X, Z = (g.reshape(-1) for g in torch.meshgrid(xs, zs, indexing="ij"))
            bx0, bx1, bz0, bz1 = xs.min(), xs.max(), zs.min(), zs.max()
            t_tx = (X[None] * sa[:, None] + Z[None] * ca[:, None]) * inv_c  # [A, P]
            q = torch.stack([bx0 * sa + bz0 * ca, bx0 * sa + bz1 * ca, bx1 * sa + bz0 * ca,
                             bx1 * sa + bz1 * ca])
            stages = torch.zeros(2, n_pass, -(-E // plan.stage_elems), dtype=torch.int64)
            for e in range(E):
                t_rx = torch.sqrt((X - ex[e]) ** 2 + (Z - ez[e]) ** 2) * inv_c
                i0 = torch.floor((t_tx + t_rx - t_offset) * fs)
                dx, dz = torch.stack([bx0, bx1]) - ex[e], torch.stack([bz0, bz1]) - ez[e]
                dx2_lo = 0.0 if bx0 <= ex[e] <= bx1 else (dx * dx).min()
                dz2_lo = 0.0 if bz0 <= ez[e] <= bz1 else (dz * dz).min()
                r = (torch.sqrt(dx2_lo + dz2_lo), torch.sqrt((dx * dx).max() + (dz * dz).max()))
                f = torch.stack([(qq * inv_c + rr * inv_c - t_offset) * fs
                                 for qq in (q.min(0).values, q.max(0).values) for rr in r])
                true = (i0.min(1).values, i0.max(1).values)
                bound = (torch.floor(f.min(0).values), torch.floor(f.max(0).values))
                assert (bound[0] <= true[0]).all() and (bound[1] >= true[1]).all()
                for k, (lo, hi) in enumerate((true, bound)):
                    lo, hi = (torch.clamp(v, -2.0, float(T)).to(torch.int64) for v in (lo, hi))
                    rows_e = rows + e * (T + 3)
                    n = (rows_e + hi + 4) // 2 * 2 - (rows_e + lo + 2) // 2 * 2
                    stages[k, :, e // plan.stage_elems] += torch.stack(
                        [c.sum() for c in n.split(k_a)])
            worst = [max(w, int(st.max())) for w, st in zip(worst, stages)]
    return worst


@pytest.mark.parametrize("seed", range(8))
def test_das_plan_bounds_every_stage(seed):
    """The DAS kernel's planner on random small geometries (angles,
    elements, trace lengths, grids of random pitch, some of them uneven,
    sampling rates, sound speeds, offsets): the kernel's bound of each
    window contains the window found by brute force, and, where the plan
    does not split, the stage capacity holds every stage of both; its ring
    holds two slots.  A split plan's slot is a ``DAS_STAGES``-th of the
    ring."""
    rng = np.random.default_rng(seed)
    A, E, T = int(rng.integers(1, 13)), int(rng.integers(1, 5)), int(rng.integers(100, 3000))
    fs, c = float(rng.uniform(5e6, 6e7)), float(rng.uniform(1400.0, 1600.0))
    step = c / fs * rng.uniform(0.5, 3.0)
    nx, nz = (int(v) for v in rng.integers(5, 80, 2))
    xg = np.cumsum(step * rng.uniform(0.5 if seed % 2 else 1.0, 1.0, nx)) - step * nx / 2
    zg = 1e-3 + np.cumsum(step * rng.uniform(0.5 if seed % 2 else 1.0, 1.0, nz))
    xg, zg = (torch.from_numpy(g.astype(np.float32)) for g in (xg, zg))
    angles = np.sort(rng.uniform(-30.0, 30.0, A)).astype(np.float32)
    ex = torch.from_numpy(((np.arange(E) - (E - 1) / 2) * 3e-4).astype(np.float32))
    ez = torch.from_numpy((2e-4 * rng.random(E)).astype(np.float32))
    t_offset = float(rng.uniform(-2e-6, 4e-6))
    fs_t, inv_c = torch.tensor(fs, dtype=torch.float32), 1.0 / torch.tensor(c, dtype=torch.float32)
    plan = tb.das_plan(A, T, xg, zg, fs_t, inv_c)
    assert plan.tile_z * plan.tile_x == tb.DAS_WARPS * tb.DAS_PIX * 32
    assert plan.capacity % 2 == 0 and 2 * 8 * plan.capacity <= tb.DAS_RING_BYTES
    true, bound = _stage_entries(plan, A, E, T, xg, zg, ex, ez, angles, fs_t, inv_c, t_offset)
    assert 0 < true <= bound
    if plan.split:
        assert plan.capacity == tb.DAS_RING_BYTES // (8 * tb.DAS_STAGES) // 2 * 2
    else:
        assert bound <= plan.capacity


@pytest.mark.parametrize("shape", ["picmus", "usmain"])
def test_das_plan_splits_nothing_at_picmus_and_usmain(shape):
    """At the two deployments' shapes (``portbench``'s PICMUS cell: 75
    angles of 4 167 samples at 20.832 MHz on the 1 083 x 664 lambda / 4
    grid; USMain: 5 angles of 10 000 samples at 50 MHz on its 1 040 x 638
    grid) the planner splits no stage."""
    A, T, fs, f0 = {"picmus": (75, 4167, 20.832e6, 5.208e6), "usmain": (5, 10000, 50e6, 5e6)}[shape]
    step = float(np.float32(1540.0) / np.float32(f0) / 4.0)
    xg, zg = tb.grid_scan(-0.04, 0.04, 0.001, 0.05, step, step)
    plan = tb.das_plan(A, T, xg, zg, torch.tensor(fs), 1.0 / torch.tensor(1540.0))
    assert not plan.split and 2 * 8 * plan.capacity <= tb.DAS_RING_BYTES


def _pairs(st, rpp):
    """The pair rays [7, A * E] and, independently of the kernel's wrapper,
    the lanes [7, N] and each lane's angle."""
    b = plane_wave_rays(st.ultrasound)
    rays = torch.cat([b["o"].T, b["d"].T, b["tx_delay"][None]])
    lanes = torch.repeat_interleave(rays, rpp, dim=1)
    return rays, lanes, torch.repeat_interleave(b["angle_idx"], rpp)


@pytest.mark.parametrize("rpp,seed,desc", [(1, 0, usmain_desc), (4, -9, usmain_desc),
                                           (2, 5, usmain_scatterers_desc)],
                         ids=["1-0", "4--9", "64_prims"])
def test_deposit_mode_plain_is_deposit_of_the_records(rpp, seed, desc):
    st = tpu_rt_torch.load_dict(desc(tpu_rt_torch.ScalarTransform4f))
    us = st.ultrasound
    tables = us_kernel.pack_us_tables(us_kernel.bake_us_scene(st), 8, "cpu")
    rays, lanes, angle_idx = _pairs(st, rpp)
    before = (us_kernel.us_trace_rf.launches, us_kernel.us_trace.launches)
    got = us_kernel.us_trace_rf(tables, rays, seed, us.n_angles, us.time_samples, rpp)
    assert (us_kernel.us_trace_rf.launches, us_kernel.us_trace.launches) == before
    want = us_kernel.deposit_rf(us_kernel.us_trace_plain(tables, lanes, seed), angle_idx,
                                us.n_angles, us.n_elements, us.time_samples)
    assert got.shape == (5, 64, 10000) and got.abs().sum().item() > 0
    assert torch.equal(got, want)
    ch, tx = us_kernel.simulate_acquisition(st, seed=seed, rays_per_pair=rpp, device="cpu")
    assert torch.equal(ch, want / float(rpp))
    assert torch.equal(tx, rays[6].reshape(5, 64))
    with pytest.raises(ValueError):
        us_kernel.us_trace_rf(tables, lanes[:, :7], seed, us.n_angles, us.time_samples, rpp)


@pytest.mark.parametrize("desc", [usmain_desc, usmain_scatterers_desc])
def test_plain_version_counts_its_sweeps_and_visible_echoes(desc):
    """The counts K10's bound is made of: a closest-hit sweep a bounce a
    live lane starts, an any-hit sweep a bounce that hits, and each
    bounce's visible echoes (a non-zero pressure only where the echo is
    visible, a visible echo only where the bounce hit)."""
    st = tpu_rt_torch.load_dict(desc(tpu_rt_torch.ScalarTransform4f))
    tables = us_kernel.pack_us_tables(us_kernel.bake_us_scene(st), 8, "cpu")
    _, lanes, _ = _pairs(st, 2)
    sweeps = {}
    rec = us_kernel.us_trace_plain(tables, lanes, 1, sweeps=sweeps)
    assert torch.equal(rec, us_kernel.us_trace_plain(tables, lanes, 1))
    vis = torch.stack(sweeps["visible"])
    assert vis.shape == rec[0::3].shape
    assert not (rec[0::3] != 0)[~vis].any()
    assert lanes.shape[1] <= sweeps["closest"]  # every lane starts its first bounce
    assert 0 < int(vis.sum()) <= sweeps["any"] <= sweeps["closest"]


def test_us_render_on_cpu_takes_the_plain_versions(monkeypatch):
    """us_render on the CPU: the acquisition's deposit-mode plain version
    once, the gather DAS's plain version once, no matmul DAS and no kernel
    launch."""
    st = tpu_rt_torch.load_dict(usmain_desc(tpu_rt_torch.ScalarTransform4f))
    calls = {"rf": 0, "das": 0}

    def counted(key, fn):
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call

    def no_matmul(*a, **k):
        raise AssertionError("us_render took the matmul DAS")

    monkeypatch.setattr(us_kernel, "us_trace_rf_plain",
                        counted("rf", us_kernel.us_trace_rf_plain))
    monkeypatch.setattr(tb, "das_beamform_plain", counted("das", tb.das_beamform_plain))
    monkeypatch.setattr(tb, "das_beamform_matmul", no_matmul)
    launches = (us_kernel.us_trace.launches, us_kernel.us_trace_rf.launches,
                tb.das_beamform.launches)
    img, ch, tx = pipeline.us_render(st, seed=1, rays_per_pair=2, device="cpu", **SMALL)
    assert calls == {"rf": 1, "das": 1}
    assert (us_kernel.us_trace.launches, us_kernel.us_trace_rf.launches,
            tb.das_beamform.launches) == launches
    assert img.shape == (105, 105) and bool(torch.isfinite(img).all())
    assert 0.0 <= img.min().item() and img.max().item() <= 1.0 and img.std().item() > 0.05
    assert ch.shape == (5, 64, 10000) and tx.shape == (5, 64)


def _twin_records(twin, rpp=2, seed=5):
    st = tpu_rt_torch.load_dict(usmain_twin_desc(tpu_rt_torch.ScalarTransform4f, twin))
    bs = us_kernel.bake_us_scene(st)
    tables = us_kernel.pack_us_tables(bs, 8, "cpu")
    return bs, us_kernel.us_trace_plain(tables, _pairs(st, rpp)[1], seed)


def test_coincident_prims_tie_to_the_lower_prim():
    """The plate and its twin (another impedance) meet every ray at the
    same t: the sweep keeps the lower prim, so the records are those of
    the lower one alone."""
    bs, after = _twin_records("after")
    assert len(bs.prims) == 3 and bs.prims[0].data == bs.prims[1].data
    assert bs.bsdfs[bs.prims[0].bsdf] != bs.bsdfs[bs.prims[1].bsdf]
    _, before = _twin_records("before")
    _, alone = _twin_records("alone")
    st = tpu_rt_torch.load_dict(usmain_desc(tpu_rt_torch.ScalarTransform4f))
    plate = us_kernel.us_trace_plain(us_kernel.pack_us_tables(us_kernel.bake_us_scene(st), 8,
                                                              "cpu"), _pairs(st, 2)[1], 5)
    assert torch.equal(after, plate) and torch.equal(before, alone)
    assert not torch.equal(after[0::3], before[0::3])  # the impedance shows in the pressures
    assert after[0].abs().sum().item() > 0


def test_per_scene_keeps_a_value_while_the_scene_lives():
    """What us_render keeps per scene (the kernel's tables, the rays, the
    grid on the device) is made once a scene object, made again for
    another, and let go with the scene; a value kept at a tensor's
    version is made again once the tensor changes."""
    made = []

    def make():
        made.append(1)
        return len(made)

    a = tpu_rt_torch.load_dict(usmain_desc(tpu_rt_torch.ScalarTransform4f))
    assert memo.per_object(a, "k", make) == 1 and memo.per_object(a, "k", make) == 1
    assert memo.per_object(a, "other", make) == 2
    b = a.replace(max_depth=a.max_depth)  # an equal scene, another object
    assert memo.per_object(b, "k", make) == 3
    keys = [k for k in memo._KEPT if k[0] == id(a)]
    assert len(keys) == 2
    del a
    assert not any(k in memo._KEPT for k in keys)
    g = torch.zeros(3)
    assert memo.per_object(g, "k", make, version=g._version) == 4
    assert memo.per_object(g, "k", make, version=g._version) == 4
    g.add_(1.0)
    assert memo.per_object(g, "k", make, version=g._version) == 5
