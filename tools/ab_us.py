"""Interleaved same-process A/B of builds of the ultrasound acquisition
kernel K10 (``tpu_rt_torch/ops/csrc/us_acq.cu``), the DAS kernel and its
adjoint (``us_das.cu``) on one GPU, with a torch.profiler split of the
acquisition in each variant's form.

    python tools/ab_us.py --variant NAME=DIR[:CONST=VALUE ...] [...]
                          [--out build/ab_us.json] [--reps 7] [--das-only]
                          [--picmus-only] [--probe NAME ...]

Each DIR holds a ``us_acq.cu`` and the ``common.cuh`` it includes, and
may hold a ``us_das.cu``: the package's own (``tpu_rt_torch/ops/csrc``)
or an earlier commit's (``git show COMMIT:tpu_rt_torch/ops/csrc/us_acq.cu``
and ``common.cuh`` into an ignored directory such as ``build/ab/parent``).
``:CONST=VALUE`` builds a copy with the ``constexpr int CONST = ...;`` of
``us_acq.cu`` or ``us_das.cu`` set to VALUE (``kGroup=4``: four threads a
lane; ``kPix=2``: two pixels a thread of the DAS, whose planner is then
run with it, as with ``kWarps`` and ``kStages`` (``LAYOUT``);
``kMinBlocks=3``: its registers capped for 3 blocks an SM;
``kAdjTileZ=64``: the adjoint's pixel tiles 64 high; ``kAdjMinBlocks=4``:
its registers capped for 4 blocks an SM), as ``tools/ab_common.py`` sets
out.  Every variant
is compiled by its own nvcc, all started together, with the package's
flags, into ``build/ab_us/NAME/``; ptxas's registers and spills are
printed.  A build whose launch takes no ``rays_per_pair`` (one thread a
lane, records only: the kernel before its deposit mode) is driven with
the lanes' rays, in records mode, and its acquisition is the records and
``deposit_rf`` (``parent_acquisition``, that form's
``simulate_acquisition``).  ``--probe NAME`` builds besides a copy of
variant NAME whose DAS reads no memory for its taps (each ``const float2 v
= load(address);`` of its ``us_das.cu`` replaced by a value made from the
address): against NAME it says how much of the DAS's time its loads take.

Timed, each variant in turn within a round, two warm-ups each, the median
of ``--reps`` rounds, CUDA events around 20 calls and the kernel's own
device time a launch (torch.profiler over 20 calls): the records mode on
the USMain, cone-box and scatterers acquisitions (rpp 64, 20 480 lanes,
seed 0; the scatterers scene is USMain with 62 small spheres in front of
its plate, 64 prims, the most K10 takes; every variant's records equal to
the first variant's, or the tool fails); the deposit mode on the same
(its RF within 1e-6 of the largest |RF| of ``deposit_rf`` of the first
variant's records); the whole acquisition (``simulate_acquisition`` with
the variant's kernel, or ``parent_acquisition``), CUDA events around 5
calls; and three acquisitions of each form under torch.profiler: the
device-busy time (the device events' own time, host rows left out), the
idle share of the window, the top operations by device time and the
host's operator counts.  ``--das-only`` skips these (the RF is still made by the first
variant's K10).

For the variants with a DAS kernel, first the DAS at PICMUS's size
(``PICMUS``: 75 plane waves x 128 elements x 4 167 samples of seeded
noise on the 1 084 x 664 grid of ``portbench``'s ``picmus.bmode.rpp64``
cell), CUDA events around 5 calls and the DAS kernel's device time, every
image ``torch.equal`` to the first variant's, then each probe against its
variant (no check: a probe's image is wrong by design);
``--tiles WZ,...`` times the staged variants' DAS besides with each tile
of ``das_plans`` named by its ``tile_wz`` forced (here and on the frames
below).  ``--picmus-only`` stops there.  Then the DAS on the USMain and cone-box
frames (the first deposit variant's RF; the 1040 x 638 and 723 x 650
grids), CUDA events around 5 calls and the DAS kernel's device time,
every image equal to the first variant's: ``das_beamform``'s launch (the
packing kernel, whose device time is printed too, then the DAS kernel)
for a build whose ``us_das_launch`` takes the planner's launch
(``tile_wz``: the staged kernel), else that build's packing and
its ``us_das_launch`` on the packed RF, or for a build without
``us_das_pack_launch`` the unpacked RF, as that build's wrapper did.  Then the
whole frame on each of these scenes, the main path (``us_render`` at rpp
64, seed 3: K10, the DAS, envelope and log) with each variant's DAS, CUDA
events around 5 frames (the median, least and most of ``--reps`` rounds;
every frame within 1e-3 of the first variant's), and a profile of three
frames of each (device-busy time, idle share, top operations).  For the
variants with ``us_das_adjoint_launch``, ``das_adjoint`` on USMain's RF
and a B-mode MSE's cotangent (the frame's image against that of the
seed-1 frame, through the envelope and log), d RF alone and with the
geometry, CUDA events around 5 calls and the adjoint kernel's device
time, each variant's d RF within 1e-5 of the first variant's largest.
The card's name and power limit are printed, and everything goes to
``--out`` as JSON.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import sys
import time
from contextlib import contextmanager

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import ab_common  # noqa: E402
import tpu_rt_torch as tt  # noqa: E402
from ab_common import equal, timed, use  # noqa: E402
from tpu_rt_torch.ops import us_kernel as uk  # noqa: E402
from tpu_rt_torch.sensor.transducer import element_geometry, plane_wave_rays  # noqa: E402
from tpu_rt_torch.us import beamform as bf  # noqa: E402
from torch_port_scenes import cone_box_desc, usmain_desc, usmain_scatterers_desc  # noqa: E402

LAUNCHES = 20  # launches a kernel timing
CALLS = 5  # acquisitions a timing
# the DAS's grids (x, z bounds, the lambda / 4 step): USMain's 1040 x 638
# (us_render's defaults) and the cone box's 723 x 650
# (tests/golden/make_us_cone_golden.py)
DAS_GRIDS = {"USMain": ((-0.04, 0.04), (0.001, 0.05)),
             "cone box": ((-0.04, 0.04), (0.001, 0.09))}
RPP = 64
SOURCES = ("us_acq.cu", "us_das.cu")
# PICMUS's sequence as portbench/configs/picmus-l11.json runs it: the
# L11-4v's 128 elements at 0.3 mm, 75 plane waves over +-16 degrees, 4 167
# samples at 20.832 MHz, c 1540, on the lambda / 4 grid of x +-4 cm, z 1-50 mm
PICMUS = {"A": 75, "E": 128, "T": 4167, "fs": 20.832e6, "f0": 5.208e6, "c": 1540.0,
          "pitch": 3e-4, "x": (-0.04, 0.04), "z": (0.001, 0.05)}
# a tap's load in us_das.cu (a call on its address), and what a probe puts
# in its place: a value made from the address, so that it is still computed
TAP_LOAD = re.compile(r"const float2 v = \w+\(([^;]+)\);")
NO_LOAD = (r"const float2 v = make_float2(__int_as_float((int)(size_t)(\1)), "
           r"__int_as_float((int)(size_t)(\1) + 1));")


class Variant:
    """One build; ``pairs`` says whether its launch takes the pair rays,
    rays_per_pair and a mode (else it is the records-only launch)."""

    def __init__(self, name, lib, pairs):
        self.name, self.lib, self.pairs = name, lib, pairs

    def us_acq_launch(self, hdr, n_hdr, tab, n_tab, rays, n_pairs, rpp, out, seed, mode, n_t,
                      stream):
        if self.pairs:
            return self.lib.us_acq_launch(hdr, n_hdr, tab, n_tab, rays, n_pairs, rpp, out, seed,
                                          mode, n_t, stream)
        if rpp != 1 or mode != uk.MODE_RECORDS:
            raise ValueError(f"variant {self.name} has the records mode only")
        return self.lib.us_acq_launch(hdr, n_hdr, tab, n_tab, rays, out, n_pairs, seed, stream)

    def __getattr__(self, name):  # every other entry point, as the library has it
        return getattr(self.lib, name)


def probe_dir(name, d, out_root):
    """A copy of source directory d in out_root/NAME whose DAS reads no
    memory for its taps (TAP_LOAD replaced by NO_LOAD)."""
    out = os.path.join(out_root, name)
    os.makedirs(out, exist_ok=True)
    for f in ("common.cuh",) + SOURCES:
        shutil.copy(os.path.join(d, f), out)
    with open(os.path.join(out, "us_das.cu")) as fh:
        src, n = TAP_LOAD.subn(NO_LOAD, fh.read())
    if n == 0:
        raise ValueError(f"probe {name}: no tap load in {d}/us_das.cu")
    with open(os.path.join(out, "us_das.cu"), "w") as fh:
        fh.write(src)
    return out


# constants of us_das.cu that the package's planner mirrors
# (us/beamform.py's DAS_*): a variant that sets one is planned with it
LAYOUT = {"kPix": "DAS_PIX", "kWarps": "DAS_WARPS", "kStages": "DAS_STAGES",
          "kMaxStageElems": "DAS_MAX_STAGE_ELEMS", "kRingBytes": "DAS_RING_BYTES"}


@contextmanager
def planned_as(v):
    """The planner's mirrors of us_das.cu's constants set to variant v's."""
    saved = {k: getattr(bf, k) for k in v.layout}
    for k, val in v.layout.items():
        setattr(bf, k, val)
    try:
        yield
    finally:
        for k, val in saved.items():
            setattr(bf, k, val)


def build(specs, probes=()):
    src_root = os.path.join(ROOT, "build", "ab_us", "src")
    dirs = {name: ab_common.variant_dir(name, spec, SOURCES, src_root)
            for name, spec in specs.items()}
    for name in probes:
        dirs[f"{name}-noload"] = probe_dir(f"{name}-noload", dirs[name], src_root)
    jobs = {}
    for name, d in dirs.items():
        out = os.path.join(ROOT, "build", "ab_us", name)
        os.makedirs(out, exist_ok=True)
        jobs[name] = (os.path.join(out, "us_acq.so"),
                      ["-shared", *[os.path.join(d, f) for f in SOURCES
                                    if os.path.exists(os.path.join(d, f))]])
    logs = ab_common.nvcc_all(jobs)
    variants, ptxas = {}, {}
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name, log in logs.items():
        lib = ctypes.CDLL(jobs[name][0])
        with open(os.path.join(dirs[name], "us_acq.cu")) as f:
            pairs = "int rays_per_pair" in f.read()
        lib.us_acq_launch.argtypes = ([vp, i, vp, i, vp, i, i, vp, i, i, i, vp] if pairs
                                      else [vp, i, vp, i, vp, vp, i, i, vp])
        lib.us_acq_launch.restype = i
        lib.us_acq_error_string.argtypes = [i]
        lib.us_acq_error_string.restype = ctypes.c_char_p
        v = variants[name] = Variant(name, lib, pairs)
        consts = dict(c.split("=", 1) for c in specs.get(name.removesuffix("-noload"), "")
                      .split(":")[1:])
        v.layout = {LAYOUT[k]: int(val) for k, val in consts.items() if k in LAYOUT}
        v.das = os.path.exists(os.path.join(dirs[name], "us_das.cu"))
        v.pack = v.adjoint = v.staged = False
        if v.das:
            with open(os.path.join(dirs[name], "us_das.cu")) as fh:
                src = fh.read()
            v.pack, v.adjoint = "us_das_pack_launch" in src, "us_das_adjoint_launch" in src
            v.staged = "int tile_wz" in src
            f = ctypes.c_float
            lib.us_das_launch.argtypes = ([vp, i, i, i, vp, i, vp, i, vp, vp, vp, vp, f, f, f]
                                          + ([i, i, i] if v.staged else []) + [vp, vp])
            lib.us_das_launch.restype = i
            lib.us_das_error_string.argtypes = [i]
            lib.us_das_error_string.restype = ctypes.c_char_p
            if v.pack:
                lib.us_das_pack_launch.argtypes = [vp, i, i, vp, vp]
                lib.us_das_pack_launch.restype = i
            if v.adjoint:
                lib.us_das_adjoint_launch.argtypes = [vp, i, i, i, vp, i, vp, i, vp, vp, vp, vp,
                                                      f, f, f, vp, vp, vp, vp]
                lib.us_das_adjoint_launch.restype = i
        ptxas[name] = ab_common.ptxas(name, log)
    return variants, ptxas


def parent_acquisition(scene, seed=0, rays_per_pair=1, device="cuda", tile_rows=8):
    """``simulate_acquisition`` as it ran before the deposit mode: the
    lanes' rays repeated on the device, the records mode, ``deposit_rf``
    (20 index_add_ at depth 10) and the division."""
    bs = uk.bake_us_scene(scene)
    us = scene.ultrasound
    A, E, T = us.n_angles, us.n_elements, us.time_samples
    base = plane_wave_rays(us)
    rays = torch.cat([base["o"].T, base["d"].T, base["tx_delay"][None]])
    rays = torch.repeat_interleave(rays.to(device), rays_per_pair, dim=1)
    angle_idx = torch.repeat_interleave(base["angle_idx"].to(device), rays_per_pair)
    records = uk.us_trace(uk.pack_us_tables(bs, tile_rows, device), rays, seed)
    channel = uk.deposit_rf(records, angle_idx, A, E, T) / float(rays_per_pair)
    return channel, base["tx_delay"].reshape(A, E).to(device)


def das_inputs(rf, us, pos, xg, zg):
    """``das_beamform``'s inputs to its launch, as it makes them: (rf, elem
    x, elem z, sin a, cos a, 1 / c, fs, x grid, z grid)."""
    ex, ez, angles, fs, c = bf._setup(rf, us.angles, pos[:, 0], pos[:, 2], us.sampling_rate,
                                      us.sound_speed)
    return (rf.contiguous(), ex.contiguous(), ez.contiguous(), torch.sin(angles),
            torch.cos(angles), 1.0 / c, fs, xg.contiguous(), zg.contiguous())


def das_call(v, inputs, t_offset=0.0):
    """The DAS image of ``inputs`` through variant v: ``das_beamform``'s
    launch (packing, the planner, the DAS kernel) for a staged build; else
    that build's packing, if it has one, and its ``us_das_launch`` on the
    packed or the plain RF, as its wrapper did."""
    if v.staged:
        with use(v), planned_as(v):
            return bf._das_launch(*inputs, t_offset)
    rf, ex, ez, sin_a, cos_a, inv_c, fs, xg, zg = inputs
    A, E, T = rf.shape
    if v.pack:
        with use(v):
            rf = bf.das_pack(rf)  # held by name until the launch is queued
    out = torch.empty((xg.shape[0], zg.shape[0]), dtype=torch.float32, device=rf.device)
    err = v.lib.us_das_launch(rf.data_ptr(), A, E, T, xg.data_ptr(), xg.shape[0], zg.data_ptr(),
                              zg.shape[0], ex.data_ptr(), ez.data_ptr(), sin_a.data_ptr(),
                              cos_a.data_ptr(), float(inv_c), float(t_offset), float(fs),
                              out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"variant {v.name}'s us_das launch failed: {err}")
    return out


@contextmanager
def das_route(v):
    """``das_beamform`` launching variant v's DAS: the package's own launch
    for a staged build, else ``das_call``'s (that build's own form)."""
    saved = bf._das_launch
    if not v.staged:
        bf._das_launch = lambda *args, **kw: das_call(v, args[:9], args[9])
    try:
        with use(v), planned_as(v):
            yield
    finally:
        bf._das_launch = saved


def frame_close(name, v, first, got):
    """B-mode frames in [0, 1]: K10's deposit adds its taps by atomics, so
    two frames of one seed may differ in the last bits of the RF."""
    err = (got - first).abs().max().item()
    if err > 1e-3:
        raise AssertionError(f"{name}: variant {v}'s frame is {err:.3e} off")


def drf_close(name, v, first, got):
    scale = first[0].abs().max().item()
    err = (got[0] - first[0]).abs().max().item()
    if not scale > 0 or err > 1e-5 * scale:
        raise AssertionError(f"{name}: variant {v}'s d RF is {err:.3e} off ({scale:.3e})")


def rf_close(name, v, first, got):
    err = (got - first).abs().max().item()
    if err > 1e-6 * first.abs().max().item():
        raise AssertionError(f"{name}: variant {v}'s RF is {err:.3e} off")


def profile(fn, n=3):
    """torch.profiler over n calls after a warm-up: device-busy ms, the
    idle share of the window, the top device operations and the host's
    operator counts."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    smoke = ab_common.chip_smoke()
    rows = [(e.key, smoke.dev_us(e) / 1e3 / n, e.count / n) for e in prof.key_averages()]
    top_dev = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])[:8]
    top_host = sorted((r for r in rows if r[0].startswith("aten::")), key=lambda r: -r[2])[:8]
    busy_ms = smoke.busy_ms(prof) / n
    return {"wall_ms": wall / n, "busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / (wall / n),
            "top_device_ms": [[k, ms] for k, ms, _ in top_dev],
            "top_host_calls": [[k, c] for k, _, c in top_host]}


def k10_timings(res, prof, label, scene, variants, tables, rays, lanes, angle_idx, reps, dev):
    """K10's records, deposit mode and whole acquisitions on one scene, the
    variants in turns, and a profile of each variant's acquisition."""
    us = scene.ultrasound

    def records(v):
        with use(v):
            return uk.us_trace(tables, lanes, 0)

    rec = timed(res, f"K10 records, {label} {lanes.shape[1]} lanes",
                {n: (lambda v=v: records(v)) for n, v in variants.items()}, reps,
                LAUNCHES, equal, kernel="us_acq_kernel")
    want = uk.deposit_rf(rec, angle_idx, us.n_angles, us.n_elements, us.time_samples)
    deposit = {n: v for n, v in variants.items() if v.pairs}

    def rf(v):
        with use(v):
            return uk.us_trace_rf(tables, rays, 0, us.n_angles, us.time_samples, RPP)

    if deposit:
        rf_close(f"{label} deposit", "first", want, rf(next(iter(deposit.values()))))
        timed(res, f"K10 deposit mode, {label}",
              {n: (lambda v=v: rf(v)) for n, v in deposit.items()}, reps, LAUNCHES,
              rf_close, kernel="us_acq_kernel")

    def acquisition(v):
        fn = uk.simulate_acquisition if v.pairs else parent_acquisition
        with use(v):
            return fn(scene, seed=0, rays_per_pair=RPP, device=dev)[0]

    timed(res, f"acquisition, {label}",
          {n: (lambda v=v: acquisition(v)) for n, v in variants.items()}, reps, CALLS,
          rf_close)
    for n, v in variants.items():
        prof[f"{label} {n}"] = p = profile(lambda v=v: acquisition(v))
        print(f"profile of the acquisition, {label}, {n}: wall {p['wall_ms']:.3f} ms a call, "
              f"device busy {p['busy_ms']:.4f} ms, idle share {p['idle_share']:.4f}; top "
              f"device ops {[(k, round(ms, 4)) for k, ms in p['top_device_ms']]}; host ops "
              f"{[(k, c) for k, c in p['top_host_calls']]}", flush=True)


def picmus_inputs(dev):
    """``das_beamform``'s inputs to its launch at PICMUS's size (as
    ``das_inputs`` makes them), the RF seeded noise."""
    p = PICMUS
    rng = np.random.default_rng(0)
    rf = torch.from_numpy(rng.standard_normal((p["A"], p["E"], p["T"]), dtype=np.float32))
    step = p["c"] / p["f0"] / 4.0
    xg, zg = bf.grid_scan(*p["x"], *p["z"], step, step)
    ex = (np.arange(p["E"]) - (p["E"] - 1) / 2) * p["pitch"]
    pos = torch.stack([torch.from_numpy(ex).float(), torch.zeros(p["E"]),
                       torch.zeros(p["E"])], 1).to(dev)
    us = argparse.Namespace(angles=np.linspace(-16.0, 16.0, p["A"]), sampling_rate=p["fs"],
                            sound_speed=p["c"])
    return das_inputs(rf.to(dev), us, pos, xg.to(dev), zg.to(dev))


@contextmanager
def forced_tile(tile_wz):
    """``das_beamform``'s planner held to the tile of ``tile_wz`` warp tiles
    along z (of ``das_plans``), not its own choice."""
    saved = bf.das_plan
    bf.das_plan = lambda *a: next(p for p in bf.das_plans(*a) if p.tile_wz == tile_wz)
    try:
        yield
    finally:
        bf.das_plan = saved


def tile_timings(res, name, variants, inputs, tiles, reps):
    """The staged variants' DAS on ``inputs`` with each tile of ``tiles``
    forced, in turns, every image equal to the first's."""
    fns = {}
    for n, v in variants.items():
        for wz in tiles if v.staged else ():
            def fn(v=v, wz=wz):
                with forced_tile(wz):
                    return das_call(v, inputs)
            fns[f"{n} tile_wz {wz}"] = fn
    if fns:
        timed(res, f"{name}, forced tiles", fns, reps, CALLS, equal, kernel="us_das_kernel")


def picmus_timings(res, variants, probes, reps, dev, tiles=()):
    """The DAS at PICMUS's size, the variants in turns, every image equal
    to the first's; then each probe ({variant's name: probe}) against its
    variant, unchecked."""
    inputs = picmus_inputs(dev)
    nx, nz = inputs[7].numel(), inputs[8].numel()
    das_vs = {n: v for n, v in variants.items() if v.das}
    name = f"DAS kernel, PICMUS {nx} x {nz}"
    timed(res, name, {n: (lambda v=v: das_call(v, inputs)) for n, v in das_vs.items()}, reps,
          CALLS, equal, kernel="us_das_kernel")
    tile_timings(res, name, das_vs, inputs, tiles, reps)
    for n, probe in probes.items():
        pair = {n: variants[n], probe.name: probe}
        timed(res, f"DAS kernel and its probe without loads, PICMUS {nx} x {nz}",
              {k: (lambda v=v: das_call(v, inputs)) for k, v in pair.items()}, reps, CALLS,
              lambda *_: None, kernel="us_das_kernel")


def das_timings(res, label, variants, scene, tables, rays, reps, dev, tiles=()):
    """The DAS on a scene's frame (its grid from DAS_GRIDS) and, on
    USMain's, its adjoint, the variants in turns."""
    us = scene.ultrasound
    first = next(v for v in variants.values() if v.pairs)
    with use(first):
        rf_main = uk.us_trace_rf(tables, rays, 0, us.n_angles, us.time_samples, RPP) / RPP
        rf_other = uk.us_trace_rf(tables, rays, 1, us.n_angles, us.time_samples, RPP) / RPP
    step = float(us.sound_speed) / float(us.frequency) / 4.0
    (x0, x1), (z0, z1) = DAS_GRIDS[label]
    xg, zg = (g.to(dev) for g in bf.grid_scan(x0, x1, z0, z1, step, step))
    pos, _ = element_geometry(us.n_elements, us.pitch, us.radius, us.opening_angle)
    pos = pos.to(dev)
    inputs = das_inputs(rf_main, us, pos, xg, zg)
    das_vs = {n: v for n, v in variants.items() if v.das}
    name = f"DAS kernel, {label} {xg.numel()} x {zg.numel()}"
    img = timed(res, name,
                {n: (lambda v=v: das_call(v, inputs)) for n, v in das_vs.items()}, reps,
                CALLS, equal, kernel="us_das_kernel")
    tile_timings(res, name, das_vs, inputs, tiles, reps)
    smoke = ab_common.chip_smoke()
    for n, v in das_vs.items():
        if v.pack:
            ms, seen = smoke.kernel_device_ms(lambda v=v: das_call(v, inputs),
                                              "us_das_pack_kernel", n=CALLS)
            res[name][n]["pack_kernel_ms"] = ms
            print(f"  {n}: the packing kernel {ms:.5f} ms on the card ({seen} launches seen)")
    # the whole frame, the main path (us_render: K10, the DAS, envelope
    # and log) with each variant's DAS, and a profile of it
    def frame(v):
        with das_route(v):
            return tt.us_render(scene, seed=3, rays_per_pair=RPP, x_bounds=(x0, x1),
                                z_bounds=(z0, z1), device=dev)[0]

    fname = f"frame, {label} {xg.numel()} x {zg.numel()}"
    timed(res, fname, {n: (lambda v=v: frame(v)) for n, v in das_vs.items()}, reps, CALLS,
          frame_close)
    for n, v in das_vs.items():
        t = res[fname][n]["all_ms"]
        res[fname][n]["profile"] = p = profile(lambda v=v: frame(v))
        print(f"  {n}: frame min {min(t):.5f}, max {max(t):.5f} ms; profile: wall "
              f"{p['wall_ms']:.3f} ms a frame, device busy {p['busy_ms']:.4f} ms, idle share "
              f"{p['idle_share']:.4f}; top device ops "
              f"{[(k, round(ms, 4)) for k, ms in p['top_device_ms']]}", flush=True)
    adj_vs = {n: v for n, v in das_vs.items() if v.adjoint}
    if not adj_vs or label != "USMain":
        return
    # a B-mode MSE's cotangent: the frame's image against the seed-1 frame's
    target = bf.log_compress(bf.hilbert_envelope(
        das_call(next(iter(das_vs.values())), das_inputs(rf_other, us, pos, xg, zg)),
        axis=1)).T
    leaf = img.detach().requires_grad_()
    loss = ((bf.log_compress(bf.hilbert_envelope(leaf, axis=1)).T - target) ** 2).mean()
    g, = torch.autograd.grad(loss, leaf)
    for what, geometry in (("d RF alone", False), ("with the geometry", True)):
        def adjoint(v, geometry=geometry):
            with use(v):
                return bf.das_adjoint(*inputs, g, geometry=geometry)

        timed(res, f"DAS adjoint, {what}, USMain {xg.numel()} x {zg.numel()}",
              {n: (lambda v=v: adjoint(v)) for n, v in adj_vs.items()}, reps, CALLS,
              drf_close, kernel="us_das_adjoint_kernel")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", required=True, help="NAME=DIR[:CONST=VALUE]")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "ab_us.json"))
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--das-only", action="store_true",
                    help="skip K10's timings and profiles: the DAS and its adjoint alone")
    ap.add_argument("--picmus-only", action="store_true",
                    help="the DAS at PICMUS's size alone (and the probes)")
    ap.add_argument("--probe", action="append", default=[],
                    help="NAME: also time variant NAME with its taps' loads taken out")
    ap.add_argument("--tiles", type=lambda t: [int(v) for v in t.split(",")], default=[],
                    help="WZ,...: also time the staged variants' DAS with each tile forced")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_us: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = ab_common.card()
    print(f"card: {smi}", flush=True)
    specs = dict(v.split("=", 1) for v in args.variant)
    variants, ptxas = build(specs, args.probe)
    probes = {n: variants.pop(f"{n}-noload") for n in args.probe}
    dev = torch.device("cuda")
    res, prof = {}, {}
    if any(v.das for v in variants.values()):
        picmus_timings(res, variants, probes, args.reps, dev, args.tiles)
    st = tt.ScalarTransform4f
    for label, desc in (("USMain", usmain_desc), ("cone box", cone_box_desc),
                        ("scatterers", usmain_scatterers_desc)):
        if args.picmus_only:
            break
        if args.das_only and label not in DAS_GRIDS:
            continue
        scene = tt.load_dict(desc(st))
        us = scene.ultrasound
        tables = uk.pack_us_tables(uk.bake_us_scene(scene), 8, dev)
        b = plane_wave_rays(us)
        rays = torch.cat([b["o"].T, b["d"].T, b["tx_delay"][None]]).to(dev)
        lanes = torch.repeat_interleave(rays, RPP, dim=1)
        angle_idx = torch.repeat_interleave(b["angle_idx"], RPP).to(dev)
        if not args.das_only:
            k10_timings(res, prof, label, scene, variants, tables, rays, lanes, angle_idx,
                        args.reps, dev)
        if label in DAS_GRIDS and any(v.das for v in variants.values()):
            das_timings(res, label, variants, scene, tables, rays, args.reps, dev, args.tiles)
    out = {"card": smi, "variants": specs, "ptxas": ptxas, "launches": res, "profiles": prof}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
