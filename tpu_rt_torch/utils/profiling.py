"""Profiling and tracing utilities.

Counterpart of ``tpu_rt/utils/profiling.py``, over ``torch.profiler``
where tpu_rt used ``jax.profiler``:

    with trace("/tmp/tpu_rt_torch_trace"):
        img = render(scene, spp=16)
    # -> a Chrome trace (chrome://tracing, Perfetto) of the host operators,
    #    the port's named spans and, on a GPU, the kernels and copies

    measure_device_trace(lambda: render(scene, spp=64))
    # -> wall, device busy and the port's own kernels' time, from a trace

The port marks its layer boundaries with ``span(name)``: inside
``render``, ``us_render`` and the stages they call, a range named
``tpu_rt_torch.<function>`` in the profiler's trace beside the device's
events, and a shared null context when no profiler records.  The trace's
device times can drift against its host times (by up to 1.7 ms in 12 s on
an H100): compare a span with a kernel through the kernel's launch call.

Each kernel wrapper of the port counts its launches in a ``launches``
attribute; ``launch_counters`` names them, ``reset_launch_counts`` and
``launch_counts`` set them to 0 and read them around a run.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
import time
from pathlib import Path

import torch
from torch.autograd.profiler import record_function

_CSRC = Path(__file__).resolve().parents[1] / "ops" / "csrc"
_KERNEL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?"
                     r"(\w+)\s*\(")
# the Chrome trace's categories of device work
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named range of the port's work: ``record_function(name)`` while a
    profiler records (the range lands in its trace beside the kernels,
    copies and memsets), else one shared null context, so a span costs a
    flag check when nothing records."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _NO_SPAN


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _export(prof, log_dir):
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace.{os.getpid()}.{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` around a block (CPU activity, and CUDA where a
    GPU is present), its Chrome trace written into ``log_dir`` as
    ``trace.<pid>.<ns>.json``.  The block's device work is synchronized
    before the profiler stops.  Yields the profiler."""
    from torch.profiler import profile

    with profile(activities=_activities()) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    _export(prof, log_dir)


def kernel_names():
    """The names of the port's CUDA kernels: every ``__global__`` function
    of ``ops/csrc/*.cu``."""
    names = set()
    for src in sorted(_CSRC.glob("*.cu")):
        names.update(_KERNEL.findall(src.read_text()))
    return names


def _union(iv):
    """The length of the union of (start, end) intervals."""
    iv = sorted(iv)
    tot = 0.0
    cur_s, cur_e = iv[0]
    for s_, e_ in iv[1:]:
        if s_ > cur_e:
            tot += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    return tot + (cur_e - cur_s)


def measure_device_trace(fn, log_dir=None):
    """Run ``fn()`` under ``torch.profiler`` and return the device's
    timing from its trace, as tpu_rt's function returns it from an XLA
    trace:

      wall_s            host wall time of fn(), synchronized
      device_busy_s     length of the union of the device's kernel, copy
                        and memset intervals
      kernel_s          length of the union of the port's own kernels'
                        intervals (``kernel_names``: ops/csrc/*.cu)
      device_busy_frac  device_busy_s / wall_s
      kernel_frac       kernel_s / wall_s
      kernels_seen      kernel launches the trace holds on the device
      launches_issued   kernel launches the host issued (the runtime's
                        launch calls, by correlation id)

    The figures count what the profiler saw.  On the H100 it has been
    seen to miss most of a call's kernels in a process that had profiled
    many windows before: a trace in which a launch the host issued has
    no kernel on the device raises RuntimeError, as does a trace with no
    device event (on the CPU, always).  The trace is kept in ``log_dir``
    (a new temporary directory by default)."""
    from torch.profiler import profile

    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="tpu_rt_torch_trace_")
    with profile(activities=_activities()) as prof:
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with open(_export(prof, log_dir)) as f:
        evs = json.load(f).get("traceEvents", [])
    names = kernel_names()
    intervals, kernel_iv, seen, issued = [], [], set(), set()
    for e in evs:
        if e.get("ph") != "X":
            continue
        corr = e.get("args", {}).get("correlation")
        if (e.get("cat") == "cuda_runtime" and "LaunchKernel" in e.get("name", "")
                and corr is not None):
            issued.add(corr)
        if e.get("cat") not in _DEVICE_CATS:
            continue
        ts = float(e.get("ts", 0.0))
        iv = (ts, ts + float(e.get("dur", 0.0)))
        intervals.append(iv)
        if e["cat"] == "kernel":
            seen.add(corr)
            if any(n in e.get("name", "") for n in names):
                kernel_iv.append(iv)
    if not intervals:
        raise RuntimeError("no device events in the trace")
    if issued - seen:
        raise RuntimeError(f"the trace misses {len(issued - seen)} of the {len(issued)} kernel "
                           "launches the host issued")
    busy = _union(intervals) / 1e6
    kernel = _union(kernel_iv) / 1e6 if kernel_iv else 0.0
    return {
        "wall_s": wall,
        "device_busy_s": busy,
        "kernel_s": kernel,
        "device_busy_frac": busy / max(wall, 1e-12),
        "kernel_frac": kernel / max(wall, 1e-12),
        "kernels_seen": len(seen),
        "launches_issued": len(issued),
    }


def launch_counters():
    """The port's kernel wrappers by name, each counting its launches in
    ``.launches``: K1 (its trace kernel), film_splat, K6 (K3's trace kernel
    too), K5, K4, K10 (its deposit mode, the acquisition's, and its
    records mode), the DAS kernel, its packing pass and its adjoint, K9,
    K7.  K2's loop, around K1, is counted by
    ``film_trace.regen_launches``."""
    from tpu_rt_torch.ops import mesh_kernel, path_kernel, us_kernel
    from tpu_rt_torch.us import beamform

    return {"path_film": path_kernel.film_trace,
            "film_splat": path_kernel.film_splat,
            "stokes_sample": path_kernel.stokes_sample_trace,
            "raygen_sample": path_kernel.raygen_trace,
            "rays_sample": path_kernel.path_trace,
            "us_acq": us_kernel.us_trace_rf,
            "us_acq_records": us_kernel.us_trace,
            "us_das": beamform.das_beamform,
            "us_das_pack": beamform.das_pack,
            "us_das_adjoint": beamform.das_adjoint,
            "mesh_direct": mesh_kernel.direct_trace,
            "mesh_isect": mesh_kernel.mesh_intersect}


def reset_launch_counts():
    """Set every kernel wrapper's launch count to 0."""
    from tpu_rt_torch.ops import path_kernel

    for fn in launch_counters().values():
        fn.launches = 0
    path_kernel.film_trace.regen_launches = 0


def launch_counts():
    """Every kernel wrapper's launch count, and ``regen``: K2's loop's
    (around K1)."""
    from tpu_rt_torch.ops import path_kernel

    counts = {k: fn.launches for k, fn in launch_counters().items()}
    counts["regen"] = path_kernel.film_trace.regen_launches
    return counts
