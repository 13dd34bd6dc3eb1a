"""What the same-process A/B tools (``tools/ab_film.py``,
``tools/ab_isect.py``, ``tools/ab_us.py``) share: a variant's source
directory with constants set, every variant's nvcc started at once with
the package's flags, the package's wrappers pointed at a variant's
library, CUDA-event timing, interleaved timing rounds, ``chip_smoke.py``
loaded as a module (its ptxas reader, its profiler helpers) and the card's
name and power limit.

A variant is named ``NAME=DIR[:CONST=VALUE ...]``: DIR holds the sources
and the ``common.cuh`` they include (the package's own
``tpu_rt_torch/ops/csrc``, or an earlier commit's written into an ignored
directory such as ``build/ab/parent`` by ``git show``); each
``:CONST=VALUE`` builds a copy with the ``constexpr int CONST = ...;`` of
its sources set to VALUE.
"""

import functools
import importlib.util
import os
import re
import shutil
import statistics
import subprocess
from contextlib import contextmanager

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card():
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


@functools.cache
def chip_smoke():
    """``chip_smoke.py`` as a module (nothing of it runs on import)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def variant_dir(name, spec, sources, out_root):
    """The source directory of ``spec`` (``DIR[:CONST=VALUE ...]``): DIR
    itself, or with constants a copy of DIR's ``common.cuh`` and those of
    ``sources`` it holds in ``out_root/NAME``, each constant set; a
    constant must be found exactly once among the sources."""
    d, *consts = spec.split(":")
    if not consts:
        return d
    srcs = {}
    for f in sources:
        if os.path.exists(os.path.join(d, f)):
            with open(os.path.join(d, f)) as fh:
                srcs[f] = fh.read()
    for item in consts:
        const, value = item.split("=", 1)
        found = 0
        for f, src in srcs.items():
            srcs[f], n = re.subn(rf"constexpr int {const} = [^;]+;",
                                 f"constexpr int {const} = {value};", src)
            found += n
        if found != 1:
            raise ValueError(f"variant {name}: constexpr int {const} found {found} times")
    out = os.path.join(out_root, name)
    os.makedirs(out, exist_ok=True)
    shutil.copy(os.path.join(d, "common.cuh"), out)
    for f, src in srcs.items():
        with open(os.path.join(out, f), "w") as fh:
            fh.write(src)
    return out


def nvcc_all(jobs):
    """Run every job ``{key: (output path, nvcc arguments after the
    package's flags)}`` at once; returns ``{key: nvcc's log}`` or raises
    naming the job that failed."""
    from tpu_rt_torch.ops import _build

    nvcc = _build._nvcc()
    procs = {key: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", out, *args],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for key, (out, args) in jobs.items()}
    logs = {}
    for key, p in procs.items():
        logs[key] = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{logs[key]}")
    return logs


def ptxas(name, log):
    """{kernel: [registers, spill stores, spill loads]} of a build's log,
    printed a line a kernel."""
    out = {k: list(v) for k, v in chip_smoke().ptxas_summary(log).items()}
    for k, (regs, st, ld) in out.items():
        print(f"ptxas {name} {k}: {regs} registers, spill stores {st} B, loads {ld} B")
    return out


@contextmanager
def use(lib):
    """The package's wrappers launching ``lib``'s kernels."""
    from tpu_rt_torch.ops import _build

    saved = _build.load_library
    _build.load_library = lambda: lib
    try:
        yield
    finally:
        _build.load_library = saved


def event_ms(fn, n=1):
    """(ms a call, the last output) of n calls of fn, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, out


def equal(name, v, first, got):
    if not torch.equal(got, first):
        raise AssertionError(f"{name}: variant {v} differs from the first")


def timed(res, name, fns, reps, n, check=equal, kernel=None):
    """Two warm-ups each and ``check(name, variant, first, got)`` on every
    variant's output against the first's, then ``reps`` rounds in which
    the variants take turns (CUDA events around n calls; with ``kernel``,
    also that kernel's own device time a launch by torch.profiler,
    ``chip_smoke.kernel_device_ms``); the median per variant into
    ``res[name]``.  Returns the first variant's output."""
    first = None
    for v, fn in fns.items():
        fn()
        got = fn()
        torch.cuda.synchronize()
        if first is None:
            first = got
        else:
            check(name, v, first, got)
    times = {v: [] for v in fns}
    dev = {v: [] for v in fns}
    for _ in range(reps):
        for v, fn in fns.items():
            times[v].append(event_ms(fn, n)[0])
            if kernel:
                dev[v].append(chip_smoke().kernel_device_ms(fn, kernel, n)[0])
    res[name] = {v: {"ms": statistics.median(t), "all_ms": t} for v, t in times.items()}
    if kernel:
        for v, t in dev.items():
            res[name][v].update(kernel_ms=statistics.median(t), all_kernel_ms=t)
    print(f"{name}: " + ", ".join(
        f"{v} {r['ms']:.5f} ms a call" + (f" (kernel {r['kernel_ms']:.5f} ms)" if kernel else "")
        for v, r in res[name].items()), flush=True)
    return first
