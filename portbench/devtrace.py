"""The device's timeline of a traced window, from ``torch.profiler``.

``Recorder`` profiles the window (host operators and the device's
kernels, copies and memsets) inside a ``portbench.window`` range, writes
the Chrome trace to a temporary file, reads it back and deletes it.
``Context`` is what the per-layer metric readers see: the window's length,
the device's busy time (the union of its intervals), each layer's device
time (the union of the intervals of the kernels that the layer's CUDA
sources declare), the kernel launches the host issued, the calls the
window completed, the cell's shapes and the reference's work counts.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict

import torch

import yardstick

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tpu_rt_torch", "ops", "csrc")
KERNEL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?"
                    r"(\w+)\s*\(")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"


def kernel_names(source):
    """The ``__global__`` functions a CUDA source of the port declares."""
    with open(os.path.join(CSRC, source)) as f:
        return set(KERNEL.findall(f.read()))


class Recorder:
    def __init__(self, device):
        self.device = device
        self.events = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.rf = record_function(WINDOW)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self.prof.export_chrome_trace(path)
                with open(path) as f:
                    self.events = json.load(f).get("traceEvents", [])
            finally:
                os.unlink(path)
        del self.prof
        return False

    def context(self, calls, shapes, counts):
        return Context(self.events, calls, shapes, counts)


class Context:
    def __init__(self, events, calls, shapes, counts):
        self.calls, self.shapes, self.counts = calls, shapes, counts
        xs = [e for e in events if e.get("ph") == "X"]
        win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace holds no window range")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window_s = (w1 - w0) / 1e6
        self.w0, self.w1 = w0, w1
        dev, issued, seen, host = [], set(), set(), []
        for e in xs:
            ts = float(e.get("ts", 0.0))
            te = ts + float(e.get("dur", 0.0))
            corr = e.get("args", {}).get("correlation")
            cat = e.get("cat")
            if cat in ("cuda_runtime", "cuda_driver"):
                if "LaunchKernel" in e.get("name", "") and corr is not None and w0 <= ts <= w1:
                    issued.add(corr)
                host.append((ts, te, e.get("name", "")))
            elif cat == "cpu_op":
                host.append((ts, te, e.get("name", "")))
            if cat not in DEVICE_CATS:
                continue
            if cat == "kernel" and corr is not None:
                seen.add(corr)
            s_, e_ = max(ts, w0), min(te, w1)
            if e_ > s_:
                dev.append((s_, e_, e.get("name", "")))
        if issued - seen:
            raise RuntimeError(f"the trace misses {len(issued - seen)} of the {len(issued)} "
                               "kernel launches the host issued")
        if not dev:
            raise RuntimeError("no device events in the traced window")
        self.dev, self.host = dev, host
        self.launches = len(issued)
        self.busy_s = yardstick.union_s([(s, e) for s, e, _ in dev]) / 1e6

    def layer_s(self, sources):
        """Device seconds of the kernels the port's CUDA ``sources``
        declare (the union of their intervals in the window)."""
        names = set().union(*(kernel_names(s) for s in sources))
        pats = [re.compile(r"\b" + re.escape(n) + r"\b") for n in names]
        return yardstick.union_s([(s, e) for s, e, nm in self.dev
                                  if any(p.search(nm) for p in pats)]) / 1e6

    def breakdown(self):
        """The ten device operations that took most time, and the ten host
        activities under which the device sat idle longest (seconds)."""
        ops = defaultdict(float)
        for s, e, nm in self.dev:
            ops[nm[:160]] += (e - s) / 1e6
        idle = defaultdict(float)
        host = sorted(h for h in self.host if h[2] != WINDOW)
        starts = [h[0] for h in host]
        longest = max((e - s for s, e, _ in host), default=0.0)
        for g0, g1 in yardstick.gaps([(s, e) for s, e, _ in self.dev], self.w0, self.w1):
            if g1 - g0 < 5.0:
                idle["gaps under 5 us"] += (g1 - g0) / 1e6
                continue
            best, label = 0.0, "host: no operator"
            k = bisect.bisect_left(starts, g1) - 1
            while k >= 0 and host[k][0] >= g0 - longest:
                s, e, nm = host[k]
                ov = min(e, g1) - max(s, g0)
                if ov > best:
                    best, label = ov, nm[:160]
                k -= 1
            idle[label] += (g1 - g0) / 1e6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}
