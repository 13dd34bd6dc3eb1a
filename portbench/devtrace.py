"""The device's timeline of a traced window, from ``torch.profiler``.

``Recorder`` profiles the window (host operators and the device's
kernels, copies and memsets) inside a ``portbench.window`` range, writes
the Chrome trace to a temporary file, reads it back and deletes it.
``Context`` is what the per-layer metric readers see: the window's length,
the device's busy time (the union of its intervals), each layer's device
time (the union of the intervals of the kernels that the layer's CUDA
sources declare), the kernel launches the host issued, the calls the
window completed, the cell's shapes and the reference's work counts, the
program's named spans (``tpu_rt_torch.<function>``) and the correlation
of each device interval with its API call, from which ``anchored_split``
splits the host's time and the device's idle time of a call.

The trace's device times drift against its host times (by up to 1.7 ms
in a 12 s window on the H100), so a kernel can appear to start before its
launch call.  ``anchor`` therefore puts the device's intervals on the
host's clock: each call's device events are shifted by the least lag
between a device event of the call and its API call, which is the device
starting work the moment the host issued it, give or take the launch
latency (a few us).
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
API_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "portbench.window"
PREFIX = "tpu_rt_torch."


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
        api, dev_corr = {}, []
        for e in xs:
            ts = float(e.get("ts", 0.0))
            te = ts + float(e.get("dur", 0.0))
            corr = e.get("args", {}).get("correlation")
            cat = e.get("cat")
            if cat in API_CATS:
                if "LaunchKernel" in e.get("name", "") and corr is not None and w0 <= ts <= w1:
                    issued.add(corr)
                if corr is not None:
                    api[corr] = ts
                host.append((ts, te, e.get("name", "")))
            elif cat == "cpu_op":
                host.append((ts, te, e.get("name", "")))
            if cat not in DEVICE_CATS:
                continue
            if corr is not None:
                dev_corr.append((ts, te, corr))
                if cat == "kernel":
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
        # the program's spans; each API call's start and each device
        # interval's (start, end, correlation id), on the trace's own times
        self.spans = trace_spans(xs, w0, w1)
        self.api, self.dev_corr = api, dev_corr
        self._split = None

    def anchored_split(self):
        """``split`` of the window on the device's intervals anchored to
        the host's clock (``anchor``), worked out once: the host's time and
        the device's idle time a call, inside and outside the program's
        spans.  None where the window holds no program span; raises where
        the window cannot be anchored or its outermost spans do not number
        its calls."""
        if self._split is None and call_spans(self):
            self._split = split(self, anchor(self)[0])
        return self._split

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


def trace_spans(events, w0, w1):
    """(start, end, name) of every user annotation in the window [w0, w1]
    but the window's own, in the trace's microseconds.  The device's
    mirror of each range (``gpu_user_annotation``) is left out."""
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "user_annotation":
            continue
        if e.get("name") == WINDOW:
            continue
        ts = float(e.get("ts", 0.0))
        if w0 <= ts <= w1:
            out.append((ts, ts + float(e.get("dur", 0.0)), e.get("name", "")))
    return out


def outermost(spans, prefix=PREFIX):
    """The ``prefix`` spans that no other ``prefix`` span holds, in order:
    a call's own span, its stages nested inside it."""
    out = []
    for s, e, nm in sorted((sp for sp in spans if sp[2].startswith(prefix)),
                           key=lambda sp: (sp[0], -sp[1])):
        if not out or s >= out[-1][1]:
            out.append((s, e, nm))
    return out


def call_spans(ctx):
    """The window's outermost program spans, one a call; raises where they
    do not number the window's calls, as a call the program did not mark
    is a broken trace."""
    outer = outermost(ctx.spans)
    if outer and len(outer) != ctx.calls:
        raise RuntimeError(f"{len(outer)} outermost program spans in a window of "
                           f"{ctx.calls} calls")
    return outer


def anchor(ctx):
    """The device's kernel, copy and memset intervals in the window on the
    host's clock, and each call's shift (us).  A device event belongs to
    the call whose outermost span holds its API call (by correlation id); a
    call's shift is the least (device start - API call) over its events.
    Raises where an API call in the window lies in no call, or a call has
    no device event, as neither can be anchored."""
    outer = outermost(ctx.spans)
    starts = [s for s, _, _ in outer]
    w0, w1, api = ctx.w0, ctx.w1, ctx.api
    shift, owned = [None] * len(outer), []
    for ts, te, corr in ctx.dev_corr:
        if not w0 <= api.get(corr, -1.0) <= w1:
            continue
        k = bisect.bisect_right(starts, api[corr]) - 1
        if k < 0 or api[corr] > outer[k][1]:
            raise RuntimeError("a device event issued in the window outside every call")
        owned.append((ts, te, k))
        shift[k] = ts - api[corr] if shift[k] is None else min(shift[k], ts - api[corr])
    if None in shift:
        raise RuntimeError("a call with no device event")
    out = [(max(ts - shift[k], w0), min(te - shift[k], w1)) for ts, te, k in owned]
    return [iv for iv in out if iv[1] > iv[0]], shift


def split(ctx, dev=None):
    """The host's time and the device's idle time a call, inside and
    outside the program's spans (ms), from a window's ``Context``; the
    device's (start, end, ...) intervals are ``dev`` (``anchor``'s), else
    the trace's own (``ctx.dev``).  None where the window holds no program
    span; raises as ``call_spans`` does."""
    outer = call_spans(ctx)
    if not outer:
        return None
    n = ctx.calls
    gaps = yardstick.gaps([iv[:2] for iv in (ctx.dev if dev is None else dev)], ctx.w0, ctx.w1)
    idle = sum(e - s for s, e in gaps)
    glue = yardstick.overlap(gaps, outer)
    calls = set(outer)
    inner = [sp for sp in ctx.spans if sp[2].startswith(PREFIX) and sp not in calls]
    stages = {}
    for nm in sorted({sp[2] for sp in inner}):
        mine = [sp for sp in inner if sp[2] == nm]
        stages[nm] = {"count": len(mine) / n,
                      "host_ms": sum(e - s for s, e, _ in mine) / n / 1e3,
                      "idle_ms": yardstick.overlap(gaps, yardstick.disjoint(mine)) / n / 1e3}
    stages["(self)"] = {"idle_ms": (glue - yardstick.overlap(gaps, yardstick.disjoint(inner)))
                        / n / 1e3}
    return {"calls": n, "host_ms": sum(e - s for s, e, _ in outer) / n / 1e3,
            "glue_idle_ms": glue / n / 1e3, "loop_idle_ms": (idle - glue) / n / 1e3,
            "idle_ms": idle / n / 1e3,
            "device_idle_pct": 100.0 * idle / (ctx.w1 - ctx.w0), "stages": stages}
