"""The port's named spans in a cell's traced window, and the device's idle
time inside them, on the card.

    python3 portbench/spans.py --workload <name> --seed <n> --seconds 12
    python3 portbench/spans.py --cost

Sets the cell up as ``harness.run`` does, profiles a closed-loop window of
calls (``harness.window``) with ``devtrace.Recorder``, and prints one JSON
line, each figure a call of the window:

* ``host_ms``: the outermost ``tpu_rt_torch.`` spans' duration, the host's
  time from the call's entry to its return;
* ``glue_idle_ms``: the device's idle time (``yardstick.gaps`` of the
  device's intervals over the window) that falls inside those spans, the
  idle the program leaves inside a call; ``loop_idle_ms``: the rest of the
  idle, which the closed loop leaves between calls;
* ``stages``: each span below the outermost, its count, host ms and the
  device's idle ms inside it; ``(self)``, the idle inside the outermost
  span but in none of its stages;
* ``launches``: the port's kernel launches in the window, how many of
  their launch calls lie inside an outermost span, how many of the kernels
  start no earlier than their launch call (by correlation id), and the
  largest lead of a kernel over its launch call.

The trace's device times drift against its host times (by up to 1.7 ms
in a 12 s window on the H100; PERF.md §5), so a kernel can appear to
start before its launch call.  The line's ``split`` therefore reads the
device's intervals anchored to the host's clock (``anchor``): each call's
device events are
shifted by the least lag between a device event of the call and its API
call, which is the device starting work the moment the host issued it,
give or take the launch latency (a few us).  ``raw_split`` is the same
arithmetic on the trace's own device times; ``clock`` gives the
per-call shifts.

The benchmark's own runs do not run this: its ``devtrace.Context`` keeps
no span and no correlation of a device interval, so no per-layer metric
reads these figures.  ``--cost`` times a span with no profiler recording
and with one, in this process.
"""

import argparse
import bisect
import json
import os
import sys
import time

import devtrace
import yardstick

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PREFIX = "tpu_rt_torch."


def trace_spans(events, w0, w1):
    """(start, end, name) of every user annotation in the window [w0, w1]
    but the window's own, in the trace's microseconds.  The device's
    mirror of each range (``gpu_user_annotation``) is left out."""
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "user_annotation":
            continue
        if e.get("name") == devtrace.WINDOW:
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


def overlap(a, b):
    """The length of the intersection of two sets of (start, end, ...)
    intervals, each set disjoint within itself."""
    a, b = sorted(iv[:2] for iv in a), sorted(iv[:2] for iv in b)
    tot, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def _disjoint(intervals):
    """The union of (start, end, ...) intervals as disjoint (start, end)."""
    out = []
    for s, e in sorted(iv[:2] for iv in intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def anchor(events, spans, w0, w1):
    """The device's kernel, copy and memset intervals in the window
    [w0, w1] on the host's clock, and each call's shift (us).  A device
    event belongs to the call whose outermost span holds its API call (by
    correlation id); a call's shift is the least (device start - API call)
    over its events.  Raises where an API call in the window lies in no
    call, or a call has no device event, as neither can be anchored."""
    outer = outermost(spans)
    starts = [s for s, _, _ in outer]
    api, dev = {}, []
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("ph") != "X" or corr is None:
            continue
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            api[corr] = float(e["ts"])
        elif e.get("cat") in devtrace.DEVICE_CATS:
            dev.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), corr))
    shift, owned = [None] * len(outer), []
    for ts, te, corr in dev:
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


def split(ctx, spans, dev=None):
    """The host's time and the device's idle time a call, inside and
    outside the program's spans (ms), from a window's ``devtrace.Context``
    and its ``spans`` (``trace_spans``); the device's (start, end, ...)
    intervals are ``dev`` (``anchor``'s), else the trace's own
    (``ctx.dev``).  None where the window holds no program span; raises
    where the outermost spans do not number the window's calls, as a call
    the program did not mark is a broken trace."""
    outer = outermost(spans)
    if not outer:
        return None
    if len(outer) != ctx.calls:
        raise RuntimeError(f"{len(outer)} outermost program spans in a window of "
                           f"{ctx.calls} calls")
    n = ctx.calls
    gaps = yardstick.gaps([iv[:2] for iv in (ctx.dev if dev is None else dev)], ctx.w0, ctx.w1)
    idle = sum(e - s for s, e in gaps)
    glue = overlap(gaps, outer)
    calls = set(outer)
    inner = [sp for sp in spans if sp[2].startswith(PREFIX) and sp not in calls]
    stages = {}
    for nm in sorted({sp[2] for sp in inner}):
        mine = [sp for sp in inner if sp[2] == nm]
        stages[nm] = {"count": len(mine) / n,
                      "host_ms": sum(e - s for s, e, _ in mine) / n / 1e3,
                      "idle_ms": overlap(gaps, _disjoint(mine)) / n / 1e3}
    stages["(self)"] = {"idle_ms": (glue - overlap(gaps, _disjoint(inner))) / n / 1e3}
    return {"calls": n, "host_ms": sum(e - s for s, e, _ in outer) / n / 1e3,
            "glue_idle_ms": glue / n / 1e3, "loop_idle_ms": (idle - glue) / n / 1e3,
            "idle_ms": idle / n / 1e3,
            "device_idle_pct": 100.0 * idle / (ctx.w1 - ctx.w0), "stages": stages}


def launch_check(events, spans, w0, w1):
    """The port's kernel launches in the window: how many there are, how
    many of their launch calls lie inside an outermost program span, how
    many of their kernels start no earlier than the launch call on the
    trace's own times, and the largest lead of a kernel over its call."""
    names = set().union(*(devtrace.kernel_names(f) for f in os.listdir(devtrace.CSRC)
                          if f.endswith(".cu")))
    kernels = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("ph") == "X" and e.get("cat") == "kernel" and corr is not None:
            if any(n in e.get("name", "") for n in names):
                kernels[corr] = float(e["ts"])
    outer = outermost(spans)
    starts = [s for s, _, _ in outer]
    port = inside = after = 0
    lead = 0.0
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if (e.get("ph") != "X" or e.get("cat") not in ("cuda_runtime", "cuda_driver")
                or "LaunchKernel" not in e.get("name", "") or corr not in kernels):
            continue
        ts = float(e["ts"])
        if not w0 <= ts <= w1:
            continue
        port += 1
        k = bisect.bisect_right(starts, ts) - 1
        inside += k >= 0 and ts + float(e.get("dur", 0.0)) <= outer[k][1]
        after += kernels[corr] >= ts
        lead = max(lead, ts - kernels[corr])
    return {"port_launches": port, "inside_a_call": inside, "kernel_after_launch": after,
            "max_lead_us": lead}


def span_cost(n=100_000):
    """Microseconds a ``with span(...)`` block costs the host, with no
    profiler recording and under the profiler of a traced run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_rt_torch.utils.profiling import span

    def loop():
        t0 = time.perf_counter()
        for _ in range(n):
            with span("tpu_rt_torch.cost"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    loop()
    off = loop()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    with profile(activities=acts):
        on = loop()
    return {"off_us": off, "on_us": on}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=9_000_000_011)
    p.add_argument("--seconds", type=float, default=12.0)
    p.add_argument("--cost", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, HERE)
    import torch

    import harness

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = {"device": torch.cuda.get_device_name(0)}
    if args.cost:
        print(json.dumps({**span_cost(), **dev}))
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl, cfg, trf, ref = harness.find_cell(harness.load_bench(), args.workload)
    entry = harness.driver(trf["kind"]).Entry(cfg, trf, ref, "cuda")
    entry.call(harness.call_seed(args.seed, -1))
    torch.cuda.synchronize()
    rec = devtrace.Recorder("cuda")
    with rec:
        lat, _, _ = harness.window(entry, args.seed, args.seconds, "cuda", 0)
    ctx = rec.context(len(lat), entry.shapes, None)
    spans = trace_spans(rec.events, ctx.w0, ctx.w1)
    anchored, shift = anchor(rec.events, spans, ctx.w0, ctx.w1)
    steps = [abs(b - a) for a, b in zip(shift, shift[1:])]
    out = {"workload": args.workload, "seed": args.seed, **dev,
           "split": split(ctx, spans, anchored), "raw_split": split(ctx, spans),
           "launches": launch_check(rec.events, spans, ctx.w0, ctx.w1),
           "clock": {"shift_us_min": min(shift), "shift_us_max": max(shift),
                     "step_us_max": max(steps, default=0.0)}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
