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
device's intervals anchored to the host's clock (``devtrace.anchor``), as
the per-layer metrics ``glue_idle.*`` and ``host_ms.*`` of a traced run
do (``devtrace.Context.anchored_split``).  ``raw_split`` is the same
arithmetic on the trace's own device times; ``clock`` gives the per-call
shifts.  ``--cost`` times a span with no profiler recording and with one,
in this process.
"""

import argparse
import bisect
import json
import os
import sys
import time

import devtrace
from devtrace import anchor, outermost, split

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


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
        if (e.get("ph") != "X" or e.get("cat") not in devtrace.API_CATS
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
    anchored, shift = anchor(ctx)
    steps = [abs(b - a) for a, b in zip(shift, shift[1:])]
    out = {"workload": args.workload, "seed": args.seed, **dev,
           "split": split(ctx, anchored), "raw_split": split(ctx),
           "launches": launch_check(rec.events, ctx.spans, ctx.w0, ctx.w1),
           "clock": {"shift_us_min": min(shift), "shift_us_max": max(shift),
                     "step_us_max": max(steps, default=0.0)}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
