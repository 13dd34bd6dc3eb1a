"""The program's spans in a traced window (``devtrace.Context``'s spans,
``devtrace.split`` and ``anchor``, ``portbench/spans.py``): the split of
the device's idle time between the calls and the loop, and the per-layer
metrics that read it, on a hand-made Chrome trace; on the card, each
cell's window with every launch of the port's kernels inside a call's span
and each kernel after its launch call.

    python -m pytest portbench/tests/test_portbench_spans.py -q

(the card's tests skip without an NVIDIA GPU)."""

import json
import os
import subprocess
import sys

import pytest

from portbench_tiny import BENCH_DIR, ROOT, bench_cells

import devtrace
import harness
import spans as sp
import yardstick


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    """A window [100, 1100] us of two calls.  Call 1, [150, 400]: the
    device idle until 250 (100 us inside the call), its kernel runs on to
    580.  The gap [580, 700] straddles call 2, [600, 900]: 20 us before
    it, 100 inside.  The gaps [100, 150] and [1000, 1100] lie outside
    every call."""
    return [
        _x("user_annotation", devtrace.WINDOW, 100, 1000),
        _x("user_annotation", "tpu_rt_torch.render", 150, 250),
        _x("user_annotation", "tpu_rt_torch.bake_scene", 150, 50),
        _x("user_annotation", "tpu_rt_torch.film_trace", 210, 90),
        _x("gpu_user_annotation", "tpu_rt_torch.film_trace", 250, 330),
        _x("user_annotation", "tpu_rt_torch.render", 600, 300),
        _x("user_annotation", "tpu_rt_torch.bake_scene", 600, 50),
        _x("user_annotation", "tpu_rt_torch.film_trace", 660, 90),
        _x("cuda_runtime", "cudaLaunchKernel", 220, 5, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 240, 5, corr=3),
        _x("cuda_runtime", "cudaLaunchKernel", 670, 5, corr=2),
        _x("kernel", "void (anonymous namespace)::path_film_kernel<false>()", 250, 330, corr=1),
        _x("kernel", "void at::native::fill()", 300, 10, corr=3),
        _x("kernel", "void (anonymous namespace)::path_film_kernel<false>()", 700, 300, corr=2),
        _x("cpu_op", "aten::to", 150, 40),
    ]


def _split(events, calls=2):
    ctx = devtrace.Context(events, calls, {}, None)
    return devtrace.split(ctx), ctx


def test_idle_inside_outside_and_straddling_a_call():
    s, ctx = _split(_trace())
    assert s["calls"] == 2
    assert s["idle_ms"] == pytest.approx((50 + 100 + 120 + 100) / 2 / 1e3)
    assert s["glue_idle_ms"] == pytest.approx((100 + 100) / 2 / 1e3)
    assert s["loop_idle_ms"] == pytest.approx((50 + 20 + 100) / 2 / 1e3)
    assert s["host_ms"] == pytest.approx((250 + 300) / 2 / 1e3)
    assert s["device_idle_pct"] == pytest.approx(100.0 * (1.0 - ctx.busy_s / ctx.window_s))
    st = s["stages"]
    assert st["tpu_rt_torch.bake_scene"] == pytest.approx(
        {"count": 1, "host_ms": 0.05, "idle_ms": 0.05})
    assert st["tpu_rt_torch.film_trace"] == pytest.approx(
        {"count": 1, "host_ms": 0.09, "idle_ms": 0.04})
    # call 1's [200, 210] and call 2's [650, 660] lie in no stage
    assert st["(self)"]["idle_ms"] == pytest.approx(0.01)
    # the device's mirror of a range is no span: it would count twice
    assert "tpu_rt_torch.render" not in st


def test_the_outermost_span_is_the_call():
    nested = [(0, 100, "tpu_rt_torch.render"), (0, 90, "tpu_rt_torch.us_render"),
              (10, 40, "tpu_rt_torch.das_beamform"), (100, 150, "tpu_rt_torch.render"),
              (120, 130, "tpu_rt_torch.develop"), (200, 210, "portbench.other")]
    assert devtrace.outermost(nested) == [(0, 100, "tpu_rt_torch.render"),
                                          (100, 150, "tpu_rt_torch.render")]
    assert yardstick.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert yardstick.disjoint([(5, 25), (0, 10), (30, 40)]) == [(0, 25), (30, 40)]


def test_no_program_span_reads_nothing():
    evs = [e for e in _trace() if not e["name"].startswith("tpu_rt_torch.")]
    assert _split(evs)[0] is None


def test_a_call_without_its_span_is_a_broken_trace():
    with pytest.raises(RuntimeError, match="2 outermost program spans in a window of 3 calls"):
        _split(_trace(), calls=3)


def test_launches_inside_a_call_and_kernels_after_their_launch():
    evs = _trace()
    ctx = devtrace.Context(evs, 2, {}, None)
    spans = ctx.spans
    assert sp.launch_check(evs, spans, ctx.w0, ctx.w1) == {
        "port_launches": 2, "inside_a_call": 2, "kernel_after_launch": 2, "max_lead_us": 0.0}
    late = [dict(e, ts=500) if e.get("args", {}).get("correlation") == 2
            and e["cat"] == "cuda_runtime" else e for e in evs]
    late = [dict(e, ts=699) if e.get("args", {}).get("correlation") == 2
            and e["cat"] == "kernel" else e for e in late]
    assert sp.launch_check(late, spans, ctx.w0, ctx.w1)["inside_a_call"] == 1
    early = [dict(e, ts=600) if e.get("args", {}).get("correlation") == 2
             and e["cat"] == "kernel" else e for e in evs]
    assert sp.launch_check(early, spans, ctx.w0, ctx.w1)["kernel_after_launch"] == 1
    assert sp.launch_check(early, spans, ctx.w0, ctx.w1)["max_lead_us"] == 70


def _flat(d, pre=""):
    """A nested dict of numbers as one flat dict."""
    out = {}
    for k, v in d.items():
        out.update(_flat(v, pre + k + "/") if isinstance(v, dict) else {pre + k: v})
    return out


def test_anchoring_undoes_a_drift_of_the_device_clock():
    """Call 2's device events 300 us early, as a drifting device clock
    shows them: its kernel before its launch call.  Anchored, each call's
    events sit at the least lag of its own launches, so the split is the
    undrifted trace's."""
    evs = _trace()
    drift = [dict(e, ts=e["ts"] - 300) if e["cat"] == "kernel"
             and e["args"]["correlation"] == 2 else e for e in evs]
    got = {}
    for name, trace in (("even", evs), ("drift", drift)):
        ctx = devtrace.Context(trace, 2, {}, None)
        dev, shift = devtrace.anchor(ctx)
        got[name] = devtrace.split(ctx, dev), shift, devtrace.split(ctx)
    assert got["even"][1] == [30, 30] and got["drift"][1] == [30, -270]
    assert _flat(got["drift"][0]) == pytest.approx(_flat(got["even"][0]))
    # on the trace's own times call 2's kernel, [400, 700], hides under
    # call 1's and leaves the device idle through call 2's span
    assert got["even"][2]["glue_idle_ms"] == pytest.approx((100 + 100) / 2 / 1e3)
    assert got["drift"][2]["glue_idle_ms"] == pytest.approx((100 + 200) / 2 / 1e3)
    # anchored, call 1's device starts at its launch call: idle [150, 220]
    # and call 2's at 670: idle [600, 670]
    assert got["even"][0]["glue_idle_ms"] == pytest.approx((70 + 70) / 2 / 1e3)


def test_anchoring_needs_every_device_event_in_a_call():
    evs = _trace()
    outside = [dict(e, ts=450) if e.get("args", {}).get("correlation") == 3
               and e["cat"] == "cuda_runtime" else e for e in evs]
    with pytest.raises(RuntimeError, match="outside every call"):
        devtrace.anchor(devtrace.Context(outside, 2, {}, None))
    idle_call = evs + [_x("user_annotation", "tpu_rt_torch.render", 1010, 50)]
    with pytest.raises(RuntimeError, match="no device event"):
        devtrace.anchor(devtrace.Context(idle_call, 3, {}, None))


# the per-layer metrics that read the anchored split, and their values on
# _trace() by hand: anchored, each call's events sit 30 us after their
# launch calls, so the device is idle in [150, 220] and [600, 670] inside
# the calls (70 us each); the calls' spans last 250 and 300 us
SPAN_METRICS = {"glue_idle.image": (70 + 70) / 2 / 1e3, "host_ms.image": (250 + 300) / 2 / 1e3,
                "glue_idle.frame": (70 + 70) / 2 / 1e3, "host_ms.frame": (250 + 300) / 2 / 1e3}


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_metric_by_hand(metric):
    ctx = devtrace.Context(_trace(), 2, {}, None)
    v = harness.metric_reader(metric).read(ctx)
    assert v == pytest.approx(SPAN_METRICS[metric])
    if metric.startswith("glue_idle."):
        # a part of the window's idle a call (device_idle.* of the window)
        assert 0 < v <= (ctx.window_s - ctx.busy_s) * 1e3 / ctx.calls


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_metric_without_program_spans_reads_nothing(metric):
    evs = [e for e in _trace() if not e["name"].startswith("tpu_rt_torch.")]
    assert harness.metric_reader(metric).read(devtrace.Context(evs, 2, {}, None)) is None


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_metric_fails_a_broken_window(metric):
    """A window whose spans do not number its calls, or that cannot be
    anchored, raises in the reader, which fails the traced run: it is
    never read as a number."""
    read = harness.metric_reader(metric).read
    with pytest.raises(RuntimeError, match="2 outermost program spans in a window of 3"):
        read(devtrace.Context(_trace(), 3, {}, None))
    outside = [dict(e, ts=450) if e.get("args", {}).get("correlation") == 3
               and e["cat"] == "cuda_runtime" else e for e in _trace()]
    with pytest.raises(RuntimeError, match="outside every call"):
        read(devtrace.Context(outside, 2, {}, None))


# each cell's stages and their count a call
STAGES = {"image": {"tpu_rt_torch.bake_scene": 1, "tpu_rt_torch.pack_tables": 1,
                    "tpu_rt_torch.film_trace": 4, "tpu_rt_torch.deposit": 4,
                    "tpu_rt_torch.develop": 1},
          "us_frame": {"tpu_rt_torch.simulate_acquisition": 1, "tpu_rt_torch.das_beamform": 1,
                       "tpu_rt_torch.hilbert_envelope": 1, "tpu_rt_torch.log_compress": 1}}


@pytest.mark.cuda
@pytest.mark.parametrize("wl", bench_cells())
def test_cell_spans_on_the_card(card, wl):
    """Every launch of the port's kernels in a traced window lies inside a
    call's span, and the split of the device's idle time holds each stage
    at its count a call.  Whether each kernel starts after its launch call
    on the trace's own times is reported, not asserted: the trace's device
    clock drifts against its host clock by up to 0.8 ms in a 12 s window
    (PERF.md §5), which ``spans.anchor`` takes out."""
    import harness

    kind = harness.find_cell(harness.load_bench(), wl)[2]["kind"]
    p = subprocess.run([sys.executable, os.path.join(BENCH_DIR, "spans.py"), "--workload", wl,
                        "--seed", "5000000023", "--seconds", "2"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    n = r["launches"]["port_launches"]
    assert n > 0 and r["launches"]["inside_a_call"] == n
    assert 0 <= r["launches"]["kernel_after_launch"] <= n
    s = r["split"]
    assert 0 <= s["glue_idle_ms"] <= s["idle_ms"] and 0 < s["host_ms"]
    assert {k: v["count"] for k, v in s["stages"].items() if k != "(self)"} == STAGES[kind]
