"""The yardstick's arithmetic against counts made by hand at tiny shapes."""

import bisect
import re
import statistics
from collections import defaultdict

import pytest

import devtrace
import harness
import yardstick
import yardstick as ys
from devtrace import DEVICE_CATS, WINDOW, kernel_names


def test_das_least_work_by_hand():
    # 2 angles, 3 elements, 5 samples, a 4 x 2 grid: 8 pixels, 48 taps
    A, E, T, nx, nz = 2, 3, 5, 4, 2
    ops, nbytes = ys.das_work(A, E, T, nx, nz)
    taps = nx * nz * E * A
    assert taps == 48
    assert ops == 48 * 10 + 8 * 3 * 7 + 8 * 2 * 5
    assert nbytes == 4 * (30 + 4 + 2 + 6 + 4 + 8)


def test_film_lower_bound_by_hand():
    # 2 x 2 pixels, 3 samples, 5 prims, tent (9 offsets), one launch
    ops, nbytes = ys.film_work(4, 3, 5, 1, 1)
    per_sample = 9 * (2 * 3 + 3) + 2 * 3 * 8 + 1  # 130
    assert ops == 4 * 3 * 5 * 20 + 4 * 3 * per_sample
    assert nbytes == 4 * (20 * 5 + (9 * 4 + 1) * 4)
    # box: the values, the weight and the ray count a sample
    assert ys.splat_work(4, 3, 0) == 4 * 3 * 5


def test_acq_bytes_by_hand():
    ops, nbytes = ys.acq_work(A=2, E=3, n_prims=2, sweeps=10, taps=7, table_floats=40)
    assert ops == 10 * 2 * 20
    assert nbytes == 4 * (7 * 6 + 40) + 8 * 7


def test_bound_takes_the_larger():
    t, by = ys.bound_s(67e12, 1.0)
    assert t == pytest.approx(1.0) and by == "operations"
    t, by = ys.bound_s(1.0, 3.35e12 * 2)
    assert t == pytest.approx(2.0) and by == "bytes"


def test_union_of_overlapping_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (10, 10)]
    assert ys.union_s(iv) == 4.0
    assert ys.union_s([]) == 0.0
    assert ys.gaps(iv, 0, 8) == [(3, 5), (6, 8)]


def test_p95_over_every_sample():
    """A stall in one chunk shows in the p95 of all samples, and vanishes
    in the median of chunk medians or in their p95."""
    lat = [1.0] * 90 + [10.0] * 10
    chunks = [lat[i:i + 10] for i in range(0, 100, 10)]
    p95 = ys.percentile(lat, 95)
    assert p95 == 10.0
    assert statistics.median(statistics.median(c) for c in chunks) == 1.0
    assert ys.percentile([statistics.median(c) for c in chunks], 95) < p95
    assert ys.percentile([3.0, 1.0, 2.0], 50) == 2.0


def test_trace_context_by_hand():
    """Busy time, a layer's time, launches and the window from a
    hand-made Chrome trace."""
    win = {"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW, "ts": 100, "dur": 100}
    evs = [win,
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 101, "dur": 1,
            "args": {"correlation": 1}},
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 103, "dur": 1,
            "args": {"correlation": 2}},
           {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::us_das_kernel<8>()",
            "ts": 110, "dur": 40, "args": {"correlation": 1}},
           {"ph": "X", "cat": "kernel", "name": "void at::native::fill()", "ts": 140, "dur": 20,
            "args": {"correlation": 2}},
           {"ph": "X", "cat": "cpu_op", "name": "aten::zeros", "ts": 160, "dur": 30}]
    ctx = devtrace.Context(evs, 2, {"kind": "us_frame"}, None)
    assert ctx.window_s == pytest.approx(100e-6)
    assert ctx.busy_s == pytest.approx(50e-6)
    assert ctx.layer_s(["us_das.cu"]) == pytest.approx(40e-6)
    assert ctx.launches == 2
    bd = ctx.breakdown()
    assert bd["idle_gaps"][0][0] == "aten::zeros"
    missed = evs[:3] + evs[4:]
    with pytest.raises(RuntimeError, match="misses 1"):
        devtrace.Context(missed, 2, {}, None)


# every per-layer metric that BENCHMARK.json had before the span metrics
EXISTING = ["film.roofline", "launches.image", "device_idle.image", "das.roofline",
            "acq.roofline", "launches.frame", "device_idle.frame"]


class OldContext:
    """devtrace.Context as it was before it kept spans and correlation ids,
    frozen: the existing readers must read the same through the new one."""

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


def _mixed_trace():
    """Two calls of every layer's kernels, a copy and a memset, runtime and
    driver launch calls, a launch before the window and a kernel running
    past its end, the program's spans and their device mirrors."""
    def x(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    evs = [x("user_annotation", WINDOW, 1000, 2000),
           x("cuda_runtime", "cudaLaunchKernel", 990, 4, 1),
           x("kernel", "void at::native::fill()", 995, 20, 1)]
    for c, t0 in enumerate((1010, 2000)):
        k = 10 * (c + 1)
        evs += [x("user_annotation", "tpu_rt_torch.render", t0, 900),
                x("user_annotation", "tpu_rt_torch.film_trace", t0 + 50, 300),
                x("gpu_user_annotation", "tpu_rt_torch.film_trace", t0 + 70, 400),
                x("cpu_op", "aten::zeros", t0 + 5, 40),
                x("cuda_runtime", "cudaMemsetAsync", t0 + 10, 3, k + 1),
                x("gpu_memset", "Memset (Device)", t0 + 20, 6, k + 1),
                x("cuda_runtime", "cudaLaunchKernel", t0 + 60, 5, k + 2),
                x("kernel", "void (anonymous namespace)::path_film_kernel<false, false, false>()",
                  t0 + 70, 250, k + 2),
                x("cuda_driver", "cuLaunchKernel", t0 + 80, 5, k + 3),
                x("kernel", "void (anonymous namespace)::film_splat_kernel<1, 3>()", t0 + 320, 30,
                  k + 3),
                x("cuda_runtime", "cudaLaunchKernel", t0 + 400, 5, k + 4),
                x("kernel", "(anonymous namespace)::us_das_pack_kernel(float const*, int)",
                  t0 + 410, 40, k + 4),
                x("cuda_runtime", "cudaLaunchKernel", t0 + 420, 5, k + 5),
                x("kernel", "void (anonymous namespace)::us_das_kernel<8>(float2 const*)",
                  t0 + 455, 300, k + 5),
                x("cuda_runtime", "cudaLaunchKernel", t0 + 430, 5, k + 6),
                x("kernel", "void (anonymous namespace)::us_acq_kernel<1>(int const*)", t0 + 760,
                  60 + 200 * c, k + 6),
                x("cuda_runtime", "cudaMemcpyAsync", t0 + 500, 5, k + 7),
                x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", t0 + 825, 8, k + 7),
                x("cpu_op", "aten::to", t0 + 495, 300)]
    return evs


def test_existing_readers_read_as_before():
    """Every per-layer metric that was there before the spans reads the same
    value through the new Context as through the frozen old one, and the
    window, busy time, launches, layers and breakdown agree exactly."""
    evs = _mixed_trace()
    shapes = dict(W=4, H=4, spp=8, n_prims=12, radius=1, launches=2, A=3, E=16, T=400, nx=5,
                  nz=7)
    counts = dict(closest=900, any=700, taps=1200)
    new, old = devtrace.Context(evs, 2, shapes, counts), OldContext(evs, 2, shapes, counts)
    assert new.spans and new.launches == 10
    for m in EXISTING:
        read = harness.metric_reader(m).read
        assert read(new) == read(old) and read(new) > 0, m
    assert (new.window_s, new.busy_s, new.launches) == (old.window_s, old.busy_s, old.launches)
    for src in ("path_film.cu", "us_das.cu", "us_acq.cu"):
        assert new.layer_s([src]) == old.layer_s([src]) > 0
    assert new.breakdown() == old.breakdown()
