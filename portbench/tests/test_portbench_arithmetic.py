"""The yardstick's arithmetic against counts made by hand at tiny shapes."""

import statistics

import pytest

import devtrace
import yardstick as ys


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
