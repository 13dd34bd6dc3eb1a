"""The benchmark's arithmetic: the card's published peaks, least-time
bounds, the layers' least work from the cells' shapes, the union of device
intervals, their gaps and overlaps, the percentiles of latencies and the
comparison with the reference.

The operation counts a test (a prim test, a DAS tap, a filter weight) are
read off the port's CUDA sources and fixed here, so the yardstick reads the
same work whatever implements a layer.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12  # FLOP/s
PEAK_BYTES = 3.35e12  # B/s

# FP32 operations a test: the cheapest prim test (a sphere's or a
# rectangle's, about 20), so a count of prim tests is a lower bound
OPS_PRIM = 20
# The DAS's least work: t_rx once a (pixel, element) (7); a tap the
# delay's sum, offset and fs (3), the floor and weight (2), 1 - w, the two
# products and their sum (4), the accumulation (1); a (pixel, angle) t_tx
# (4) and the angle's sum added (1)
OPS_DAS_RX, OPS_DAS_TAP, OPS_DAS_ANGLE = 7, 10, 5
# A 1-D filter weight: x = (d + 0.5) - j, the tent's |x|, sub and max, or
# the gaussian's two multiplies, exp, sub, |x|, compare and select
OPS_W1D = 8


def bound_s(ops, nbytes):
    """(least seconds, what bounds it) for ``ops`` FP32 operations and
    ``nbytes`` bytes moved."""
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def splat_work(n_pix, spp, radius, n_val=4):
    """FP32 operations of the filter splat of ``spp`` samples a pixel: per
    sample, box: the values' adds, the weight and the ray count; tent and
    gaussian: per offset a multiply-add a value, the weight's add and the
    two multiplies of w = wy wx ok, plus 2 (2R + 1) 1-D weights and the ray
    count."""
    nv = n_val - 1
    per = nv + 2 if radius == 0 else ((2 * radius + 1) ** 2 * (2 * nv + 3)
                                      + 2 * (2 * radius + 1) * OPS_W1D + 1)
    return n_pix * spp * per


def film_work(n_pix, spp, n_prims, radius, launches, n_val=4):
    """(operations, bytes) of one image through the film kernels, a lower
    bound from the shapes: every primary ray tests every prim once, every
    sample is splatted; each launch's prim records (20 floats a prim) in,
    and its planes (the weighted values and the weight of every filter
    offset, and the ray count) out."""
    ops = n_pix * spp * n_prims * OPS_PRIM + splat_work(n_pix, spp, radius, n_val)
    planes = ((2 * radius + 1) ** 2 * n_val + 1) * n_pix
    return ops, 4 * launches * (20 * n_prims + planes)


def das_work(A, E, T, nx, nz):
    """(operations, bytes) of one delay-and-sum image: the least work
    (OPS_DAS_RX a (pixel, element), OPS_DAS_TAP a tap, OPS_DAS_ANGLE a
    (pixel, angle)); the RF, grids, element positions and angles in, the
    image out."""
    n_pix = nx * nz
    ops = n_pix * (E * OPS_DAS_RX + A * E * OPS_DAS_TAP + A * OPS_DAS_ANGLE)
    return ops, 4 * (A * E * T + nx + nz + 2 * E + 2 * A + n_pix)


def acq_work(A, E, n_prims, sweeps, taps, table_floats):
    """(operations, bytes) of one acquisition through K10 with its deposit:
    every sweep (a bounce's closest hit, a hit's echo occlusion test) tests
    every prim; the pair rays (7 floats) and tables in, and 8 bytes (an
    atomic's read and write) for each tap of an echo that lands in the
    record.  ``sweeps`` and ``taps`` are the reference's counts."""
    return sweeps * n_prims * OPS_PRIM, 4 * (7 * A * E + table_floats) + 8 * taps


def union_s(intervals):
    """The length of the union of (start, end) intervals, in their unit."""
    if not intervals:
        return 0.0
    iv = sorted(intervals)
    tot = 0.0
    cur_s, cur_e = iv[0]
    for s_, e_ in iv[1:]:
        if s_ > cur_e:
            tot += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    return tot + (cur_e - cur_s)


def gaps(intervals, start, end):
    """The idle (start, end) gaps of [start, end] between the intervals."""
    out, cur = [], start
    for s_, e_ in sorted(intervals):
        if s_ > cur:
            out.append((cur, min(s_, end)))
        cur = max(cur, e_)
        if cur >= end:
            break
    if cur < end:
        out.append((cur, end))
    return [(s_, e_) for s_, e_ in out if e_ > s_]


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


def disjoint(intervals):
    """The union of (start, end, ...) intervals as disjoint (start, end)."""
    out = []
    for s, e in sorted(iv[:2] for iv in intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def percentile(values, q):
    """The q-th percentile of every value, linearly interpolated between
    order statistics (numpy's default)."""
    if not values:
        raise ValueError("no values")
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def rel_max(got, want):
    """The comparison that decides ``correct``: the largest |got - want|
    over the largest |want|."""
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / max(scale, 1e-30)
