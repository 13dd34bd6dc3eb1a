"""Host-side BVH construction (binned SAH).

Counterpart of ``tpu_rt/geometry/bvh.py``.  The tree is built by
``ops/native/bvh_builder.cpp``, a copy of tpu_rt's native builder, compiled
with g++ at first use (``ops/_build.host_library``) and called through
ctypes.  The mesh cluster tables are cut from this tree (treelets over
``prim_order``), so the port builds the very tree tpu_rt builds; a failed
build raises.  The numpy form below is tpu_rt's numpy builder, reached only
with ``use_native=False``; a test holds the two to the same tree.

Node layout: internal nodes store child indices in (a, b) with count == 0;
leaves store (first, _, count) indexing the ``prim_order`` permutation.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

LEAF_SIZE = 4
N_BINS = 16


@functools.cache
def _native():
    from tpu_rt_torch.ops import _build

    lib = ctypes.CDLL(str(_build.host_library("bvh_builder.cpp")))
    p = ctypes.c_void_p
    lib.tpu_rt_build_bvh.argtypes = [p, p, ctypes.c_int, p, p, p, p, p, p, ctypes.c_int]
    lib.tpu_rt_build_bvh.restype = ctypes.c_int
    return lib


def _empty():
    return {
        "node_min": np.zeros((1, 3), np.float32),
        "node_max": np.zeros((1, 3), np.float32),
        "a": np.zeros(1, np.int32),
        "b": np.zeros(1, np.int32),
        "count": np.zeros(1, np.int32),
        "prim_order": np.zeros(0, np.int32),
    }


def _build_native(bb_min, bb_max):
    n = int(bb_min.shape[0])
    bb_min = np.ascontiguousarray(bb_min, np.float32)
    bb_max = np.ascontiguousarray(bb_max, np.float32)
    max_nodes = 2 * n + 2
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    node_a = np.empty(max_nodes, np.int32)
    node_b = np.empty(max_nodes, np.int32)
    node_count = np.empty(max_nodes, np.int32)
    prim_order = np.empty(n, np.int32)
    n_nodes = _native().tpu_rt_build_bvh(
        bb_min.ctypes.data, bb_max.ctypes.data, n,
        node_min.ctypes.data, node_max.ctypes.data,
        node_a.ctypes.data, node_b.ctypes.data, node_count.ctypes.data,
        prim_order.ctypes.data, max_nodes)
    if n_nodes <= 0:
        raise RuntimeError(f"native BVH build failed ({n_nodes}) on {n} prims")
    return {
        "node_min": node_min[:n_nodes].copy(),
        "node_max": node_max[:n_nodes].copy(),
        "a": node_a[:n_nodes].copy(),
        "b": node_b[:n_nodes].copy(),
        "count": node_count[:n_nodes].copy(),
        "prim_order": prim_order,
    }


def build_bvh(bb_min, bb_max, use_native=True):
    """SAH-binned BVH over primitive AABBs ``bb_min``, ``bb_max`` [P, 3]
    float32.  Returns a dict of node_min [M, 3], node_max [M, 3], a [M],
    b [M], count [M] and prim_order [P] (int32)."""
    P = bb_min.shape[0]
    if P == 0:
        return _empty()
    if use_native:
        return _build_native(bb_min, bb_max)
    centroid = 0.5 * (bb_min + bb_max)
    order = np.arange(P, dtype=np.int32)

    node_min, node_max, node_a, node_b, node_count = [], [], [], [], []

    def alloc():
        node_min.append(None)
        node_max.append(None)
        node_a.append(0)
        node_b.append(0)
        node_count.append(0)
        return len(node_min) - 1

    root = alloc()
    stack = [(root, 0, P)]  # (node index, start, end) over `order`
    while stack:
        ni, s, e = stack.pop()
        idx = order[s:e]
        node_min[ni] = bb_min[idx].min(axis=0)
        node_max[ni] = bb_max[idx].max(axis=0)
        n = e - s
        if n <= LEAF_SIZE:
            node_a[ni], node_count[ni] = s, n
            continue

        c = centroid[idx]
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        extent = cmax - cmin
        axis = int(np.argmax(extent))
        if extent[axis] < 1e-12:  # all centroids coincide -> leaf
            node_a[ni], node_count[ni] = s, n
            continue

        # Binned SAH along the widest axis.
        rel = (c[:, axis] - cmin[axis]) / extent[axis]
        bins = np.minimum((rel * N_BINS).astype(np.int32), N_BINS - 1)
        counts = np.bincount(bins, minlength=N_BINS)
        bmin = np.full((N_BINS, 3), np.inf, np.float32)
        bmax = np.full((N_BINS, 3), -np.inf, np.float32)
        for k in range(3):
            np.minimum.at(bmin[:, k], bins, bb_min[idx, k])
            np.maximum.at(bmax[:, k], bins, bb_max[idx, k])

        def grow_area(mins, maxs, counts_):
            cum_min = np.minimum.accumulate(mins, axis=0)
            cum_max = np.maximum.accumulate(maxs, axis=0)
            d = np.maximum(cum_max - cum_min, 0.0)
            area = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
            return area, np.cumsum(counts_)

        area_l, cnt_l = grow_area(bmin, bmax, counts)
        area_r_rev, cnt_r_rev = grow_area(bmin[::-1], bmax[::-1], counts[::-1])
        area_r = area_r_rev[::-1]
        cnt_r = cnt_r_rev[::-1]

        # split after bin k: left = bins [0..k], right = [k+1..]
        cost = area_l[:-1] * cnt_l[:-1] + area_r[1:] * cnt_r[1:]
        cost = np.where((cnt_l[:-1] == 0) | (cnt_r[1:] == 0), np.inf, cost)
        k = int(np.argmin(cost))
        if not np.isfinite(cost[k]):  # degenerate, median split
            mid = s + n // 2
            part = np.argsort(c[:, axis], kind="stable").astype(np.int32)
            order[s:e] = idx[part]
        else:
            left_mask = bins <= k
            order[s:e] = np.concatenate([idx[left_mask], idx[~left_mask]])
            mid = s + int(left_mask.sum())
        if mid == s or mid == e:
            mid = s + n // 2

        li, ri = alloc(), alloc()
        node_a[ni], node_b[ni], node_count[ni] = li, ri, 0
        stack.append((li, s, mid))
        stack.append((ri, mid, e))

    return {
        "node_min": np.asarray(node_min, np.float32),
        "node_max": np.asarray(node_max, np.float32),
        "a": np.asarray(node_a, np.int32),
        "b": np.asarray(node_b, np.int32),
        "count": np.asarray(node_count, np.int32),
        "prim_order": order,
    }
