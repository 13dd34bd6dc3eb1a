"""Mesh cluster tables, the clustered mesh-intersect kernel (K7 / K8) and
the direct-lighting mesh kernel (K9).

Counterpart of ``tpu_rt/ops/pallas_mesh.py`` for what the mesh paths run.

Host side (numpy, the JAX package's arithmetic):

* ``build_clusters`` groups the triangles into clusters of at most 128:
  maximal BVH treelets (``_treelet_ranges``) when a tree is given, else
  runs of 128 along a given order.  Each cluster has a 9-row p0/e1/e2
  table, a 12-row Baldwin-Weber table (``_bw_table``, float64 constants
  rounded once), a 32-column bounds row (cluster box, triangle count, four
  quarter boxes) and its global triangle ids.
* ``build_cluster_tree`` gives the cull hierarchy over the clusters that
  K7 and K9 walk: an implicit 8-way tree over consecutive clusters in
  table order, each node's box the exact float32 min / max of its
  children's; ``tree_levels`` reads its header.
* ``build_shading_table`` gives the 12-row table of vertex normals and
  albedo that K9 reads at a hit.

K7 (``tpu_rt/ops/pallas_mesh.py::_mesh_sweep``, and K8, ``_mesh_sweep_fused``,
its one-call form over every table segment, with the same output): the
closest hit of N rays over the clusters [c0, c1) of the Baldwin-Weber table,
each ray starting from its incoming ``tmax``.  ``mesh_intersect_plain`` is
the plain PyTorch version, ``mesh_intersect`` the wrapper (plain version
for CPU tensors, ``csrc/mesh_isect.cu`` for CUDA tensors, or it raises).
The wavefront tracer (``geometry/trace.py``) sends every mesh query
through it.  The segments of the TPU form (an SMEM limit) are a cluster
range here: a call over [0, C) equals the chain of calls over consecutive
ranges, each taking the last one's ``t`` as its ``tmax``.

K9 (``tpu_rt/ops/pallas_mesh.py::_build_direct_kernel``, launched by
``_direct_render_setup``): per ray, the Moller-Trumbore closest hit over
the clusters with the shading normal interpolated at the hit, then one
shadow ray per point light, all lights summed with the Lambert term.

* ``bake_direct_scene`` checks K9's scope (one segment of at most 64
  clusters, no analytic shape, diffuse BSDFs only, point lights only, no
  texture) and bakes the shading table with the geometric-normal fallback
  for zero vertex normals.
* ``direct_trace_plain`` is the plain PyTorch version, ``direct_trace``
  the wrapper: the plain version for CPU tensors, ``csrc/mesh_direct.cu``
  for CUDA tensors (or it raises).
* ``mesh_direct_render`` renders a scene: jitter from a ``torch.Generator``
  seeded by ``seed``, primary rays from ``sensor.camera.sample_ray``, the
  kernel, and ``sensor.film.splat_aligned``.

The TPU kernel's Mosaic machinery is not carried over: no host live lists,
no front-to-back order, no tile permutation, no pad lanes, no tile-wide
culls.  In the plain versions each ray tests each cluster's root box, then
its four quarter boxes, and sweeps the contiguous live quarter span,
against its own running best distance.  The tile-wide culls were
conservative, so the hits are the same; only which of two triangles at
exactly the same distance wins can differ, since that follows the order in
which they are visited.  The CUDA kernels walk the cluster tree in table
order and split each span among a group of lanes, and give the plain
versions' bits (``tests/test_torch_cluster_tree.py`` emulates that walk).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_rt_torch.utils.memo import per_object

CLUSTER = 128  # triangles per cluster (the TPU's lane width; kept for the table layout)
CHUNK_C = 16  # cluster-count padding granularity of the tables
SEGMENT_C = 128  # clusters per table segment (pallas_mesh.SEGMENT_C)
DIRECT_C = 64  # K9's scope: one segment of at most 64 clusters
TREELET_SPLIT = 192  # scenes with more triangles get cluster tables


# ---------------------------------------------------------------------------
# Host-side cluster build
# ---------------------------------------------------------------------------

def _treelet_ranges(bvh, T, max_count=CLUSTER):
    """Cut the BVH into maximal subtrees of at most ``max_count``
    triangles (prim ids < T).  Every subtree owns a contiguous range of
    ``prim_order``; returns those (start, end) ranges in tree order."""
    a = np.asarray(bvh["a"])
    b = np.asarray(bvh["b"])
    count = np.asarray(bvh["count"])
    order = np.asarray(bvh["prim_order"])
    M = a.shape[0]

    # per-node prim_order range by post-order accumulation
    lo = np.full(M, 1 << 30, np.int64)
    hi = np.full(M, -1, np.int64)
    post = []
    stack = [0]
    while stack:
        ni = stack.pop()
        post.append(ni)
        if count[ni] == 0:
            stack.append(int(a[ni]))
            stack.append(int(b[ni]))
    for ni in reversed(post):
        if count[ni] > 0:
            lo[ni] = a[ni]
            hi[ni] = a[ni] + count[ni]
        else:
            la, lb = int(a[ni]), int(b[ni])
            lo[ni] = min(lo[la], lo[lb])
            hi[ni] = max(hi[la], hi[lb])

    is_tri = (order < T).astype(np.int64)
    csum = np.concatenate([[0], np.cumsum(is_tri)])

    ranges = []
    stack = [0]
    while stack:
        ni = stack.pop()
        n_tris_here = csum[hi[ni]] - csum[lo[ni]]
        if n_tris_here == 0:
            continue
        if n_tris_here <= max_count or count[ni] > 0:
            ranges.append((int(lo[ni]), int(hi[ni])))
        else:
            stack.append(int(b[ni]))
            stack.append(int(a[ni]))
    return ranges


def treelet_size(bvh, n_tris):
    """tpu_rt's treelet-size rule: 64-triangle treelets where they still
    fit one table segment, else 128 (``tpu_rt/scene/build.py``)."""
    return 64 if len(_treelet_ranges(bvh, n_tris, max_count=64)) <= SEGMENT_C else 128


def build_shading_table(prim, tri_n0, tri_n1, tri_n2, tri_albedo):
    """(C, 12, 128) float32: rows 0-8 the vertex normals n0, n1, n2 of each
    cluster lane's triangle (``prim`` [C * 128] global ids), rows 9-11 its
    albedo."""
    prim = np.asarray(prim).reshape(-1, CLUSTER)
    n0 = np.asarray(tri_n0, np.float32)[prim]  # (C, 128, 3)
    n1 = np.asarray(tri_n1, np.float32)[prim]
    n2 = np.asarray(tri_n2, np.float32)[prim]
    alb = np.asarray(tri_albedo, np.float32)[prim]
    out = np.empty((prim.shape[0], 12, CLUSTER), np.float32)
    for j in range(3):
        out[:, 0 + j] = n0[..., j]
        out[:, 3 + j] = n1[..., j]
        out[:, 6 + j] = n2[..., j]
        out[:, 9 + j] = alb[..., j]
    return out


def build_clusters(tri_p0, tri_e1, tri_e2, bvh=None, max_count=CLUSTER):
    """Group triangles into clusters of at most 128, padded to a multiple
    of 16 clusters.  With ``bvh`` the clusters are its maximal treelets of
    at most ``max_count`` triangles, else runs of 128 in triangle order.

    Returns dict(tris (C, 9, 128) p0/e1/e2 rows, trisw (C, 12, 128)
    Baldwin-Weber rows, bounds (C, 32): cols 0-5 the cluster box, col 6 the
    triangle count, cols 8-31 four quarter boxes over triangles
    [i*k//4, (i+1)*k//4); pads get far-point boxes, prim (C * 128,) global
    ids (0 for pads, which are degenerate and never hit), n_tris)."""
    p0 = np.asarray(tri_p0, np.float32)
    e1 = np.asarray(tri_e1, np.float32)
    e2 = np.asarray(tri_e2, np.float32)
    T = p0.shape[0]

    if bvh is not None:
        order = np.asarray(bvh["prim_order"]).astype(np.int32)
        groups = []
        for s, e in _treelet_ranges(bvh, T, max_count=max_count):
            ids = order[s:e]
            groups.append(ids[ids < T])
    else:
        order = np.arange(T, dtype=np.int32)
        groups = [order[i:i + CLUSTER] for i in range(0, T, CLUSTER)]

    C = max(len(groups), 1)
    Cp = -(-C // CHUNK_C) * CHUNK_C

    tris = np.zeros((Cp, 9, CLUSTER), np.float32)
    prim = np.zeros((Cp, CLUSTER), np.int32)
    # far-point boxes for pads: an inverted box would pass the slab test
    bmin = np.full((Cp, 3), 1e30, np.float32)
    bmax = np.full((Cp, 3), 1e30, np.float32)
    qmin = np.full((Cp, 4, 3), 1e30, np.float32)
    qmax = np.full((Cp, 4, 3), 1e30, np.float32)
    for c, ids in enumerate(groups):
        k = ids.shape[0]
        if k == 0:
            continue
        cp0, ce1, ce2 = p0[ids], e1[ids], e2[ids]
        for j in range(3):
            tris[c, j, :k] = cp0[:, j]
            tris[c, 3 + j, :k] = ce1[:, j]
            tris[c, 6 + j, :k] = ce2[:, j]
        prim[c, :k] = ids
        allv = np.concatenate([cp0, cp0 + ce1, cp0 + ce2], 0)
        bmin[c] = allv.min(axis=0)
        bmax[c] = allv.max(axis=0)
        for qi in range(4):
            s, e = (qi * k) // 4, ((qi + 1) * k) // 4
            if e <= s:
                continue
            qv = np.concatenate([cp0[s:e], cp0[s:e] + ce1[s:e], cp0[s:e] + ce2[s:e]], 0)
            qmin[c, qi] = qv.min(axis=0)
            qmax[c, qi] = qv.max(axis=0)

    counts = np.zeros((Cp, 1), np.float32)
    for c, ids in enumerate(groups):
        counts[c, 0] = ids.shape[0]
    qboxes = np.concatenate([qmin, qmax], axis=2).reshape(Cp, 24)
    bounds = np.concatenate(
        [bmin, bmax, counts, np.zeros((Cp, 1), np.float32), qboxes], axis=1
    ).astype(np.float32)
    return {"tris": tris, "trisw": _bw_table(tris), "bounds": bounds,
            "prim": prim.reshape(-1), "tree": build_cluster_tree(bounds), "n_tris": T}


TREE_LOG2 = 3  # the cull hierarchy's branching factor 8 = 1 << TREE_LOG2 (common.cuh)
TREE_MAX_LEVELS = 8  # the kernels keep 8 bits of untested children a level in 64
TREE_HEADER_ROWS = 2


def build_cluster_tree(bounds):
    """The cull hierarchy over contiguous cluster ranges that K7 and K9
    walk (``csrc/common.cuh::wide_walk``): an implicit tree of branching
    factor B = 8 (``1 << TREE_LOG2``) over the real clusters in table
    order (pads, count 0, stay out).  Level l >= 1 holds ceil(R / B^l)
    nodes; node j of level l covers the clusters [j B^l, (j + 1) B^l)
    and its box is the exact float32 min / max of their root boxes
    (``bounds[:, 0:6]``), so it contains each of them: a ray that fails
    it against its running best fails every cluster under it.  The top
    level is one node.

    Returns (2 + nodes, 8) float32: row 0 [R, L, TREE_LOG2, 0, and the
    row offsets of levels 1 .. 4], row 1 [levels 5 .. 8, 0 ...]; node rows
    [min xyz, max xyz, 0, 0].  At most 8 levels (8^8 clusters)."""
    b = np.asarray(bounds, np.float32)
    counts = b[:, 6]
    real = int((counts > 0).sum())
    if not (counts[:real] > 0).all():
        raise ValueError("build_cluster_tree: pad clusters must follow the real ones")
    box = b[:real, 0:6]
    B = 1 << TREE_LOG2
    levels = []
    while box.shape[0] > 1:
        n = -(-box.shape[0] // B)
        pad = n * B - box.shape[0]
        lo = np.concatenate([box[:, 0:3], np.repeat(box[-1:, 0:3], pad, 0)])
        hi = np.concatenate([box[:, 3:6], np.repeat(box[-1:, 3:6], pad, 0)])
        box = np.concatenate([lo.reshape(n, -1, 3).min(1), hi.reshape(n, -1, 3).max(1)], 1)
        levels.append(box)
    if len(levels) > TREE_MAX_LEVELS:
        raise ValueError(f"build_cluster_tree: {len(levels)} levels, at most {TREE_MAX_LEVELS}")
    hdr = np.zeros((TREE_HEADER_ROWS, 8), np.float32)
    flat = hdr.reshape(-1)
    flat[0:3] = real, len(levels), TREE_LOG2
    row = TREE_HEADER_ROWS
    for li, nodes in enumerate(levels):
        flat[4 + li] = row
        row += nodes.shape[0]
    rows = [np.concatenate([x, np.zeros((x.shape[0], 2), np.float32)], 1) for x in levels]
    return np.concatenate([hdr] + rows).astype(np.float32)


def tree_levels(tree):
    """(R, [(row offset, node count) of levels 1 .. L]) of a
    ``build_cluster_tree`` table; raises where its header is not one of
    an 8-way tree, the only one the kernels walk."""
    flat = np.asarray(tree, np.float32)[:TREE_HEADER_ROWS].reshape(-1)
    real, n_lev, lb = int(flat[0]), int(flat[1]), int(flat[2])
    if lb != TREE_LOG2 or not 0 <= n_lev <= TREE_MAX_LEVELS:
        raise ValueError(f"cluster tree header: branching 2^{lb} with {n_lev} levels; the "
                         f"kernels walk 2^{TREE_LOG2}-way trees of at most "
                         f"{TREE_MAX_LEVELS} levels (build_cluster_tree)")
    return real, [(int(flat[4 + li]), -(-real // (1 << (TREE_LOG2 * (li + 1)))))
                  for li in range(n_lev)]


def _bw_table(tris):
    """Precomputed-transform (Baldwin-Weber) rows from the (C, 9, 128)
    p0/e1/e2 table: rows 0-2 the unnormalised plane normal n = e1 x e2,
    3-5 p0, 6-8 r1 and 9-11 r2, the barycentric rows of [e1 e2 n]^-1.
    Computed in float64 and rounded once; degenerate (pad) triangles get
    all-zero rows and never hit."""
    p0 = tris[:, 0:3].astype(np.float64)
    e1 = tris[:, 3:6].astype(np.float64)
    e2 = tris[:, 6:9].astype(np.float64)
    n = np.cross(e1, e2, axis=1)
    det = (n * n).sum(axis=1, keepdims=True)  # |n|^2 = det[e1 e2 n]
    good = det > 1e-30
    inv = np.where(good, 1.0 / np.where(good, det, 1.0), 0.0)
    r1 = np.cross(e2, n, axis=1) * inv
    r2 = np.cross(n, e1, axis=1) * inv
    out = np.concatenate([n, np.where(good, p0, 0.0), r1, r2], axis=1)
    return np.where(np.broadcast_to(good, out.shape) & (out == out),
                    out, 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# K9: scope, tables, plain version, wrapper, render
# ---------------------------------------------------------------------------

_TMIN = 1e-4
_MISS = 0.99 * 1e8  # the best-t start; a ray missed where t stays >= 0.9e8
_HIT_LIMIT = 0.9 * 1e8
_SHADOW_SHRINK = 1.0 - 1e-3
_INV_PI = 1.0 / np.pi
MAX_POINT_LIGHTS = 32  # lights the kernel stages in shared memory


class DirectScene:
    """K9's tables on one device: bounds (C, 32), tris (C, 9, 128), shade
    (C, 12, 128), lights (P, 6) float32 (position, intensity) and the cull
    hierarchy over the cluster boxes (``build_cluster_tree``), plus host
    copies of the bounds and lights as Python floats, which the plain
    version reads."""

    def __init__(self, bounds, tris, shade, lights, tree, device="cpu"):
        as_t = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)
        self.bounds, self.tris, self.shade, self.lights, self.tree = (
            as_t(bounds), as_t(tris), as_t(shade), as_t(lights), as_t(tree))
        tree_levels(tree)
        self.bounds_list = np.asarray(bounds, np.float32).tolist()
        self.lights_list = np.asarray(lights, np.float32).tolist()

    @property
    def n_clusters(self):
        return self.bounds.shape[0]

    def to(self, device):
        return DirectScene(self.bounds.cpu().numpy(), self.tris.cpu().numpy(),
                           self.shade.cpu().numpy(), self.lights.cpu().numpy(),
                           self.tree.cpu().numpy(), device)


def bake_direct_scene(scene) -> "DirectScene | None":
    """K9's tables, or None when the scene is outside its scope: cluster
    tables of at most 64 clusters, no analytic shape, no texture, diffuse
    BSDFs only, at least one point light and no other emitter."""
    from tpu_rt_torch.scene.types import BSDF_DIFFUSE

    g = scene.geometry
    if g.cl_tris is None or g.cl_tris.shape[0] > DIRECT_C:
        return None
    if g.n_analytic != 0 or scene.has_textures:
        return None
    em = scene.emitters
    if em.n_area > 0 or em.has_env or em.n_point == 0:
        return None
    if not set(scene.bsdf_type.tolist()) <= {BSDF_DIFFUSE}:
        return None
    params = scene.bsdf_params.numpy()
    tri_alb = params[scene.shape_bsdf.numpy()[g.tri_shape.numpy()]][:, 0:3]
    # meshes without vertex normals hold zeros: shade those with the
    # geometric normal
    ng = np.cross(g.tri_e1.numpy(), g.tri_e2.numpy())
    ng = ng / np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)

    def with_fallback(nv):
        nv = nv.numpy()
        bad = np.linalg.norm(nv, axis=-1) < 1e-6
        return np.where(bad[:, None], ng, nv)

    shade = build_shading_table(g.cl_prim.numpy(), with_fallback(g.tri_n0),
                                with_fallback(g.tri_n1), with_fallback(g.tri_n2), tri_alb)
    lights = np.concatenate([em.point_pos.numpy(), em.point_intensity.numpy()], 1)
    return DirectScene(g.cl_bounds.numpy(), g.cl_tris.numpy(), shade, lights, g.cl_tree.numpy())


def _clamp_abs(x, eps):
    return torch.where(torch.abs(x) < eps, torch.where(x < 0, -eps, eps), x)


def _inv(x):
    """1 / x with |x| kept >= 1e-12 (the slab test's safe reciprocal)."""
    return torch.reciprocal(_clamp_abs(x, 1e-12))


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _normalize(a):
    inv = 1.0 / torch.sqrt(torch.clamp(_dot(a, a), min=1e-24))
    return (a[0] * inv, a[1] * inv, a[2] * inv)


def slab(o, invd, best_t, box, tmin=_TMIN):
    """Per-ray slab test of the box ``box`` (6 floats: min xyz, max xyz)
    against each ray's [tmin, best_t]."""
    t0x = (box[0] - o[0]) * invd[0]
    t1x = (box[3] - o[0]) * invd[0]
    t0y = (box[1] - o[1]) * invd[1]
    t1y = (box[4] - o[1]) * invd[1]
    t0z = (box[2] - o[2]) * invd[2]
    t1z = (box[5] - o[2]) * invd[2]
    tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                       torch.clamp(torch.minimum(t0z, t1z), min=tmin))
    tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                       torch.minimum(torch.maximum(t0z, t1z), best_t))
    return tn <= tf


def cluster_candidates(bounds_row, o, invd, best_t, tmin=_TMIN):
    """The rays that sweep a cluster and the triangles each sweeps: its
    root box cull, then the contiguous span of its live quarter boxes
    (quarter q covers triangles [q*k//4, (q+1)*k//4)).  Returns (rows,
    start, end): indices into the rays, and each one's [start, end)."""
    rows = torch.nonzero(slab(o, invd, best_t, bounds_row[0:6], tmin))[:, 0]
    if rows.numel() == 0:
        return rows, rows, rows
    o_, invd_, bt_ = [x[rows] for x in o], [x[rows] for x in invd], best_t[rows]
    l0, l1, l2, l3 = (slab(o_, invd_, bt_, bounds_row[8 + 6 * q:14 + 6 * q], tmin)
                      for q in range(4))
    k = int(bounds_row[6])
    q1, q2, q3 = k // 4, k // 2, (3 * k) // 4
    s = torch.where(l0, 0, torch.where(l1, q1, torch.where(l2, q2, q3)))
    e = torch.where(l3, k, torch.where(l2, q3, torch.where(l1, q2, q1)))
    live = l0 | l1 | l2 | l3
    return rows[live], s[live], e[live]


def bw_test(tw, o, d, bt, s, e, tmin=_TMIN):
    """Baldwin-Weber test (pallas_mesh.py ``intersect_one_bw``) against
    every lane of one cluster at once: tw the (12, k) rows (n = e1 x e2,
    p0, r1, r2), o / d / bt per ray (n,), lanes outside each ray's [s, e)
    masked off.  Returns (ok, t, u, v), each (n, k)."""
    o = [x[:, None] for x in o]
    d = [x[:, None] for x in d]
    nx, ny, nz = tw[0], tw[1], tw[2]
    tvx = o[0] - tw[3]
    tvy = o[1] - tw[4]
    tvz = o[2] - tw[5]
    den = nx * d[0] + ny * d[1] + nz * d[2]
    t = -(nx * tvx + ny * tvy + nz * tvz) / _clamp_abs(den, 1e-12)
    qx = tvx + t * d[0]
    qy = tvy + t * d[1]
    qz = tvz + t * d[2]
    u = tw[6] * qx + tw[7] * qy + tw[8] * qz
    v = tw[9] * qx + tw[10] * qy + tw[11] * qz
    lane = torch.arange(tw.shape[1], device=tw.device)
    ok = ((lane >= s[:, None]) & (lane < e[:, None]) & (u >= 0.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t > tmin) & (t < bt[:, None]))
    return ok, t, u, v


def _mt(tc, o, d, bt, s, e):
    """Moller-Trumbore against every lane of one cluster at once: tc the
    (9, k) p0/e1/e2 rows, o / d / bt per ray (n,), lanes outside each ray's
    [s, e) masked off.  Returns (ok, t, u, v), each (n, k)."""
    o = [x[:, None] for x in o]
    d = [x[:, None] for x in d]
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = tc
    pvx = d[1] * e2z - d[2] * e2y
    pvy = d[2] * e2x - d[0] * e2z
    pvz = d[0] * e2y - d[1] * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    invdet = 1.0 / _clamp_abs(det, 1e-12)
    tvx = o[0] - p0x
    tvy = o[1] - p0y
    tvz = o[2] - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * invdet
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (d[0] * qvx + d[1] * qvy + d[2] * qvz) * invdet
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * invdet
    lane = torch.arange(tc.shape[1], device=tc.device)
    ok = ((lane >= s[:, None]) & (lane < e[:, None]) & (u >= 0.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t > _TMIN) & (t < bt[:, None]))
    return ok, t, u, v


def first_min(ok, t):
    """Per row: whether any lane passed, and the passing lane with the
    smallest t, ties to the lowest lane.  That is the lane a sequential
    sweep with a strict ``t < best`` keeps."""
    tm = torch.where(ok, t, torch.inf)
    best = tm.min(dim=1, keepdim=True).values
    lane = torch.argmax((ok & (tm == best)).to(torch.int8), dim=1)
    return ok.any(dim=1), lane


def cluster_any_hit(bounds_list, tables, test, o, d, tmax, lanes):
    """True on the ``lanes`` whose segment (1e-4, tmax) hits a triangle
    of the cluster tables: ``bounds_list`` the bounds rows as Python
    floats, ``tables`` (C, rows, 128), ``test`` the triangle test on one
    cluster's (rows, k) table (``_mt`` here, Baldwin-Weber in K1's mesh
    mode), returning (ok, t, u, v).  Lanes that need no test are given the
    collapsed segment [1e-4, 1e-4] for the cull and then dropped."""
    invd = [_inv(x) for x in d]
    occ = torch.zeros_like(lanes)
    for c, brow in enumerate(bounds_list):
        need = lanes & ~occ
        rows, s, e = cluster_candidates(brow, o, invd, torch.where(need, tmax, _TMIN))
        keep = need[rows]
        rows, s, e = rows[keep], s[keep], e[keep]
        if rows.numel() == 0:
            continue
        k = int(brow[6])
        ok = test(tables[c, :, :k], [x[rows] for x in o], [x[rows] for x in d],
                  tmax[rows], s, e)[0]
        occ[rows] = ok.any(dim=1)
    return occ


def direct_trace_plain(ds: DirectScene, rays):
    """The plain PyTorch version of K9 on rays (6, N) float32 (origin xyz,
    direction xyz): returns (4, N) float32, the radiance rgb and the rays
    cast (the primary plus one shadow ray per light where one is cast)."""
    dev = rays.device
    N = rays.shape[1]
    o, d = [rays[i] for i in range(3)], [rays[3 + i] for i in range(3)]
    zeros = torch.zeros(N, dtype=torch.float32, device=dev)
    invd = [_inv(x) for x in d]
    best_t = torch.full((N,), _MISS, dtype=torch.float32, device=dev)
    att = torch.zeros((9, N), dtype=torch.float32, device=dev)  # ns, ng (raw), albedo
    for c, brow in enumerate(ds.bounds_list):
        rows, s, e = cluster_candidates(brow, o, invd, best_t)
        if rows.numel() == 0:
            continue
        k = int(brow[6])
        tc, sc = ds.tris[c, :, :k], ds.shade[c, :, :k]
        ok, t, u, v = _mt(tc, [x[rows] for x in o], [x[rows] for x in d], best_t[rows], s, e)
        hit, lane = first_min(ok, t)
        rows, lane = rows[hit], lane[hit]
        ar = torch.arange(lane.shape[0], device=dev)
        t, u, v = t[hit][ar, lane], u[hit][ar, lane], v[hit][ar, lane]
        tr, sh = tc[:, lane], sc[:, lane]  # the winners' rows
        w0 = 1.0 - u - v
        nsv = [w0 * sh[j] + u * sh[3 + j] + v * sh[6 + j] for j in range(3)]
        e1, e2 = tr[3:6], tr[6:9]
        gv = [e1[1] * e2[2] - e1[2] * e2[1], e1[2] * e2[0] - e1[0] * e2[2],
              e1[0] * e2[1] - e1[1] * e2[0]]
        best_t[rows] = t
        att[:, rows] = torch.stack(nsv + gv + [sh[9], sh[10], sh[11]])

    hit = best_t < _HIT_LIMIT
    ns = _normalize(att[0:3])
    ng = _normalize(att[3:6])
    tt = torch.where(hit, best_t, 0.0)
    p = [o[i] + d[i] * tt for i in range(3)]
    cos_i = -_dot(ns, d)
    pscale = torch.clamp(torch.maximum(torch.abs(p[0]), torch.maximum(
        torch.abs(p[1]), torch.abs(p[2]))), min=1.0)
    L = [zeros, zeros, zeros]
    ray_n = zeros + 1.0
    for lpos_int in ds.lights_list:
        lpos, lint = lpos_int[:3], lpos_int[3:]
        to_l = [lpos[i] - p[i] for i in range(3)]
        dist2 = torch.clamp(_dot(to_l, to_l), min=1e-20)
        dist = torch.sqrt(dist2)
        inv_dist = 1.0 / dist
        wl = [x * inv_dist for x in to_l]
        cos_o = _dot(ns, wl)
        valid = hit & (cos_i > 0.0) & (cos_o > 0.0)
        ray_n = ray_n + torch.where(valid, 1.0, 0.0)
        sgn = torch.where(_dot(ng, wl) >= 0.0, 1.0, -1.0)
        off = 1e-4 * pscale * sgn
        so = [p[i] + ng[i] * off for i in range(3)]
        occ = cluster_any_hit(ds.bounds_list, ds.tris, _mt, so, wl, dist * _SHADOW_SHRINK, valid)
        lit = torch.where(valid & ~occ, cos_o / dist2, 0.0) * _INV_PI
        L = [L[i] + att[6 + i] * lint[i] * lit for i in range(3)]
    return torch.stack(L + [ray_n])


def direct_trace(ds: DirectScene, rays):
    """K9 on rays (6, N) float32 (origin xyz, direction xyz): returns
    (4, N) float32 on the rays' device, radiance rgb and rays cast.

    On a CPU tensor this runs the plain version.  On a CUDA tensor it
    launches ``csrc/mesh_direct.cu`` (built at first use) or raises.
    ``direct_trace.launches`` counts kernel launches."""
    dev = rays.device
    if dev.type == "cpu":
        return direct_trace_plain(ds, rays)
    if dev.type != "cuda":
        raise ValueError(f"direct_trace runs on cpu or cuda, not {dev.type}")
    if rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[0] != 6 \
            or not rays.is_contiguous():
        raise ValueError("direct_trace needs contiguous float32 rays of shape (6, N)")
    n = rays.shape[1]
    C, P = ds.n_clusters, ds.lights.shape[0]
    tabs = (ds.bounds, ds.tris, ds.shade, ds.lights, ds.tree)
    if any(x.device != dev or not x.is_contiguous() for x in tabs):
        raise ValueError("direct_trace needs its tables contiguous on the rays' device")
    if not (0 < C <= DIRECT_C and 0 < P <= MAX_POINT_LIGHTS and 0 < n < 2 ** 31):
        raise ValueError(f"direct_trace takes 1..{DIRECT_C} clusters, 1..{MAX_POINT_LIGHTS} "
                         f"lights and fewer than 2^31 rays (got {C}, {P}, {n})")
    if tuple(ds.tree.shape[1:]) != (8,) or ds.tree.shape[0] > TREE_HEADER_ROWS + DIRECT_C:
        raise ValueError(f"direct_trace needs a cluster tree of at most "
                         f"{TREE_HEADER_ROWS + DIRECT_C} rows of 8 (got {tuple(ds.tree.shape)})")
    from tpu_rt_torch.ops import _build

    lib = _build.load_library()
    out = torch.empty((4, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mesh_direct_launch(
            rays.data_ptr(), n, ds.bounds.data_ptr(), ds.tris.data_ptr(),
            ds.shade.data_ptr(), ds.tree.data_ptr(), ds.tree.shape[0], C,
            ds.lights.data_ptr(), P, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("mesh_direct kernel launch failed: "
                           + lib.mesh_direct_error_string(err).decode())
    direct_trace.launches += 1
    return out


direct_trace.launches = 0


def _direct_films(ds: DirectScene, c, spp, gen, device, spp_per_pass):
    """``spp`` samples a pixel through K9 in passes of ``spp_per_pass``:
    the jitter drawn from ``gen``, the primary rays of
    ``sensor.camera.sample_ray``, the kernel's radiance splatted at the
    samples' pixels.  Returns the unnormalised films (values [H, W, 3],
    weights [H, W]) and the rays cast (0-d int64)."""
    from tpu_rt_torch.sensor import camera as _cam
    from tpu_rt_torch.sensor import film as _film

    H, W = c.height, c.width
    k = max(1, min(spp_per_pass, spp))
    ys, xs = torch.meshgrid(torch.arange(H, device=device), torch.arange(W, device=device),
                            indexing="ij")
    xy = torch.stack([xs, ys], -1).reshape(-1, 2).to(torch.float32)
    fv = torch.zeros((H, W, 3), dtype=torch.float32, device=device)
    fw = torch.zeros((H, W), dtype=torch.float32, device=device)
    n_rays = torch.zeros((), dtype=torch.int64, device=device)
    done = 0
    while done < spp:
        n = min(k, spp - done)
        jitter = torch.rand((n, H * W, 2), generator=gen, device=device)
        o, d = _cam.sample_ray(c, xy + jitter)
        rays = torch.cat([o, d], -1).reshape(-1, 6).T.contiguous()
        out = direct_trace(ds, rays)
        L = out[:3].T.reshape(n, H, W, 3)
        ok = torch.isfinite(L).all(-1)
        fv, fw = _film.splat_aligned(fv, fw, jitter.reshape(n, H, W, 2),
                                     torch.where(ok[..., None], L, 0.0), ok, c.filter_type)
        n_rays += out[3].to(torch.int64).sum()
        done += n
    return fv, fw, n_rays


def _direct_inputs(scene, baked, device):
    ds = baked if baked is not None else bake_direct_scene(scene)
    if ds is None:
        raise ValueError("scene is outside the direct mesh kernel's scope")
    return ds.to(device)


def mesh_direct_render(scene, spp=None, seed=0, device="cuda", spp_per_pass=64,
                       baked=None):
    """Direct-lighting render of a mesh scene lit by point lights through
    K9.  Each pass of ``spp_per_pass`` samples draws its jitter from a
    ``torch.Generator`` on ``device`` seeded by ``seed``, casts the primary
    rays with ``sensor.camera.sample_ray`` and splats the kernel's radiance
    at the samples' pixels.  Returns the (H, W, 3) image on ``device`` and
    sets ``mesh_direct_render.last_ray_count`` (0-d int64: primaries plus
    shadow rays cast).  Raises ValueError outside K9's scope."""
    from tpu_rt_torch.sensor import film as _film

    device = torch.device(device)
    ds = _direct_inputs(scene, baked, device)
    c = scene.camera
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    fv, fw, n_rays = _direct_films(ds, c, c.spp if spp is None else spp, gen, device,
                                   spp_per_pass)
    mesh_direct_render.last_ray_count = n_rays
    return _film.develop(fv, fw)


mesh_direct_render.last_ray_count = None


def mesh_direct_render_sharded(scene, spp=None, seed=0, group=None, device="cuda",
                               spp_per_pass=64, baked=None):
    """``mesh_direct_render`` sharded over samples across the ranks of a
    ``torch.distributed`` group (tpu_rt's ``mesh_direct_render_sharded``):
    rank r runs its spp / n samples with a generator seeded seed + r *
    7919, and the films and ray counts are summed.  With one rank it is
    ``mesh_direct_render``.  Raises ValueError outside K9's scope and when
    spp is not a multiple of the ranks.  Returns the (H, W, 3) image on
    ``device``, the same on every rank, and sets
    ``mesh_direct_render_sharded.last_ray_count`` (0-d int64, all
    ranks)."""
    from tpu_rt_torch.parallel.render import RANK_SEED_STRIDE, group_shape, psum
    from tpu_rt_torch.sensor import film as _film

    device = torch.device(device)
    group, n, rank = group_shape(group)
    c = scene.camera
    spp = c.spp if spp is None else spp
    if spp % n:
        raise ValueError(f"spp {spp} must divide over {n} ranks")
    ds = _direct_inputs(scene, baked, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + rank * RANK_SEED_STRIDE)
    fv, fw, n_rays = _direct_films(ds, c, spp // n, gen, device, spp_per_pass)
    mesh_direct_render_sharded.last_ray_count = psum(n_rays, group)
    return _film.develop(psum(fv, group), psum(fw, group))


mesh_direct_render_sharded.last_ray_count = None


# ---------------------------------------------------------------------------
# K7 / K8: closest hit over the clusters, plain version and wrapper
# ---------------------------------------------------------------------------

def mesh_intersect_plain(bounds, trisw, o, d, tmax, tmin=_TMIN, c0=0, c1=None):
    """The plain PyTorch version of K7 on rays o, d [N, 3] float32 with the
    incoming best distance ``tmax`` [N]: the clusters c0 .. c1-1 of
    ``bounds`` (C, 32) / ``trisw`` (C, 12, 128) in table order, each one's
    root and quarter culls against the running best, then its live span,
    keeping a strictly smaller t (ties to the lowest lane, as a sequential
    sweep keeps them).  Returns (t, lid, u, v) [N]: lid the table lane
    c * 128 + k (int32, -1 where nothing was hit below tmax, and t then
    stays tmax, u = v = 0)."""
    n = o.shape[0]
    dev = o.device
    c1 = bounds.shape[0] if c1 is None else c1
    oc, dc = [o[:, i] for i in range(3)], [d[:, i] for i in range(3)]
    invd = [_inv(x) for x in dc]
    best_t = tmax.clone()
    lid = torch.full((n,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros((n,), dtype=torch.float32, device=dev)
    bv = torch.zeros((n,), dtype=torch.float32, device=dev)
    for c, brow in enumerate(bounds[c0:c1].tolist(), start=c0):
        rows, s, e = cluster_candidates(brow, oc, invd, best_t, tmin)
        if rows.numel() == 0:
            continue
        k = int(brow[6])
        ok, t, u, v = bw_test(trisw[c, :, :k], [x[rows] for x in oc], [x[rows] for x in dc],
                              best_t[rows], s, e, tmin)
        hit, lane = first_min(ok, t)
        rows, lane = rows[hit], lane[hit]
        ar = torch.arange(lane.shape[0], device=dev)
        best_t[rows] = t[hit][ar, lane]
        bu[rows] = u[hit][ar, lane]
        bv[rows] = v[hit][ar, lane]
        lid[rows] = (lane + c * CLUSTER).to(torch.int32)
    return best_t, lid, bu, bv


def mesh_intersect(clusters, o, d, tmin=_TMIN, tmax=None, c0=0, c1=None):
    """Closest hit of rays o, d [N, 3] float32 over the clusters [c0, c1)
    (all by default) of ``clusters`` (a dict of tensors on the rays'
    device: ``bounds`` (C, 32), ``trisw`` (C, 12, 128), ``prim`` (C * 128,)
    global triangle ids, and for the kernel ``tree``, the cull hierarchy
    of ``build_cluster_tree``).  ``tmax`` is a scalar or [N], by default
    0.99 * 1e8.  Returns (t, prim, u, v) [N], detached: prim the global
    triangle id, -1 on a miss, where t stays the incoming tmax.

    On CPU tensors this runs the plain version.  On CUDA tensors it
    launches ``csrc/mesh_isect.cu`` (built at first use) or raises.
    ``mesh_intersect.launches`` counts kernel launches."""
    dev = o.device
    n = o.shape[0]
    bounds, trisw, prim_map = clusters["bounds"], clusters["trisw"], clusters["prim"]
    C = bounds.shape[0]
    c1 = C if c1 is None else c1
    if not 0 <= c0 <= c1 <= C:
        raise ValueError(f"mesh_intersect: cluster range [{c0}, {c1}) outside [0, {C})")
    if tmax is None:
        tmax = _MISS
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=dev).expand(n).contiguous()
    with torch.no_grad():
        if dev.type == "cpu":
            t, lid, u, v = mesh_intersect_plain(bounds, trisw, o, d, tmax, tmin, c0, c1)
        elif dev.type == "cuda":
            t, lid, u, v = _mesh_intersect_cuda(bounds, trisw, clusters.get("tree"), o, d,
                                                tmax, tmin, c0, c1)
        else:
            raise ValueError(f"mesh_intersect runs on cpu or cuda, not {dev.type}")
        prim = torch.where(lid >= 0, prim_map[torch.clamp(lid, min=0).to(torch.int64)], -1)
    return t, prim.to(torch.int32), u, v


mesh_intersect.launches = 0


def _mesh_intersect_cuda(bounds, trisw, tree, o, d, tmax, tmin, c0, c1):
    dev = o.device
    n = o.shape[0]
    if tree is None:
        raise ValueError("mesh_intersect on CUDA needs the clusters' tree "
                         "(build_cluster_tree)")
    # its header checked once a tensor
    per_object(tree, "tree levels", lambda: tree_levels(tree[:TREE_HEADER_ROWS].cpu()))
    for name, x, shape in (("o", o, (n, 3)), ("d", d, (n, 3)), ("tmax", tmax, (n,)),
                           ("bounds", bounds, (bounds.shape[0], 32)),
                           ("trisw", trisw, (bounds.shape[0], 12, CLUSTER)),
                           ("tree", tree, (tree.shape[0], 8))):
        if (x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError(f"mesh_intersect needs {name} as contiguous float32 of shape "
                             f"{shape} on {dev}")
    if not 0 < n < 2 ** 31:
        raise ValueError(f"mesh_intersect takes 1 .. 2^31 - 1 rays (got {n})")
    from tpu_rt_torch.ops import _build

    lib = _build.load_library()
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    lid = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mesh_isect_launch(
            bounds.data_ptr(), trisw.data_ptr(), tree.data_ptr(), c0, c1, o.data_ptr(),
            d.data_ptr(), tmax.data_ptr(), float(tmin), n, t.data_ptr(), lid.data_ptr(),
            u.data_ptr(), v.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("mesh_isect kernel launch failed: "
                           + lib.mesh_isect_error_string(err).decode())
    mesh_intersect.launches += 1
    return t, lid, u, v
