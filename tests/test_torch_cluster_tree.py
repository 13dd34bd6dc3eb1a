"""The cull hierarchy over contiguous cluster ranges and the walk that the
mesh kernels K7 (``ops/csrc/mesh_isect.cu``) and K9 (``mesh_direct.cu``)
make over it, on the CPU.

The tree (``mesh_kernel.build_cluster_tree``) of mesh_big_gi.xml,
simple_big.xml and simple.xml: contiguous ranges that partition their
parent's, node boxes that hold their children exactly in float32, pads
left out.

The walk is emulated here in PyTorch, ray by ray in lockstep, as a
kernel's ray makes it: left to right over the tree's nodes and the
clusters, a node that fails its box against the ray's running best
skipping its clusters, each cluster's root and quarter culls
(``mesh_kernel.cluster_candidates``' arithmetic), and its span split
among the ray's group of lanes as the kernel splits it (lane j takes
triangles s + j, s + j + G, ... and keeps a strictly smaller t), reduced
by the xor butterfly over the group to the lexicographic minimum of
(t, k).  It must equal the plain versions bit for bit (``torch.equal``),
since the kernels are held to those on the card: K7 on three waves of
mesh_big_gi.xml at 32x32 with dead lanes (tmax 0), at the kernel's group
size and at 1 and 32, on cluster ranges that cut nodes and on a tie
fixture of duplicated triangles; K9 on simple.xml at 32x32.  The box
tests that chip_smoke.py counts for K7's and K9's bounds are the
emulated walk's.  The inputs come from numpy seeds.
"""

import os

import numpy as np
import pytest
import torch

import tpu_rt_torch
from tpu_rt_torch.core import math as cm
from tpu_rt_torch.core import warps
from tpu_rt_torch.geometry import trace
from tpu_rt_torch.ops import mesh_kernel as mk
from tpu_rt_torch.sensor import camera
from torch_port_scenes import tie_fixture

torch.set_num_threads(1)

MESH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "mesh")
SCENES = ("mesh_big_gi.xml", "simple_big.xml", "simple.xml")
INT_MAX = 2 ** 31 - 1
GROUP = 16  # the lanes a ray's span is split among in K7 (mesh_isect.cu, kGroup)
DIRECT_GROUP = 4  # and in K9 (mesh_direct.cu, kGroup)
B = 1 << mk.TREE_LOG2  # the tree's branching factor


@pytest.fixture(scope="module")
def scenes():
    return {name: tpu_rt_torch.load_file(os.path.join(MESH, name), res=32, spp=1)
            for name in SCENES}


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SCENES)
def test_tree_partitions_ranges_and_holds_its_children(scenes, name):
    g = scenes[name].geometry
    bounds = g.cl_bounds.numpy()
    tree = mk.build_cluster_tree(bounds)
    assert np.array_equal(tree, g.cl_tree.numpy())
    real, levels = mk.tree_levels(tree)
    assert real == int((bounds[:, 6] > 0).sum()) and (bounds[real:, 6] == 0).all()
    if name == "mesh_big_gi.xml":
        assert (real, bounds.shape[0]) == (793, 800)  # seven pads, left out
    assert levels[-1][1] == 1 and tree.shape[0] == mk.TREE_HEADER_ROWS + sum(
        n for _, n in levels)
    child_lo, child_hi = bounds[:real, 0:3], bounds[:real, 3:6]
    n_child = real
    for li, (off, n) in enumerate(levels, start=1):
        width = B ** li
        # node j covers [j B^l, (j + 1) B^l): the ranges partition [0, R)
        # and each parent's range is its B children's
        spans = [(j * width, min((j + 1) * width, real)) for j in range(n)]
        assert spans[0][0] == 0 and spans[-1][1] == real
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        nodes = tree[off:off + n]
        assert (nodes[:, 6:8] == 0).all()
        for j in range(n):
            kids = slice(j * B, min((j + 1) * B, n_child))
            # the exact float32 min / max of the children: no rounding
            assert np.array_equal(nodes[j, 0:3], child_lo[kids].min(0))
            assert np.array_equal(nodes[j, 3:6], child_hi[kids].max(0))
            lo, hi = bounds[spans[j][0]:spans[j][1], 0:3], bounds[spans[j][0]:spans[j][1], 3:6]
            assert (nodes[j, 0:3] <= lo).all() and (nodes[j, 3:6] >= hi).all()
            assert (np.abs(nodes[j, 0:6]) < 1e29).all()  # no pad box in it
        child_lo, child_hi, n_child = nodes[:, 0:3], nodes[:, 3:6], n


def test_tree_is_built_for_a_scene_handed_over_from_tpu_rt(scenes):
    """tpu_rt's scenes carry no tree: scene_from_arrays builds it from
    their cluster bounds, equal to the loader's."""
    import tpu_rt
    from test_torch_scene import tpu_rt_arrays
    from tpu_rt_torch.scene import scene_from_arrays

    carried = scene_from_arrays(*tpu_rt_arrays(
        tpu_rt.load_file(os.path.join(MESH, "simple.xml"), res=32, spp=1)))
    assert torch.equal(carried.geometry.cl_tree, scenes["simple.xml"].geometry.cl_tree)
    bad = carried.geometry.cl_bounds.numpy().copy()
    bad[3, 6] = 0
    with pytest.raises(ValueError, match="pad clusters"):
        mk.build_cluster_tree(bad)


# ---------------------------------------------------------------------------
# the kernels' walk, emulated
# ---------------------------------------------------------------------------

def _group_span_min(ok, t, s, e, group):
    """The span minimum as a ray's ``group`` lanes find it: lane j keeps
    the strictly smaller t of triangles s + j, s + j + group, ..., then the
    xor butterfly over the group takes the lexicographic minimum of
    (t, k).  Returns k, INT_MAX where nothing passed."""
    n = ok.shape[0]
    lane = torch.arange(group)
    mt = torch.full((n, group), float("inf"))
    mkk = torch.full((n, group), INT_MAX, dtype=torch.int64)
    for m in range(-(-mk.CLUSTER // group)):
        k = s[:, None] + lane[None, :] + group * m
        inside = k < e[:, None]
        kc = torch.clamp(k, max=ok.shape[1] - 1)
        okk = inside & torch.gather(ok, 1, kc)
        tk = torch.gather(t, 1, kc)
        take = okk & (tk < mt)
        mt = torch.where(take, tk, mt)
        mkk = torch.where(take, k, mkk)
    m = group // 2
    while m > 0:
        ot, ok_ = mt[:, lane ^ m], mkk[:, lane ^ m]
        take = (ot < mt) | ((ot == mt) & (ok_ < mkk))
        mt, mkk = torch.where(take, ot, mt), torch.where(take, ok_, mkk)
        m //= 2
    assert (mkk == mkk[:, :1]).all()  # every lane of the group holds the result
    return mkk[:, 0]


def _walk(bounds, tree, o, d, tmax, c0, c1, test, any_hit=False, group=GROUP, live=None):
    """The walk of K7 / K9 (``common.cuh::wide_walk``) for every ray, in
    lockstep: depth first and left to right, a node's children tested
    when the walk enters it against the best t at that time, then at each
    cluster its quarter boxes against the running best and its span's
    triangles.  Returns (best t, the winner's cluster and lane (-1 where
    none), u, v), or for ``any_hit`` whether a triangle was hit, and the
    box tests made.  ``test(c, rows, s, e, bt)`` tests cluster c's
    triangles for the given rays (the plain versions' arithmetic) and
    returns (ok, t, u, v), each (rows, k).  Rays outside ``live`` (K9's
    shadow rays that are not cast) make no walk."""
    n = o.shape[0]
    real, levels = mk.tree_levels(tree)
    lb = mk.TREE_LOG2
    top = max(len(levels), 1)
    offs = [0] + [off for off, _ in levels]
    tree_t = torch.as_tensor(tree)
    bounds_t = torch.as_tensor(bounds)
    oc, dc = [o[:, i] for i in range(3)], [d[:, i] for i in range(3)]
    invd = [mk._inv(x) for x in dc]
    best_t = tmax.clone()
    win_c = torch.full((n,), -1, dtype=torch.int64)
    win_k = torch.zeros((n,), dtype=torch.int64)
    bu, bv = torch.zeros(n), torch.zeros(n)
    occ = torch.zeros(n, dtype=torch.bool)
    cend = min(c1, real)
    tests = {"node": 0, "root": 0, "quarter": 0}

    def children(rows, lv, base):
        """The mask of the level-lv nodes' passing children, per ray."""
        width = 1 << ((lv - 1) * lb)
        mask = torch.zeros(rows.shape[0], dtype=torch.int64)
        for j in range(B):
            cs = base + j * width
            inside = (cs < cend) & (cs + width > c0)
            if lv == 1:
                box = bounds_t[torch.clamp(cs, max=bounds_t.shape[0] - 1), 0:6].T
                tests["root"] += int(inside.sum())
            else:
                node = offs[lv - 1] + torch.clamp(cs, max=real - 1) // width
                box = tree_t[node, 0:6].T
                tests["node"] += int(inside.sum())
            ok = inside & mk.slab([x[rows] for x in oc], [x[rows] for x in invd], best_t[rows],
                                  box)
            mask |= ok.long() << j
        return mask

    alive = torch.ones(n, dtype=torch.bool) if live is None else live.clone()
    if len(levels) > 0:
        alive &= mk.slab(oc, invd, best_t, tree_t[offs[top], 0:6].tolist())
        tests["node"] += n if live is None else int(live.sum())
    lvl = torch.full((n,), top, dtype=torch.int64)
    base = torch.zeros(n, dtype=torch.int64)
    masks = torch.zeros(n, dtype=torch.int64)
    r = torch.nonzero(alive)[:, 0]
    masks[r] = children(r, top, base[r]) << (8 * (top - 1))
    while True:
        act = alive & ~occ
        if not act.any():
            break
        r = torch.nonzero(act)[:, 0]
        m = (masks[r] >> (8 * (lvl[r] - 1))) & 0xFF
        up = r[m == 0]  # this level is done: back to the parent's
        lvl[up] += 1
        alive[up[lvl[up] > top]] = False
        up = up[lvl[up] <= top]
        base[up] = base[up] & ~((1 << (lvl[up] * lb)) - 1)
        r, m = r[m != 0], m[m != 0]
        j = torch.log2((m & -m).double()).long()  # the lowest untested child
        masks[r] &= ~(1 << (8 * (lvl[r] - 1) + j))
        cs = base[r] + (j << ((lvl[r] - 1) * lb))
        enter = lvl[r] > 1
        for lv in torch.unique(lvl[r][enter]).tolist():
            rr = r[enter & (lvl[r] == lv)]
            cc = cs[enter & (lvl[r] == lv)]
            lvl[rr], base[rr] = lv - 1, cc
            masks[rr] |= children(rr, lv - 1, cc) << (8 * (lv - 2))
        r, cs = r[~enter], cs[~enter]
        for cid in torch.unique(cs).tolist():
            rr = r[cs == cid]
            brow = bounds[cid].tolist()
            o_, i_, bt_ = [x[rr] for x in oc], [x[rr] for x in invd], best_t[rr]
            l0, l1, l2, l3 = (mk.slab(o_, i_, bt_, brow[8 + 6 * q:14 + 6 * q]) for q in range(4))
            tests["quarter"] += 4 * int(rr.numel())
            k = int(brow[6])
            q1, q2, q3 = k // 4, k // 2, (3 * k) // 4
            s = torch.where(l0, 0, torch.where(l1, q1, torch.where(l2, q2, q3)))
            e = torch.where(l3, k, torch.where(l2, q3, torch.where(l1, q2, q1)))
            live = l0 | l1 | l2 | l3
            rows, s, e = rr[live], s[live], e[live]
            if rows.numel() == 0:
                continue
            ok, t, u, v = test(cid, rows, s, e, best_t[rows])
            if any_hit:
                occ[rows] = ok.any(dim=1)
                continue
            k = _group_span_min(ok, t, s, e, group)
            hit = k != INT_MAX
            rows, k = rows[hit], k[hit]
            ar = torch.arange(k.shape[0])
            best_t[rows] = t[hit][ar, k]
            bu[rows], bv[rows] = u[hit][ar, k], v[hit][ar, k]
            win_c[rows], win_k[rows] = cid, k
    if any_hit:
        return occ, tests
    return (best_t, win_c, win_k, bu, bv), tests


def k7_walk(bounds, trisw, tree, o, d, tmax, c0=0, c1=None, group=GROUP):
    """K7's closest hit by the kernel's walk: (t, lid, u, v) as
    ``mesh_intersect_plain`` returns them, and the tests made."""
    c1 = bounds.shape[0] if c1 is None else c1

    def test(cid, rows, s, e, bt):
        k = int(bounds[cid, 6])
        return mk.bw_test(trisw[cid, :, :k], [o[rows, i] for i in range(3)],
                          [d[rows, i] for i in range(3)], bt, s, e)

    (t, wc, wk, u, v), tests = _walk(bounds, tree, o, d, tmax, c0, c1, test, group=group)
    lid = torch.where(wc >= 0, wc * mk.CLUSTER + wk, -1).to(torch.int32)
    return (t, lid, u, v), tests


def _big_gi_waves(st, seed):
    """Primaries of the scene's film from a numpy jitter, cosine bounce
    rays from their hits, shadow rays toward the area light with tmax just
    short of it; a quarter of each wave's lanes dead (tmax 0), as the
    wavefront sends its finished paths."""
    rng = np.random.default_rng(seed)
    c = st.camera
    ys, xs = np.meshgrid(np.arange(c.height), np.arange(c.width), indexing="ij")
    n = c.height * c.width
    xy = np.stack([xs, ys], -1).reshape(-1, 2) + rng.uniform(0, 1, (n, 2))
    o, d = camera.sample_ray(c, torch.from_numpy(xy.astype(np.float32)))
    si = trace.ray_intersect(st, o, d)
    nf = torch.where((si.n * d).sum(-1, keepdim=True) < 0, si.n, -si.n)
    sf, tf = cm.coordinate_system(nf)
    db = cm.to_world(nf, sf, tf, warps.square_to_cosine_hemisphere(
        torch.from_numpy(rng.uniform(0, 1, (n, 2)).astype(np.float32))))
    ob = si.spawn_origin(db)
    uv = torch.from_numpy(rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32))
    pl = torch.stack([uv[:, 0], torch.full_like(uv[:, 0], 4.0), uv[:, 1]], -1)
    to_l = pl - si.p
    dist = to_l.norm(dim=-1)
    ds = to_l / dist[:, None]
    dead = torch.from_numpy(rng.uniform(0, 1, n) < 0.25)
    big = torch.full((n,), np.float32(0.99 * 1e8))
    waves = {"primary": (o, d, big), "bounce": (ob, db, big),
             "shadow": (si.spawn_origin(ds), ds, dist * (1.0 - 1e-3))}
    return {k: (a.contiguous(), b.contiguous(), torch.where(dead, 0.0, tm).contiguous())
            for k, (a, b, tm) in waves.items()}


@pytest.fixture(scope="module")
def big_waves(scenes):
    return _big_gi_waves(scenes["mesh_big_gi.xml"], 11)


@pytest.mark.parametrize("wave,group", [("primary", GROUP), ("bounce", GROUP), ("shadow", GROUP),
                                        ("bounce", 1), ("bounce", 32)])
def test_k7_walk_is_bit_equal_to_the_plain_version(scenes, big_waves, wave, group):
    g = scenes["mesh_big_gi.xml"].geometry
    o, d, tmax = big_waves[wave]
    got, tests = k7_walk(g.cl_bounds, g.cl_trisw, g.cl_tree.numpy(), o, d, tmax, group=group)
    want = mk.mesh_intersect_plain(g.cl_bounds, g.cl_trisw, o, d, tmax)
    for a, b, name in zip(got, want, ("t", "lid", "u", "v")):
        assert torch.equal(a, b), name
    n = o.shape[0]
    assert 0.05 < (want[1] >= 0).float().mean().item() < 0.9
    assert (tmax == 0).any() and (want[1][tmax == 0] == -1).all()
    # the hierarchy's point: far fewer box tests than 800 root tests a ray
    assert tests["node"] + tests["root"] < 0.2 * n * g.cl_bounds.shape[0]


@pytest.mark.parametrize("ranges", [[(0, 37), (37, 300), (300, 800)],
                                    [(0, 128), (128, 256), (256, 384), (384, 512),
                                     (512, 640), (640, 768), (768, 800)],
                                    [(5, 6), (190, 411)]],
                         ids=["cut", "segments", "partial"])
def test_k7_walk_over_cluster_ranges_that_cut_nodes(scenes, big_waves, ranges):
    """The chain of calls over consecutive ranges, each from the last t,
    equals the plain version's chain; over all of [0, 800) it equals the
    one call."""
    g = scenes["mesh_big_gi.xml"].geometry
    tree = g.cl_tree.numpy()
    o, d, tmax = big_waves["bounce"]
    got = want = None
    for c0, c1 in ranges:
        seg_g = k7_walk(g.cl_bounds, g.cl_trisw, tree, o, d,
                        tmax if got is None else got[0], c0, c1)[0]
        seg_w = mk.mesh_intersect_plain(g.cl_bounds, g.cl_trisw, o, d,
                                        tmax if want is None else want[0], c0=c0, c1=c1)
        got = seg_g if got is None else tuple(
            torch.where(seg_g[1] >= 0, a, b) for a, b in zip(seg_g, got))
        want = seg_w if want is None else tuple(
            torch.where(seg_w[1] >= 0, a, b) for a, b in zip(seg_w, want))
    for a, b, name in zip(got, want, ("t", "lid", "u", "v")):
        assert torch.equal(a, b), name
    if ranges[0][0] == 0 and ranges[-1][1] == 800:
        one = mk.mesh_intersect_plain(g.cl_bounds, g.cl_trisw, o, d, tmax)
        for a, b, name in zip(got, one, ("t", "lid", "u", "v")):
            assert torch.equal(a, b), name


def test_ties_go_to_the_lowest_lane_within_and_across_clusters():
    cl, o, d = tie_fixture()
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    bounds, trisw = torch.from_numpy(cl["bounds"]), torch.from_numpy(cl["trisw"])
    tmax = torch.full((o.shape[0],), np.float32(0.99 * 1e8))
    got, _ = k7_walk(bounds, trisw, cl["tree"], o, d, tmax)
    want = mk.mesh_intersect_plain(bounds, trisw, o, d, tmax)
    for a, b, name in zip(got, want, ("t", "lid", "u", "v")):
        assert torch.equal(a, b), name
    prim = cl["prim"][want[1].numpy()]
    hit_dup = np.isin(prim, [5, 10, 70, 140])
    assert hit_dup.sum() >= 24 and (want[1] >= 0).all()
    # the copies (70 in cluster 0, 140 in cluster 1) never win over 5 and 10
    assert set(prim[hit_dup].tolist()) <= {5, 10}
    # and the winner's t, u, v are the copy's too: the same triangle test
    for first, copy in ((5, 70), (10, 140)):
        rows = torch.from_numpy(prim == first)
        lane_f, lane_c = [int(np.nonzero(cl["prim"] == x)[0][0]) for x in (first, copy)]
        cf, kf, cc, kc = lane_f // 128, lane_f % 128, lane_c // 128, lane_c % 128
        ok_f, t_f, u_f, v_f = mk.bw_test(
            trisw[cf], [o[rows, i] for i in range(3)], [d[rows, i] for i in range(3)],
            tmax[rows], torch.full((int(rows.sum()),), kf), torch.full((int(rows.sum()),), kf + 1))
        ok_c, t_c, u_c, v_c = mk.bw_test(
            trisw[cc], [o[rows, i] for i in range(3)], [d[rows, i] for i in range(3)],
            tmax[rows], torch.full((int(rows.sum()),), kc), torch.full((int(rows.sum()),), kc + 1))
        assert ok_f[:, kf].all() and ok_c[:, kc].all()
        for a, b, w in ((t_f[:, kf], t_c[:, kc], want[0][rows]), (u_f[:, kf], u_c[:, kc],
                                                                   want[2][rows]),
                        (v_f[:, kf], v_c[:, kc], want[3][rows])):
            assert torch.equal(a, b) and torch.equal(a, w)


def k9_walk(ds, rays):
    """K9 by the kernel's walk: the closest hit and each light's shadow
    ray through the tree, the shading as ``direct_trace_plain`` does it.
    Returns (4, N) as the plain version does, and the box tests of all
    the walks."""
    bounds = torch.as_tensor(np.asarray(ds.bounds_list, np.float32))
    tree = ds.tree.numpy()
    N = rays.shape[1]
    o3, d3 = rays[0:3].T.contiguous(), rays[3:6].T.contiguous()

    def mt_test(oo, dd):
        def test(cid, rows, s, e, bt):
            k = int(bounds[cid, 6])
            return mk._mt(ds.tris[cid, :, :k], [oo[rows, i] for i in range(3)],
                          [dd[rows, i] for i in range(3)], bt, s, e)
        return test

    miss = torch.full((N,), np.float32(mk._MISS))
    (best_t, wc, wk, u, v), tests = _walk(bounds, tree, o3, d3, miss, 0, ds.n_clusters,
                                          mt_test(o3, d3), group=DIRECT_GROUP)
    won = wc >= 0
    lane = torch.where(won, wc * mk.CLUSTER + wk, 0)
    tr = ds.tris.permute(1, 0, 2).reshape(9, -1)[:, lane]
    sh = ds.shade.permute(1, 0, 2).reshape(12, -1)[:, lane]
    w0 = 1.0 - u - v
    nsv = [w0 * sh[j] + u * sh[3 + j] + v * sh[6 + j] for j in range(3)]
    e1, e2 = tr[3:6], tr[6:9]
    gv = [e1[1] * e2[2] - e1[2] * e2[1], e1[2] * e2[0] - e1[0] * e2[2],
          e1[0] * e2[1] - e1[1] * e2[0]]
    att = torch.where(won, torch.stack(nsv + gv + [sh[9], sh[10], sh[11]]), 0.0)
    o, d = [rays[i] for i in range(3)], [rays[3 + i] for i in range(3)]
    hit = best_t < mk._HIT_LIMIT
    ns = mk._normalize(att[0:3])
    ng = mk._normalize(att[3:6])
    tt = torch.where(hit, best_t, 0.0)
    p = [o[i] + d[i] * tt for i in range(3)]
    cos_i = -mk._dot(ns, d)
    pscale = torch.clamp(torch.maximum(torch.abs(p[0]), torch.maximum(
        torch.abs(p[1]), torch.abs(p[2]))), min=1.0)
    zeros = torch.zeros(N)
    L = [zeros, zeros, zeros]
    ray_n = zeros + 1.0
    for lpos_int in ds.lights_list:
        lpos, lint = lpos_int[:3], lpos_int[3:]
        to_l = [lpos[i] - p[i] for i in range(3)]
        dist2 = torch.clamp(mk._dot(to_l, to_l), min=1e-20)
        dist = torch.sqrt(dist2)
        inv_dist = 1.0 / dist
        wl = [x * inv_dist for x in to_l]
        cos_o = mk._dot(ns, wl)
        valid = hit & (cos_i > 0.0) & (cos_o > 0.0)
        ray_n = ray_n + torch.where(valid, 1.0, 0.0)
        sgn = torch.where(mk._dot(ng, wl) >= 0.0, 1.0, -1.0)
        off = 1e-4 * pscale * sgn
        so = torch.stack([p[i] + ng[i] * off for i in range(3)], 1)
        wl3 = torch.stack(wl, 1)
        tmax_s = torch.where(valid, dist * mk._SHADOW_SHRINK, 0.0)  # invalid lanes: dead
        occ, shadow = _walk(bounds, tree, so, wl3, tmax_s, 0, ds.n_clusters, mt_test(so, wl3),
                            any_hit=True, group=DIRECT_GROUP, live=valid)
        tests = {k: tests[k] + shadow[k] for k in tests}
        lit = torch.where(valid & ~occ, cos_o / dist2, 0.0) * mk._INV_PI
        L = [L[i] + att[6 + i] * lint[i] * lit for i in range(3)]
    return torch.stack(L + [ray_n]), tests


def _simple_rays(st, seed):
    c = st.camera
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(c.height), np.arange(c.width), indexing="ij")
    xy = np.stack([xs, ys], -1).reshape(-1, 2) + rng.uniform(0, 1, (c.height * c.width, 2))
    o, d = camera.sample_ray(c, torch.from_numpy(xy.astype(np.float32)))
    return torch.cat([o, d], -1).T.contiguous()


def test_k9_walk_is_bit_equal_to_the_plain_version(scenes):
    st = scenes["simple.xml"]
    ds = mk.bake_direct_scene(st)
    rays = _simple_rays(st, 2)
    got, _ = k9_walk(ds, rays)
    want = mk.direct_trace_plain(ds, rays)
    assert torch.equal(got, want)
    assert (want[3] > 1).float().mean().item() > 0.1 and (want[:3].sum(0) > 0).any()


# ---------------------------------------------------------------------------
# the tree's header, and chip_smoke.py's count of the walk
# ---------------------------------------------------------------------------

def test_a_tree_of_another_branching_is_refused(scenes):
    """The kernels walk 8-way trees only; a header that names another
    branching factor is refused where a tree is read."""
    g = scenes["simple.xml"].geometry
    tree = g.cl_tree.numpy().copy()
    assert tree[0, 2] == mk.TREE_LOG2 == 3
    tree[0, 2] = 2
    with pytest.raises(ValueError, match="branching"):
        mk.tree_levels(tree)
    ds = mk.bake_direct_scene(scenes["simple.xml"])
    with pytest.raises(ValueError, match="branching"):
        mk.DirectScene(ds.bounds, ds.tris, ds.shade, ds.lights, tree)


def _chip_smoke():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("wave", ["primary", "bounce", "shadow"])
def test_chip_smoke_counts_the_box_tests_of_k7s_walk(scenes, big_waves, wave):
    """K7's bound in chip_smoke.py counts the box tests of the kernel's
    walk: they are the emulated walk's, dead lanes included."""
    g = scenes["mesh_big_gi.xml"].geometry
    o, d, tmax = big_waves[wave]
    _, tests = k7_walk(g.cl_bounds, g.cl_trisw, g.cl_tree.numpy(), o, d, tmax)
    work = _chip_smoke().count_mesh_work(g.cl_bounds, g.cl_trisw, o, d, tmax, g.cl_tree)
    assert (work["node"], work["tree_root"], work["tree_quarter"]) == (
        tests["node"], tests["root"], tests["quarter"])
    assert work["root"] == o.shape[0] * g.cl_bounds.shape[0]


def test_chip_smoke_counts_the_box_tests_of_k9s_walk(scenes):
    """And K9's: the primaries' walk and the cast shadow rays' walks."""
    st = scenes["simple.xml"]
    ds = mk.bake_direct_scene(st)
    rays = _simple_rays(st, 3)
    _, tests = k9_walk(ds, rays)
    work = _chip_smoke().count_direct_work(ds, rays)
    assert (work["node"], work["tree_root"], work["tree_quarter"]) == (
        tests["node"], tests["root"], tests["quarter"])
    assert work["node"] + work["tree_root"] < work["root"]
