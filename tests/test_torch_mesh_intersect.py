"""The clustered mesh-intersect kernel's plain version (K7 / K8) against
tpu_rt's ``pallas_mesh.mesh_intersect`` in interpret mode, on the CPU.

Both packages build the same cluster tables (checked), and the same
numpy-seeded rays go through tpu_rt's kernel (its host live lists, its
tile culls, its chained segments) and through
``mesh_kernel.mesh_intersect_plain`` (per-ray culls, one call over all
clusters).  Tolerance, as tests/test_pallas_mesh.py:221-270 holds tpu_rt's
kernel: hit / miss equal, the triangle equal wherever the closest hit is
unambiguous (the second-nearest hit more than 1e-3 behind), t within rtol
2e-5 (XLA on the CPU contracts multiply-adds into FMAs; the TPU's 4-wide
unroll tests a few triangles outside a ray's live span, which can only
decide exact ties).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpu_rt
import tpu_rt_torch
from tpu_rt.geometry import trace as trace_j
from tpu_rt.ops import pallas_mesh
from tpu_rt.sensor import camera as cam_j
from tpu_rt_torch.geometry import trace as trace_t
from tpu_rt_torch.geometry.bvh import build_bvh
from tpu_rt_torch.ops import mesh_kernel

torch.set_num_threads(1)
MESH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "mesh")
BIG_GI = os.path.join(MESH, "mesh_big_gi.xml")


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pallas_mesh, "INTERPRET", True)


def _port(clusters, o, d, tmax=None, **kw):
    return [x.numpy() for x in mesh_kernel.mesh_intersect(
        {k: torch.from_numpy(np.array(clusters[k])) for k in ("bounds", "trisw", "prim")},
        torch.from_numpy(o), torch.from_numpy(d),
        tmax=None if tmax is None else torch.from_numpy(tmax), **kw)]


def _jax(clusters, o, d, tmax=None):
    return [np.asarray(x) for x in pallas_mesh.mesh_intersect(
        clusters, jnp.asarray(o), jnp.asarray(d), tmin=1e-4,
        tmax=None if tmax is None else jnp.asarray(tmax))]


def _mt_all(p0, e1, e2, o, d, chunk=64):
    """NumPy Moller-Trumbore over every triangle: (nearest t, its id, the
    second-nearest t), inf where none."""
    best, arg, second = [], [], []
    for s in range(0, o.shape[0], chunk):
        oo, dd = o[s:s + chunk], d[s:s + chunk]
        pv = np.cross(dd[:, None, :], e2[None])
        det = np.einsum("tk,ntk->nt", e1, pv)
        det = np.where(np.abs(det) < 1e-12, np.where(det < 0, -1e-12, 1e-12), det)
        tv = oo[:, None, :] - p0[None]
        u = np.einsum("ntk,ntk->nt", tv, pv) / det
        qv = np.cross(tv, e1[None])
        v = np.einsum("nk,ntk->nt", dd, qv) / det
        t = np.einsum("tk,ntk->nt", e2, qv) / det
        t = np.where((u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-4), t, np.inf)
        part = np.partition(t, 1, axis=1)
        best.append(part[:, 0])
        second.append(part[:, 1])
        arg.append(t.argmin(1))
    return np.concatenate(best), np.concatenate(arg), np.concatenate(second)


def _assert_agree(got, want, ref_t, ref_second):
    """hit / miss equal; prim equal where unambiguous; t within rtol 2e-5."""
    t, prim = got[0], got[1]
    hit = want[1] >= 0
    np.testing.assert_array_equal(prim >= 0, hit)
    np.testing.assert_allclose(t[hit], want[0][hit], rtol=2e-5)
    with np.errstate(invalid="ignore"):
        clear = hit & ((ref_second - ref_t) > 1e-3)
    np.testing.assert_array_equal(prim[clear], want[1][clear])
    # the barycentric rows scale the hit point's ulps by 1 / |edge| (the
    # 69k knot's triangles are about 0.03 wide): up to 2.2e-4 seen
    np.testing.assert_allclose(got[2][clear], want[2][clear], atol=5e-4)
    np.testing.assert_allclose(got[3][clear], want[3][clear], atol=5e-4)
    return hit, clear


def test_random_soup_matches_numpy_and_tpu_rt():
    """Twin of tests/test_pallas_mesh.py::test_mesh_kernel_random_soup_matches_numpy:
    random treelets make partly live quarter spans the common case."""
    rng = np.random.default_rng(11)
    T = 300
    p0 = rng.uniform(-1, 1, (T, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.25, (T, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.25, (T, 3)).astype(np.float32)
    v = np.stack([p0, p0 + e1, p0 + e2], 1)
    clusters = mesh_kernel.build_clusters(p0, e1, e2, bvh=build_bvh(v.min(1), v.max(1)))
    from tpu_rt.geometry.bvh import build_bvh as build_bvh_j

    cj = pallas_mesh.build_clusters(p0, e1, e2, bvh=build_bvh_j(v.min(1), v.max(1)))
    for k in ("tris", "trisw", "bounds", "prim"):
        np.testing.assert_array_equal(clusters[k], np.asarray(cj[k]), err_msg=k)
    N = 1024
    o = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    d = rng.normal(0, 1, (N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    got = _port(clusters, o, d)
    ref_t, ref_prim, ref_second = _mt_all(p0, e1, e2, o, d)
    ref_hit = np.isfinite(ref_t)
    assert ref_hit.sum() > 150
    np.testing.assert_array_equal(got[1] >= 0, ref_hit)
    np.testing.assert_allclose(got[0][ref_hit], ref_t[ref_hit], rtol=2e-5)
    with np.errstate(invalid="ignore"):
        clear = ref_hit & ((ref_second - ref_t) > 1e-3)
    np.testing.assert_array_equal(got[1][clear], ref_prim[clear])
    _assert_agree(got, _jax(cj, o, d), ref_t, ref_second)
    # a miss keeps the incoming tmax, u = v = 0
    assert (got[0][~ref_hit] == np.float32(0.99 * 1e8)).all()
    assert (got[2][~ref_hit] == 0).all() and (got[3][~ref_hit] == 0).all()


@pytest.fixture(scope="module")
def big_gi():
    return (tpu_rt.load_file(BIG_GI, res=16, spp=1), tpu_rt_torch.load_file(BIG_GI, res=16, spp=1))


def test_knot_69k_primaries_and_bounce_rays_with_tmax(big_gi):
    """The bunny-class fixture (800 clusters): 1024 camera primaries over
    the 16x16 film from a fixed numpy jitter, then cosine-like bounce rays from their hits
    with a per-ray tmax (some shorter than the hit, as shadow rays)."""
    sj, st = big_gi
    gj = sj.geometry
    for k in ("cl_tris", "cl_trisw", "cl_bounds", "cl_prim"):
        np.testing.assert_array_equal(getattr(st.geometry, k).numpy(), np.asarray(getattr(gj, k)))
    assert st.geometry.cl_trisw.shape[0] == 800
    cj = {"tris": gj.cl_tris, "bounds": gj.cl_bounds, "prim": gj.cl_prim, "trisw": gj.cl_trisw}
    cp = {"bounds": gj.cl_bounds, "trisw": gj.cl_trisw, "prim": gj.cl_prim}
    rng = np.random.default_rng(5)
    ys, xs = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    xy = (np.stack([xs, ys], -1).reshape(-1, 2) + rng.uniform(0, 1, (1024, 2))) / 2.0
    o, d = (np.array(x, np.float32) for x in cam_j.sample_ray(sj.camera, jnp.asarray(xy, jnp.float32)))
    p0 = np.asarray(gj.tri_p0)
    e1, e2 = np.asarray(gj.tri_e1), np.asarray(gj.tri_e2)

    want = _jax(cj, o, d)
    got = _port(cp, o, d)
    ref = _mt_all(p0, e1, e2, o, d)
    hit, _ = _assert_agree(got, want, ref[0], ref[2])
    assert 0.2 < hit.mean() < 0.9

    # bounce rays from the primary hits, with tmax
    p = o[hit] + want[0][hit, None] * d[hit]
    ng = np.cross(e1[want[1][hit]], e2[want[1][hit]])
    ng /= np.linalg.norm(ng, axis=1, keepdims=True)
    side = -np.sign((ng * d[hit]).sum(1, keepdims=True))
    ob = (p + ng * side * 1e-4 * np.maximum(1.0, np.abs(p).max(1, keepdims=True))).astype(np.float32)
    db = rng.normal(size=ob.shape) + ng * side * 1.2
    db = (db / np.linalg.norm(db, axis=1, keepdims=True)).astype(np.float32)
    tmax = rng.uniform(0.05, 3.0, ob.shape[0]).astype(np.float32)
    want = _jax(cj, ob, db, tmax)
    got = _port(cp, ob, db, tmax)
    ref_t, _, ref_second = _mt_all(p0, e1, e2, ob, db)
    ref_t = np.where(ref_t < tmax, ref_t, np.inf)
    hit, clear = _assert_agree(got, want, ref_t, ref_second)
    assert hit.mean() > 0.05 and clear.sum() > 10
    np.testing.assert_array_equal(got[0][~hit], tmax[~hit])


def test_chained_segments_equal_one_call_bit_for_bit(big_gi):
    """K8's one-call form and K7's per-segment chain: a call over all 800
    clusters equals the chain over [0, 128), [128, 256), ..., each taking
    the last call's t as its tmax, merged where a segment hit."""
    _, st = big_gi
    g = st.geometry
    cp = trace_t.mesh_clusters(g)
    rng = np.random.default_rng(6)
    o = torch.from_numpy((rng.normal(size=(512, 3)) * 2.5).astype(np.float32))
    d = torch.from_numpy((rng.normal(size=(512, 3)) * 0.5).astype(np.float32)) - o
    d = d / d.norm(dim=1, keepdim=True)
    tmax = torch.from_numpy(rng.uniform(0.5, 8.0, 512).astype(np.float32))
    one = mesh_kernel.mesh_intersect(cp, o, d, tmax=tmax)
    best = None
    for c0 in range(0, 800, 128):
        seg = mesh_kernel.mesh_intersect(cp, o, d, tmax=tmax if best is None else best[0],
                                         c0=c0, c1=min(c0 + 128, 800))
        if best is None:
            best = seg
        else:
            closer = seg[1] >= 0
            best = tuple(torch.where(closer, a, b) for a, b in zip(seg, best))
    assert int((one[1] >= 0).sum()) > 100
    for a, b, name in zip(one, best, ("t", "prim", "u", "v")):
        assert torch.equal(a, b), name


def test_mixed_mesh_and_analytic_dispatch_matches_tpu_rt():
    """ray_intersect_hit on a mesh + sphere scene: K7 over the knot, the
    sphere merged in against its best t (tpu_rt's _trace_mesh_pallas)."""
    def desc(st):
        return {
            "type": "scene", "integrator": {"type": "path"},
            "knot": {"type": "ply", "filename": os.path.join(MESH, "knot.ply"),
                     "bsdf": {"type": "diffuse"}},
            "ball": {"type": "sphere", "center": [0.3, 0.2, 1.6], "radius": 0.6},
        }

    sj, st = tpu_rt.load_dict(desc(tpu_rt.ScalarTransform4f)), tpu_rt_torch.load_dict(
        desc(tpu_rt_torch.ScalarTransform4f))
    rng = np.random.default_rng(3)
    o = (rng.normal(size=(512, 3)) * 4.0).astype(np.float32)
    d = (rng.normal(size=(512, 3)) * 0.5).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    assert trace_j._pallas_mesh_available(sj.geometry)
    hj = trace_j.ray_intersect_hit(sj.geometry, jnp.asarray(o), jnp.asarray(d))
    before = mesh_kernel.mesh_intersect.launches
    ht = trace_t.ray_intersect_hit(st.geometry, torch.from_numpy(o), torch.from_numpy(d))
    assert mesh_kernel.mesh_intersect.launches == before  # the plain version on the CPU
    np.testing.assert_array_equal(ht.prim.numpy(), np.asarray(hj.prim))
    np.testing.assert_allclose(ht.t.numpy(), np.asarray(hj.t), rtol=2e-5, atol=1e-6)
    assert (ht.prim.numpy() == st.geometry.n_tris).any()  # the sphere wins somewhere
    assert ((ht.prim.numpy() >= 0) & (ht.prim.numpy() < st.geometry.n_tris)).any()


def test_wrapper_contract():
    st = tpu_rt_torch.load_file(os.path.join(MESH, "simple.xml"), res=8, spp=1)
    cp = trace_t.mesh_clusters(st.geometry)
    o = torch.tensor([[0.0, 2.5, 5.0]]).repeat(4, 1).requires_grad_()
    d = torch.tensor([[0.0, -0.45, -0.9], [0.0, 1.0, 0.0], [0.0, -0.45, -0.9], [1.0, 0, 0]])
    t, prim, u, v = mesh_kernel.mesh_intersect(cp, o, d)
    assert prim.dtype == torch.int32 and not t.requires_grad
    assert prim[0] >= 0 and prim[1] == -1 and t[1] == np.float32(0.99 * 1e8)
    t2, prim2, _, _ = mesh_kernel.mesh_intersect(cp, o, d, tmax=float(t[0]) * 0.5)
    assert prim2[0] == -1 and t2[0] == np.float32(float(t[0]) * 0.5)
    with pytest.raises(ValueError, match="cluster range"):
        mesh_kernel.mesh_intersect(cp, o, d, c0=2, c1=1)
