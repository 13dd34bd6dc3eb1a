"""The chunked and BVH trace routes of tpu_rt_torch's ``geometry/trace.py``
against tpu_rt's functions of the same name, on the CPU, and the dispatch
between the four routes.

Both packages load the same scenes (spheres, the 2 240-triangle knot, the
two mixed) and get the same numpy-seeded rays, a few with a per-ray tmax.
tpu_rt's functions are jitted once per module (``_JAX``), so its BVH's
vmapped ``while_loop`` compiles once a scene.  Tolerance: hit or miss and
the prim equal on every ray but exact ties (two prims at the same t,
counted, and allowed only where both prims meet the ray at the same t);
on the hits u, v within 1e-4 and t within 1e-5 relative, where a sphere's
object-space quadratic keeps at least 1/100 of b^2 in its discriminant,
else 1e-4 (a sphere 0.05 across seen from 80 radii cancels up to 1 - 1e-6
of b^2, which magnifies an ulp of b or c to 7e-5 of t); XLA on the CPU
contracts multiply-adds into FMAs and takes other square roots.  tpu_rt's BVH
reports a miss at its tmax, the port's routes at INF, so t is compared on
hits.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_rt
import tpu_rt_torch
from tpu_rt.geometry import trace as trace_j
from tpu_rt_torch.geometry import trace as trace_t

torch.set_num_threads(1)

KNOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "mesh", "knot.ply")
N_RAYS = 1000


def spheres_desc(st, n, seed=3, knot=False, grid=False):
    """n spheres (radius 0.05-0.2) strewn over [-2, 2]^3 from a numpy seed,
    or, with ``grid``, unit spheres 3 apart on a grid of 100 columns in the
    plane x = 0; with ``knot`` the 2 240-triangle knot at half size in the
    middle."""
    rng = np.random.default_rng(seed)
    desc = {"type": "scene", "integrator": {"type": "path"}}
    for i in range(n):
        center = ([0.0, 3.0 * (i % 100), 3.0 * (i // 100)] if grid
                  else rng.uniform(-2, 2, 3).tolist())
        desc[f"s{i:05d}"] = {"type": "sphere", "center": center,
                             "radius": 1.0 if grid else float(rng.uniform(0.05, 0.2))}
    if knot:
        desc["knot"] = {"type": "ply", "filename": KNOT, "to_world": st().scale(0.5)}
    return desc


def _rays(seed, n=N_RAYS):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.uniform(-1, 1, (n, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = np.where(rng.uniform(size=n) < 0.3, rng.uniform(1.0, 4.0, n), 1e30)
    return o, d, tmax.astype(np.float32)


@functools.cache
def _scenes(case):
    spheres, knot = {"spheres": (300, False), "triangles": (0, True),
                     "mixed": (150, True), "mixed_big": (700, True)}[case]
    return tuple(pkg.load_dict(spheres_desc(pkg.ScalarTransform4f, spheres, knot=knot))
                 for pkg in (tpu_rt, tpu_rt_torch))


_JAX = {name: jax.jit(lambda g, o, d, tmax, _f=getattr(trace_j, name): _f(g, o, d, trace_j.RAY_EPS,
                                                                          tmax))
        for name in ("_trace_chunked", "_trace_bvh")}


def _sphere_conditioning(geom, prim, o, d):
    """b^2 / (b^2 - 4ac) of each ray's quadratic in its sphere's object
    space (float64; 1 for a triangle or a miss): the factor by which the
    discriminant's cancellation magnifies an ulp of b or c in t."""
    kappa = np.ones(len(prim))
    sph = prim >= geom.n_tris
    if sph.any():
        m = geom.an_to_object.numpy().astype(np.float64)[prim[sph] - geom.n_tris]
        oo = np.einsum("nij,nj->ni", m[:, :3, :3], o[sph]) + m[:, :3, 3]
        od = np.einsum("nij,nj->ni", m[:, :3, :3], d[sph])
        b = 2.0 * (oo * od).sum(1)
        disc = b * b - 4.0 * (od * od).sum(1) * ((oo * oo).sum(1) - 1.0)
        kappa[sph] = b * b / np.maximum(disc, 1e-30)
    return kappa


def _compare(route, case, seed):
    sj, st = _scenes(case)
    o, d, tmax = _rays(seed)
    hj = _JAX[route](sj.geometry, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))
    ht = getattr(trace_t, route)(st.geometry, torch.from_numpy(o), torch.from_numpy(d),
                                 trace_t.RAY_EPS, torch.from_numpy(tmax))
    pj, pt = np.asarray(hj.prim), ht.prim.numpy()
    tj, tt_ = np.asarray(hj.t), ht.t.numpy()
    np.testing.assert_array_equal(pt >= 0, pj >= 0)
    hit = pj >= 0
    assert 0.2 < hit.mean() < 0.95  # both hits and misses, the tmax cut some
    tight = hit & (_sphere_conditioning(st.geometry, pt, o, d) <= 100.0)
    np.testing.assert_allclose(tt_[tight], tj[tight], rtol=1e-5)
    np.testing.assert_allclose(tt_[hit], tj[hit], rtol=1e-4)
    differ = hit & (pt != pj)
    if differ.any():  # only exact ties: both prims meet the ray at the same t
        o_, d_ = torch.from_numpy(o[differ]), torch.from_numpy(d[differ])
        t_pair = [trace_t._intersect_prim(st.geometry, torch.from_numpy(p[differ]).long(), o_, d_,
                                          trace_t.RAY_EPS, trace_t.INF)[0].numpy()
                  for p in (pt, pj)]
        np.testing.assert_allclose(t_pair[0], t_pair[1], rtol=1e-6)
    assert differ.sum() <= 0.001 * N_RAYS, f"{differ.sum()} ties"
    same = hit & ~differ
    for a, b in ((ht.u, hj.u), (ht.v, hj.v)):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same], rtol=0, atol=1e-4)
    return ht


@pytest.mark.parametrize("case", ["spheres", "triangles", "mixed"])
@pytest.mark.parametrize("route", ["_trace_chunked", "_trace_bvh"])
def test_route_matches_tpu_rt(route, case):
    _compare(route, case, seed={"spheres": 1, "triangles": 2, "mixed": 3}[case])


def test_bvh_node_boxes_match_tpu_rt():
    """The node boxes the BVH walk tests are tpu_rt's, for the same scene,
    and carried through ``scene_from_arrays``."""
    from test_torch_scene import tpu_rt_arrays
    from tpu_rt_torch.scene import scene_from_arrays

    sj, st = _scenes("mixed")
    for k in ("bvh_min", "bvh_max", "bvh_a", "bvh_b", "bvh_count", "prim_order"):
        np.testing.assert_array_equal(getattr(st.geometry, k).numpy(),
                                      np.asarray(getattr(sj.geometry, k)), err_msg=k)
    carried = scene_from_arrays(*tpu_rt_arrays(sj))
    assert torch.equal(carried.geometry.bvh_min, st.geometry.bvh_min)
    assert torch.equal(carried.geometry.bvh_max, st.geometry.bvh_max)


def test_chunks_and_bvh_agree_with_brute_force_on_many_prims():
    """Over 192 prims the brute-force sweep is off the dispatch, but still
    callable: the three routes find the same hits on 850 prims of
    spheres and triangles (t within 1e-6 relative: the same arithmetic
    but for the component form and the chunk order)."""
    _, st = _scenes("mixed_big")
    o, d, tmax = (torch.from_numpy(x) for x in _rays(5))
    g = st.geometry
    hb = trace_t._trace_bruteforce(g, o, d, trace_t.RAY_EPS, tmax)
    for route in (trace_t._trace_chunked, trace_t._trace_bvh):
        h = route(g, o, d, trace_t.RAY_EPS, tmax)
        assert torch.equal(h.prim, hb.prim)
        hit = hb.prim >= 0
        torch.testing.assert_close(h.t[hit], hb.t[hit], rtol=1e-6, atol=0)
        assert torch.equal(h.t[~hit], hb.t[~hit])


@pytest.mark.parametrize("n,route", [(192, "_trace_bruteforce"), (193, "_trace_chunked"),
                                     (8192, "_trace_chunked"), (8193, "_trace_bvh")])
def test_dispatch_by_prim_count(monkeypatch, n, route):
    """tpu_rt's thresholds: brute force up to 192 prims, chunks up to
    8 192 (CHUNKED_MAX_PRIMS), the BVH above; a grid of unit spheres,
    rays along +x onto the first and the last and between two."""
    st = tpu_rt_torch.load_dict(spheres_desc(tpu_rt_torch.ScalarTransform4f, n, grid=True))
    assert st.geometry.n_analytic == n and st.geometry.cl_trisw is None
    called = []
    for name in ("_trace_bruteforce", "_trace_chunked", "_trace_bvh", "_trace_mesh"):
        real = getattr(trace_t, name)
        monkeypatch.setattr(trace_t, name,
                            lambda *a, _r=real, _n=name, **k: (called.append(_n), _r(*a, **k))[1])
    last = [3.0 * ((n - 1) % 100), 3.0 * ((n - 1) // 100)]
    o = torch.tensor([[-5.0, 0.0, 0.0], [-5.0, 0.5, 0.0], [5.0] + last, [-5.0, 1.5, 0.0]])
    d = torch.tensor([[1.0, 0, 0], [1.0, 0, 0], [-1.0, 0, 0], [1.0, 0, 0]])
    hit = trace_t.ray_intersect_hit(st.geometry, o, d)
    assert called == [route]
    assert hit.prim.tolist() == [0, 0, n - 1, -1]
    torch.testing.assert_close(hit.t[:3], torch.tensor([4.0, 5.0 - 0.75 ** 0.5, 4.0]),
                               rtol=1e-6, atol=0)
