"""The wavefront tracer's geometry against tpu_rt's, on the CPU.

Each analytic intersector of ``geometry/intersect.py``, the brute-force
route of ``geometry/trace.py`` and ``compute_interaction`` get the same
numpy-seeded rays as tpu_rt's.  Tolerance: hit / miss and the winning
prim equal wherever the closest hit is unambiguous (the second-nearest
prim more than 1e-3 behind), t, u, v, points and normals within rtol 2e-5
/ atol 1e-5 on those lanes (XLA on the CPU contracts multiply-adds into
FMAs: a few ulps, amplified where a quadratic's discriminant cancels).
The loader's tables for the shapes and BSDFs this route brings (disk,
cylinder, cone, rough conductor, null) are equal to tpu_rt's.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpu_rt
import tpu_rt_torch
from tpu_rt.geometry import intersect as isect_j
from tpu_rt.geometry import trace as trace_j
from tpu_rt_torch.geometry import intersect as isect_t
from tpu_rt_torch.geometry import trace as trace_t
from tpu_rt_torch.scene import types as TT

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_scenes import shapes_desc  # noqa: E402

torch.set_num_threads(1)
N = 2048


def _rays(seed, n=N, spread=2.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    target = rng.uniform(-0.7, 0.7, (n, 3)).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


SHAPES = {"sphere": isect_j.ray_sphere, "rectangle": isect_j.ray_rectangle,
          "disk": isect_j.ray_disk, "cylinder": isect_j.ray_cylinder,
          "cone": isect_j.ray_cone}


@pytest.mark.parametrize("name", sorted(SHAPES) + ["roundcone", "triangle"])
def test_intersector_matches_tpu_rt(name):
    o, d = _rays(7)
    tmax = np.random.default_rng(8).uniform(0.5, 6.0, N).astype(np.float32)
    args_j, args_t = [jnp.asarray(o), jnp.asarray(d)], [torch.from_numpy(o), torch.from_numpy(d)]
    if name == "roundcone":
        extra = (np.float32(0.3), np.float32(0.15))
        fn_j, fn_t = isect_j.ray_roundcone, isect_t.ray_roundcone
    elif name == "triangle":
        extra = (np.float32([-0.8, -0.6, 0.1]), np.float32([1.5, 0.2, -0.3]),
                 np.float32([0.3, 1.4, 0.4]))
        fn_j, fn_t = isect_j.ray_triangle, isect_t.ray_triangle
    else:
        extra = ()
        fn_j, fn_t = SHAPES[name], getattr(isect_t, "ray_" + name)
    want = fn_j(*args_j, *[jnp.asarray(x) for x in extra], 1e-4, jnp.asarray(tmax))
    got = fn_t(*args_t, *[torch.as_tensor(x) for x in extra], 1e-4, torch.from_numpy(tmax))
    tw, tg = np.asarray(want[0]), got[0].numpy()
    hit = tw < isect_j.INF
    np.testing.assert_array_equal(tg < isect_t.INF, hit)
    assert 0.1 < hit.mean() < 0.95
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy()[hit], np.asarray(w)[hit], rtol=2e-5, atol=1e-5)


def test_ray_aabb_matches_tpu_rt():
    o, d = _rays(9)
    invd = (1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)).astype(np.float32)
    lo, hi = np.float32([-0.5, -0.3, -0.2]), np.float32([0.4, 0.6, 0.3])
    hj, tj = isect_j.ray_aabb(jnp.asarray(o), jnp.asarray(invd), lo, hi, 1e-4, 5.0)
    ht, tt = isect_t.ray_aabb(torch.from_numpy(o), torch.from_numpy(invd), torch.from_numpy(lo),
                              torch.from_numpy(hi), 1e-4, 5.0)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=2e-5, atol=1e-5)


def _pair():
    return (tpu_rt.load_dict(shapes_desc(tpu_rt.ScalarTransform4f)),
            tpu_rt_torch.load_dict(shapes_desc(tpu_rt_torch.ScalarTransform4f)))


def _tensor_fields(obj):
    return [f.name for f in dataclasses.fields(obj) if f.type == "torch.Tensor"]


def test_loader_tables_for_the_wavefront_shapes_match_tpu_rt():
    sj, st = _pair()
    for a, b in ((sj.geometry, st.geometry), (sj.emitters, st.emitters), (sj, st)):
        for k in _tensor_fields(b):
            np.testing.assert_array_equal(getattr(b, k).numpy(), np.asarray(getattr(a, k)),
                                          err_msg=k)
    for k in ("shape_bsdf", "shape_emitter", "bsdf_type", "bsdf_params"):
        np.testing.assert_array_equal(getattr(st, k).numpy(), np.asarray(getattr(sj, k)))
    assert st.geometry.analytic_types == sj.geometry.analytic_types == (
        TT.SPHERE, TT.DISK, TT.CYLINDER, TT.CONE)
    assert st.bsdf_types_present == sj.bsdf_types_present == (
        TT.BSDF_DIFFUSE, TT.BSDF_DIELECTRIC, TT.BSDF_ROUGH_CONDUCTOR, TT.BSDF_NULL)
    p = st.bsdf_params.numpy()
    assert p[1, 9] == np.float32(0.25) and p[2, 0] == -1.0  # alpha; the mirror marker


def _scene_rays(st, seed, n=N):
    """Rays from around the scene toward its middle."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 3.0).astype(np.float32)
    target = (rng.normal(size=(n, 3)) * 0.8).astype(np.float32)
    d = target - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _unambiguous(sj, o, d):
    """Lanes whose nearest prim leads the second by more than 1e-3."""
    g = sj.geometry
    t_tri = isect_j.ray_triangle(jnp.asarray(o)[:, None], jnp.asarray(d)[:, None],
                                 g.tri_p0[None], g.tri_e1[None], g.tri_e2[None], 1e-4, 1e8)[0]
    oo = jnp.einsum("aij,nj->nai", g.an_to_object[:, :3, :3], jnp.asarray(o)) + g.an_to_object[:, :3, 3]
    od = jnp.einsum("aij,nj->nai", g.an_to_object[:, :3, :3], jnp.asarray(d))
    t_an = trace_j._analytic_sweep(g, g.an_type[None], g.an_param[None], oo, od, 1e-4, 1e8)[0]
    t_all = np.sort(np.concatenate([np.asarray(t_tri), np.asarray(t_an)], 1), 1)
    return (t_all[:, 1] - t_all[:, 0]) > 1e-3


def test_bruteforce_and_interaction_match_tpu_rt():
    sj, st = _pair()
    o, d = _scene_rays(st, 11)
    tmax = np.where(np.arange(N) % 5 == 0, 2.5, 1e8).astype(np.float32)
    hj = trace_j.ray_intersect_hit(sj.geometry, jnp.asarray(o), jnp.asarray(d), tmax=jnp.asarray(tmax))
    ht = trace_t.ray_intersect_hit(st.geometry, torch.from_numpy(o), torch.from_numpy(d),
                                   tmax=torch.from_numpy(tmax))
    clear = _unambiguous(sj, o, d)
    np.testing.assert_array_equal(ht.valid.numpy()[clear], np.asarray(hj.valid)[clear])
    np.testing.assert_array_equal(ht.prim.numpy()[clear], np.asarray(hj.prim)[clear])
    hit = clear & np.asarray(hj.valid)
    assert hit.mean() > 0.3 and len(set(ht.prim.numpy()[hit].tolist())) > 6
    assert (np.asarray(hj.valid) == ht.valid.numpy()).mean() >= 0.999
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(ht, f).numpy()[hit], np.asarray(getattr(hj, f))[hit],
                                   rtol=2e-5, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(ht.t.numpy()[~np.asarray(hj.valid) & clear], trace_t.INF)

    sij = trace_j.compute_interaction(sj, jnp.asarray(o), jnp.asarray(d), hj)
    sit = trace_t.compute_interaction(st, torch.from_numpy(o), torch.from_numpy(d), ht)
    for f in ("valid", "shape", "prim"):
        np.testing.assert_array_equal(getattr(sit, f).numpy()[clear],
                                      np.asarray(getattr(sij, f))[clear], err_msg=f)
    for f in ("t", "p", "n", "ng", "uv", "wi"):
        np.testing.assert_allclose(getattr(sit, f).numpy()[hit], np.asarray(getattr(sij, f))[hit],
                                   rtol=2e-5, atol=1e-5, err_msg=f)
    dirs = torch.from_numpy(_scene_rays(st, 12)[1])
    np.testing.assert_allclose(sit.spawn_origin(dirs).numpy()[hit],
                               np.asarray(sij.spawn_origin(jnp.asarray(dirs.numpy())))[hit],
                               rtol=2e-5, atol=1e-5)
    occ_t = trace_t.ray_test(st.geometry, torch.from_numpy(o), torch.from_numpy(d),
                             tmax=torch.from_numpy(tmax))
    np.testing.assert_array_equal(occ_t.numpy()[clear], np.asarray(hj.valid)[clear])


def test_triangle_scene_interaction_uses_vertex_normals_and_uvs():
    """compute_interaction on the cbox (triangles with uvs from the OBJ
    files, spheres): shading normals, uvs and shapes equal tpu_rt's."""
    cbox = os.path.join(os.path.dirname(__file__), "assets", "cbox", "cbox.xml")
    sj, st = tpu_rt.load_file(cbox, res=8, spp=1), tpu_rt_torch.load_file(cbox, res=8, spp=1)
    for k in ("tri_uv0", "tri_uv1", "tri_uv2", "an_param"):
        np.testing.assert_array_equal(getattr(st.geometry, k).numpy(),
                                      np.asarray(getattr(sj.geometry, k)))
    rng = np.random.default_rng(13)  # rays from inside the box
    o = rng.uniform(-0.3, 0.3, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    sij = trace_j.ray_intersect(sj, jnp.asarray(o), jnp.asarray(d))
    sit = trace_t.ray_intersect(st, torch.from_numpy(o), torch.from_numpy(d))
    clear = _unambiguous(sj, o, d) & np.asarray(sij.valid)
    assert clear.mean() > 0.8
    np.testing.assert_array_equal(sit.shape.numpy()[clear], np.asarray(sij.shape)[clear])
    for f in ("p", "n", "ng", "uv"):
        np.testing.assert_allclose(getattr(sit, f).numpy()[clear], np.asarray(getattr(sij, f))[clear],
                                   rtol=2e-5, atol=1e-5, err_msg=f)


def test_many_prims_without_cluster_tables_take_the_chunked_route():
    """Over 192 prims and no cluster tables: the chunked route, as in
    tpu_rt; the scene of 193 unit spheres in a row hits as tpu_rt's does
    (prim equal, t within 1e-5 relative: rays start within 6 of the sphere
    they aim at, where the quadratic keeps its digits)."""
    def desc(st):
        d = {"type": "scene", "integrator": {"type": "path"}}
        for i in range(193):
            d[f"s{i}"] = {"type": "sphere", "center": [i * 3.0, 0, 0], "radius": 1.0}
        return d

    sj, st = tpu_rt.load_dict(desc(tpu_rt.ScalarTransform4f)), tpu_rt_torch.load_dict(
        desc(tpu_rt_torch.ScalarTransform4f))
    assert st.geometry.cl_trisw is None
    rng = np.random.default_rng(19)
    k = rng.integers(0, 193, 252)
    target = np.stack([k * 3.0, np.zeros(252), np.zeros(252)], 1) + rng.uniform(-1.5, 1.5,
                                                                                (252, 3))
    o = np.concatenate([np.tile([[0.1, 0.2, 0.0]], (4, 1)), target + rng.uniform(-6, 6, (252, 3))]).astype(np.float32)
    d = np.concatenate([np.tile([[1.0, 0, 0]], (4, 1)), target - o[4:]])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    hj = trace_j.ray_intersect_hit(sj.geometry, jnp.asarray(o), jnp.asarray(d))
    ht = trace_t.ray_intersect_hit(st.geometry, torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(ht.prim.numpy(), np.asarray(hj.prim))
    hit = ht.prim.numpy() >= 0
    assert 0.3 < hit.mean() < 1.0 and (ht.prim.numpy()[:4] == 0).all()
    np.testing.assert_allclose(ht.t.numpy()[hit], np.asarray(hj.t)[hit], rtol=1e-5)
