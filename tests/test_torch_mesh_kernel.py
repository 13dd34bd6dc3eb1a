"""The mesh kernels' plain PyTorch versions against tpu_rt's Pallas kernels.

K9, the direct-lighting mesh kernel: tpu_rt's kernel is built as
``pallas_mesh._direct_render_setup`` builds it (``_build_direct_kernel``
with its host live lists ``_block_live_clusters`` / ``_shadow_live_clusters``)
and run in interpret mode; both packages trace the same rays, cast through
the knot fixture from one fixed numpy jitter at 32x32.  Tolerance: at
least 99.9% of pixels within rtol 1e-4 / atol 1e-6 and the same ray
count.  What remains on the fixture: every ray agrees, the largest
relative difference is 2.5e-5 (XLA on the CPU contracts multiply-adds and
its rsqrt is not correctly rounded) and the ray counts are equal.  The
1e-3 slack is for a hit or a shadow test that sits on an edge at the ulp
level and goes the other way, and for two triangles at exactly the same
distance, visited in another order (the TPU sweeps culled tiles, the port
single rays).

K1's clustered-mesh mode: the port's plain ``film_trace`` against
``pallas_film_trace(interpret=True, tile_rows=8)`` on mesh_gi.xml at
16x16, 4 samples, depth 3, with the same SplitMix32 streams; as for the
cbox, a few lanes may branch otherwise on an ulp difference.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import tpu_rt
import tpu_rt_torch
from tpu_rt.ops import pallas_mesh, pallas_path
from tpu_rt.sensor import camera as cam_jax
from tpu_rt_torch.ops import mesh_kernel, path_kernel

torch.set_num_threads(1)

MESH = os.path.join(os.path.dirname(__file__), "assets", "mesh")
SIMPLE = os.path.join(MESH, "simple.xml")
MESH_GI = os.path.join(MESH, "mesh_gi.xml")


def jax_direct_kernel(scene, o, d, tm=pallas_mesh.DEFAULT_TM):
    """tpu_rt's K9 on rays o, d [n, 3] (numpy), in interpret mode, set up
    as ``_direct_render_setup`` does; returns (L [n, 3], ray count [n])."""
    lights, shade = pallas_mesh.bake_direct_scene(scene)
    g = scene.geometry
    n = o.shape[0]
    pad = (-n) % (tm * 128)
    o = np.concatenate([o, np.zeros((pad, 3), np.float32)])
    d = np.concatenate([d, np.tile(np.float32([[0, 0, 1]]), (pad, 1))])
    rows = (n + pad) // 128
    grid = rows // tm
    comps = [jnp.asarray(x.reshape(rows, 128)) for x in
             (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])]
    bounds = jnp.asarray(g.cl_bounds)
    big = jnp.full((rows, 128), 0.99 * pallas_mesh._BIG, jnp.float32)
    ids, nlive = pallas_mesh._block_live_clusters(bounds, comps + [big], grid, tm, 1e-4)
    p0 = np.asarray(g.tri_p0)
    pts = np.concatenate([p0, p0 + np.asarray(g.tri_e1), p0 + np.asarray(g.tri_e2)])
    lo, hi = pts.min(0), pts.max(0)
    box_pad = 2e-4 * max(1.0, float(np.abs(lo).max()), float(np.abs(hi).max()))
    ids_s, nlive_s = pallas_mesh._shadow_live_clusters(
        bounds, comps, grid, tm, lights, jnp.asarray(lo - box_pad), jnp.asarray(hi + box_pad))
    kernel = pallas_mesh._build_direct_kernel(lights, 1e-4, g.cl_tris.shape[0], grid)
    block = pl.BlockSpec((tm, 128), lambda i, *_: (i, 0), memory_space=pltpu.VMEM)
    spec = pltpu.PrefetchScalarGridSpec(num_scalar_prefetch=7, grid=(grid,),
                                        in_specs=[block] * 6, out_specs=[block] * 4)
    out = pl.pallas_call(
        kernel, out_shape=[jax.ShapeDtypeStruct((rows, 128), jnp.float32)] * 4,
        grid_spec=spec, interpret=True,
    )(ids, nlive, ids_s, nlive_s, bounds, jnp.asarray(g.cl_tris).reshape(-1, 128),
      jnp.asarray(shade).reshape(-1, 128), *comps)
    out = [np.asarray(x).reshape(-1)[:n] for x in out]
    return np.stack(out[:3], -1), out[3]


def primary_rays(scene, res, seed):
    """tpu_rt's camera rays through pixel + a fixed numpy jitter."""
    jit = np.random.default_rng(seed).uniform(0, 1, (res * res, 2)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    xy = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32) + jit
    o, d = cam_jax.sample_ray(scene.camera, jnp.asarray(xy))
    return np.asarray(o, np.float32), np.asarray(d, np.float32)


def port_direct(st, o, d):
    rays = torch.from_numpy(np.concatenate([o, d], 1).T.copy())
    out = mesh_kernel.direct_trace(mesh_kernel.bake_direct_scene(st), rays).numpy()
    return out[:3].T, out[3]


def test_direct_plain_version_matches_pallas_interpret_on_identical_rays():
    sj = tpu_rt.load_file(SIMPLE, res=32, spp=1)
    st = tpu_rt_torch.load_file(SIMPLE, res=32, spp=1)
    o, d = primary_rays(sj, 32, seed=4)
    want_L, want_n = jax_direct_kernel(sj, o, d)
    got_L, got_n = port_direct(st, o, d)
    close = np.isclose(got_L, want_L, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= 0.999, f"only {close.mean():.5f} of pixels agree"
    np.testing.assert_array_equal(got_n, want_n)
    lit = want_L.sum(-1) > 0
    assert 0.1 < lit.mean() < 0.9 and (want_n == 3).any() and (want_n == 1).any()


def test_direct_trace_cpu_uses_plain_version_without_launch():
    st = tpu_rt_torch.load_file(SIMPLE, res=8, spp=1)
    sj = tpu_rt.load_file(SIMPLE, res=8, spp=1)
    o, d = primary_rays(sj, 8, seed=1)
    rays = torch.from_numpy(np.concatenate([o, d], 1).T.copy())
    ds = mesh_kernel.bake_direct_scene(st)
    before = mesh_kernel.direct_trace.launches
    out = mesh_kernel.direct_trace(ds, rays)
    assert mesh_kernel.direct_trace.launches == before
    assert torch.equal(out, mesh_kernel.direct_trace_plain(ds, rays))


def test_direct_kernel_authored_normals():
    """Twin of tests/test_pallas_mesh.py::test_fused_direct_kernel_authored_normals
    on the in-repo knot: a flat quad with vertex normals tilted toward -x
    and +x shades brighter on the side the +x light favours (world +x
    lands on the image's left), and agrees with tpu_rt's kernel there."""
    import tempfile

    t = 0.6
    nl = np.asarray([-t, 0, 1.0]) / np.hypot(t, 1.0)
    nr = np.asarray([t, 0, 1.0]) / np.hypot(t, 1.0)
    verts = np.asarray([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    normals = np.stack([nl, nr, nr, nl]).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        obj = os.path.join(tmp, "quad.obj")
        with open(obj, "w") as f:
            for v in verts:
                f.write("v %f %f %f\n" % tuple(v))
            for n_ in normals:
                f.write("vn %f %f %f\n" % tuple(n_))
            for fc in faces + 1:
                f.write("f %d//%d %d//%d %d//%d\n" % (fc[0], fc[0], fc[1], fc[1], fc[2], fc[2]))

        def desc(st):
            return {
                "type": "scene",
                "integrator": {"type": "direct"},
                "sensor": {"type": "perspective", "fov": 60,
                           "to_world": st().look_at(origin=[0, 0, 3], target=[0, 0, 0],
                                                    up=[0, 1, 0]),
                           "film": {"type": "hdrfilm", "width": 32, "height": 32,
                                    "rfilter": {"type": "box"}}},
                "quad": {"type": "obj", "filename": obj, "bsdf": {"type": "diffuse"}},
                # far-away filler: the scene needs > 192 triangles for clusters
                "filler": {"type": "ply", "filename": os.path.join(MESH, "knot.ply"),
                           "to_world": st().translate([50, 0, 0]),
                           "bsdf": {"type": "diffuse"}},
                "light": {"type": "point", "position": [2, 0, 4], "intensity": 60.0},
            }

        sj = tpu_rt.load_dict(desc(tpu_rt.ScalarTransform4f))
        st = tpu_rt_torch.load_dict(desc(tpu_rt_torch.ScalarTransform4f))
    assert st.geometry.cl_tris is not None
    img = mesh_kernel.mesh_direct_render(st, spp=4, seed=1, device="cpu").numpy()
    old = pallas_mesh.INTERPRET
    pallas_mesh.INTERPRET = True
    try:
        imj = np.asarray(pallas_mesh.mesh_direct_render(sj, spp=4, seed=1))
    finally:
        pallas_mesh.INTERPRET = old
    bright, dim = img[12:20, 4:12].mean(), img[12:20, 20:28].mean()
    assert bright > 1.3 * dim, (bright, dim)
    bj, dj = imj[12:20, 4:12].mean(), imj[12:20, 20:28].mean()
    assert abs(bright - bj) / bj < 0.1
    assert abs(dim - dj) / max(dj, 1e-9) < 0.2


RES, K, DEPTH, SEED = 16, 4, 3, 5


def test_mesh_mode_plain_version_matches_pallas_interpret():
    sj = tpu_rt.load_file(MESH_GI, res=RES, spp=K).replace(max_depth=DEPTH)
    st = tpu_rt_torch.load_file(MESH_GI, res=RES, spp=K).replace(max_depth=DEPTH)
    accs, nrays = pallas_path.pallas_film_trace(
        pallas_path.bake_scene(sj), sj.camera, SEED, K, tile_rows=8, interpret=True)
    n = RES * RES
    want = np.stack([np.asarray(a).reshape(-1)[:n] for a in accs]
                    + [np.asarray(nrays).reshape(-1)[:n]])
    tables = path_kernel.pack_tables(path_kernel.bake_scene(st), st.camera, 8, "cpu")
    assert tables.hdr_list[path_kernel.HDR_MESH_C] == 32
    got = path_kernel.film_trace(tables, SEED, K).numpy()
    assert got.shape == want.shape
    close = np.isclose(got, want, rtol=1e-4, atol=1e-6)
    assert close.mean() >= 0.99, f"only {close.mean():.4f} of entries agree"
    np.testing.assert_allclose(got[:-1].sum(1), want[:-1].sum(1), rtol=1e-3, atol=1e-6)
    assert abs(got[-1].sum() - want[-1].sum()) <= 0.01 * want[-1].sum()
    assert got[:3].sum() > 0


def test_mesh_emissive_tris_stay_unrolled():
    """Twin of tests/test_pallas_mesh_path.py::test_mesh_emissive_tris_stay_unrolled:
    the area light's triangles are not in the mesh tables but unrolled
    prims, and em_tris points at them in the compacted prim list."""
    bs = path_kernel.bake_scene(tpu_rt_torch.load_file(MESH_GI, res=8, spp=1))
    assert bs.mesh is not None
    kinds = [p.kind for p in bs.prims]
    assert kinds.count("tri") == 2 and kinds.count("rect") == 1
    assert [tp for tp, _ in bs.em_tris[0]] == [0, 1]
    assert all(bs.prims[tp].emitter == 0 for tp, _ in bs.em_tris[0])
    assert int(bs.mesh["tri_mask"].sum()) == 2240
