"""The mesh fixture's scene state in the port against tpu_rt's.

Both packages load ``tests/assets/mesh/simple.xml`` (the knot, direct
integrator, two point lights) and ``mesh_gi.xml`` (the knot over a floor
under an area light, path tracing); the PLY reader, the world-space
triangles and vertex normals, the BVH and the mesh cluster tables must be
byte-equal, since the kernels' cluster order and bounds come from them.
The camera ray generator and the pixel-aligned splat are compared at
float32 rounding.
"""

import os

import numpy as np
import pytest
import torch

import tpu_rt
import tpu_rt_torch
from tpu_rt.ops import pallas_mesh, pallas_path
from tpu_rt.scene.ply import load_ply as load_ply_jax
from tpu_rt.sensor import camera as cam_jax
from tpu_rt.sensor import film as film_jax
from tpu_rt_torch.geometry.bvh import build_bvh
from tpu_rt_torch.ops import mesh_kernel, path_kernel
from tpu_rt_torch.scene.ply import load_ply
from tpu_rt_torch.sensor import camera, film

torch.set_num_threads(1)

MESH = os.path.join(os.path.dirname(__file__), "assets", "mesh")
KNOT = os.path.join(MESH, "knot.ply")
SIMPLE = os.path.join(MESH, "simple.xml")
MESH_GI = os.path.join(MESH, "mesh_gi.xml")
GEOMETRY_FIELDS = ("tri_p0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2", "tri_shape",
                   "prim_order", "bvh_a", "bvh_b", "bvh_count",
                   "cl_tris", "cl_bounds", "cl_prim", "cl_trisw")


def _same_mesh(got, want):
    assert set(got) == set(want)
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
        else:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


def test_ply_reader_matches_tpu_rt_on_the_fixture():
    got, want = load_ply(KNOT), load_ply_jax(KNOT)
    _same_mesh(got, want)
    assert got["faces"].shape == (2240, 3) and got["normals"].shape == (1120, 3)


def _write_ply(path, fmt, verts, normals, faces):
    head = [f"ply\nformat {fmt} 1.0\ncomment quad test\nelement vertex {len(verts)}\n",
            "property float x\nproperty float y\nproperty float z\n",
            "property float nx\nproperty float ny\nproperty float nz\n",
            f"element face {len(faces)}\nproperty list uchar int vertex_indices\nend_header\n"]
    with open(path, "wb") as f:
        f.write("".join(head).encode())
        if fmt == "ascii":
            for v, n in zip(verts, normals):
                f.write((" ".join(f"{x:.7g}" for x in list(v) + list(n)) + "\n").encode())
            for fc in faces:
                f.write((f"{len(fc)} " + " ".join(str(i) for i in fc) + "\n").encode())
        else:
            f.write(np.concatenate([verts, normals], 1).astype("<f4").tobytes())
            for fc in faces:
                f.write(np.uint8(len(fc)).tobytes() + np.asarray(fc, "<i4").tobytes())


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian"])
def test_ply_reader_matches_tpu_rt_with_a_quad(tmp_path, fmt):
    """A triangle and a quad face (fan-triangulated), in both encodings."""
    rng = np.random.default_rng(3)
    verts = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    normals = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    path = str(tmp_path / "quad.ply")
    _write_ply(path, fmt, verts, normals, [(0, 1, 2), (1, 2, 3, 4)])
    got, want = load_ply(path), load_ply_jax(path)
    _same_mesh(got, want)
    np.testing.assert_array_equal(got["faces"], [[0, 1, 2], [1, 2, 3], [1, 3, 4]])


@pytest.fixture(scope="module", params=["simple", "mesh_gi"])
def both(request):
    path = SIMPLE if request.param == "simple" else MESH_GI
    return request.param, tpu_rt.load_file(path, res=16, spp=4), tpu_rt_torch.load_file(path, res=16, spp=4)


def test_fixture_geometry_equals_tpu_rt(both):
    _, sj, st = both
    for k in GEOMETRY_FIELDS:
        want = np.asarray(getattr(sj.geometry, k))
        got = getattr(st.geometry, k).numpy()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), k
    assert st.geometry.cl_tris.shape[0] <= mesh_kernel.DIRECT_C


def test_fixture_is_in_both_kernels_scopes(both):
    """simple.xml is in K9's scope in both packages; mesh_gi.xml takes K1's
    clustered-mesh mode with the two light triangles and the floor
    unrolled."""
    name, sj, st = both
    if name == "simple":
        assert pallas_mesh.bake_direct_scene(sj) is not None
        assert mesh_kernel.bake_direct_scene(st) is not None
        assert sj.geometry.cl_tris.shape[0] == 48
    else:
        bj, bt = pallas_path.bake_scene(sj), path_kernel.bake_scene(st)
        assert bj.mesh is not None and bt.mesh is not None
        assert bt.mesh["bounds"].shape[0] == bj.mesh["n_clusters"] == 32
        for k in ("bounds", "trisw", "nrm"):
            assert bt.mesh[k].tobytes() == np.asarray(bj.mesh[k], np.float32).tobytes(), k
        assert bt.mesh["bsdf"] == bj.mesh["bsdf"]
        assert [p.kind for p in bt.prims] == [p.kind for p in bj.prims] == ["tri", "tri", "rect"]
        assert bt.em_tris == bj.em_tris


def _canonical(bvh):
    """The tree as a depth-first list of (box, leaf range), so that two
    builders that number their nodes differently compare equal."""
    out, stack = [], [0]
    while stack:
        ni = stack.pop()
        box = tuple(bvh["node_min"][ni].tolist() + bvh["node_max"][ni].tolist())
        if bvh["count"][ni] > 0:
            out.append((box, int(bvh["a"][ni]), int(bvh["count"][ni])))
        else:
            out.append((box, -1, 0))
            stack += [int(bvh["b"][ni]), int(bvh["a"][ni])]
    return out


def test_native_and_numpy_bvh_builders_agree_on_the_fixture():
    st = tpu_rt_torch.load_file(MESH_GI, res=16, spp=4)
    g = st.geometry
    p0 = g.tri_p0.numpy()
    p1, p2 = p0 + g.tri_e1.numpy(), p0 + g.tri_e2.numpy()
    lo = np.minimum(np.minimum(p0, p1), p2) - 1e-6
    hi = np.maximum(np.maximum(p0, p1), p2) + 1e-6
    native, plain = build_bvh(lo, hi), build_bvh(lo, hi, use_native=False)
    np.testing.assert_array_equal(native["prim_order"], plain["prim_order"])
    assert _canonical(native) == _canonical(plain)
    assert native["a"].shape == plain["a"].shape


def test_sample_ray_matches_tpu_rt():
    sj = tpu_rt.load_file(SIMPLE, res=16, spp=1)
    st = tpu_rt_torch.load_file(SIMPLE, res=16, spp=1)
    xy = np.random.default_rng(0).uniform(0, 16, (300, 2)).astype(np.float32)
    oj, dj = cam_jax.sample_ray(sj.camera, xy)
    ot, dt = camera.sample_ray(st.camera, torch.from_numpy(xy))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=0)
    # XLA's reciprocal and fused multiply-adds differ from torch by an ulp
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=3e-7)


@pytest.mark.parametrize("filter_type", [0, 1, 2], ids=["box", "tent", "gaussian"])
def test_splat_aligned_matches_tpu_rt(filter_type):
    """Two passes batched in one call against two calls of tpu_rt's."""
    rng = np.random.default_rng(filter_type)
    H, W = 6, 7
    jit = rng.uniform(0, 1, (2, H, W, 2)).astype(np.float32)
    vals = rng.uniform(0, 2, (2, H, W, 3)).astype(np.float32)
    act = rng.uniform(0, 1, (2, H, W)) > 0.2
    fv, fw = np.zeros((H, W, 3), np.float32), np.zeros((H, W), np.float32)
    for i in range(2):
        fv, fw = film_jax.splat_aligned(fv, fw, jit[i], vals[i], act[i], filter_type)
    tv, tw = film.splat_aligned(torch.zeros(H, W, 3), torch.zeros(H, W), torch.from_numpy(jit),
                                torch.from_numpy(vals), torch.from_numpy(act), filter_type)
    np.testing.assert_allclose(tv.numpy(), np.asarray(fv), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(fw), rtol=1e-6, atol=1e-6)
