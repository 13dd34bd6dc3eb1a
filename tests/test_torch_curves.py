"""B-spline curves (``bsplinecurve``) in tpu_rt_torch against tpu_rt, on
the CPU, on the shadow-art fixture (tests/assets/shadow_art/, written by
make_shadow_art.py).

* ``flatten_bspline`` and ``tessellate_bspline_tube`` equal to tpu_rt's.
* The exact mode's CURVE prims (transforms, radii over length), their
  exact world boxes and the BVH built on them, byte-equal to tpu_rt's; a
  span shorter than its radius, whose end spheres the [-1, 1]^3 image
  does not hold.
* The hit normals of curve pixels: unit length, facing the camera
  (tests/test_curves.py:72-106's check).
* The exact render against the tube mesh of ``curve_mode="mesh"`` at
  tpu_rt's bar (tests/test_curves.py:109-135: relative RMS of 8x8 block
  means under 0.05).
* The two NotImplementedErrors (a non-uniform scale; a radius that varies
  faster than arc length).
* The routes: the exact mode's 198 prims through the chunked sweep, the
  mesh mode's 6 148 triangles through K7 (the plain version here), each
  ``path_trace`` held to tpu_rt's on identical rays and threefry draws
  (tpu_rt's K7 in interpret mode): the rays cast equal, 99% of the lanes
  within rtol 1e-4 / atol 1e-6.  A hit on a span is ill-conditioned in
  float32 (the span's frame scales world units by 1 / h, about 80 here),
  so XLA's contracted arithmetic moves a curve hit's normal; a light
  sample at grazing incidence then differs by a few percent (a few lanes
  in 512, each hit and shadow ray itself equal).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tpu_rt
import tpu_rt_torch
from tpu_rt.integrator import path as path_j
from tpu_rt.ops import pallas_mesh
from tpu_rt.scene import curves as curves_j
from tpu_rt.sensor import camera as cam_j
from tpu_rt_torch.geometry import trace as trace_t
from tpu_rt_torch.integrator import path as path_t
from tpu_rt_torch.ops import mesh_kernel
from tpu_rt_torch.scene import build as build_t
from tpu_rt_torch.scene import curves as curves_t
from tpu_rt_torch.scene.types import CURVE
from tpu_rt_torch.sensor import camera as cam_t

HERE = os.path.dirname(os.path.abspath(__file__))
ART = os.path.join(HERE, "assets", "shadow_art")
XML = os.path.join(ART, "shadow_art.xml")
WIRE = os.path.join(ART, "wire.txt")

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pallas_mesh, "INTERPRET", True)


def test_flatten_and_tessellate_equal_to_tpu_rt():
    got, want = curves_t.flatten_bspline(WIRE), curves_j.flatten_bspline(WIRE)
    assert got.shape == (193, 4) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    for a, b in zip(curves_t.tessellate_bspline_tube(WIRE), curves_j.tessellate_bspline_tube(WIRE)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    v, f, n = curves_t.tessellate_bspline_tube(WIRE)
    assert f.shape == (6144, 3) and v.shape == (385 * 8, 3)


GEOM_KEYS = ("an_type", "an_to_world", "an_to_object", "an_shape", "an_param", "tri_p0",
             "tri_e1", "tri_e2", "bvh_min", "bvh_max", "bvh_a", "bvh_b", "bvh_count",
             "prim_order")


def test_shadow_art_prims_boxes_and_bvh_byte_equal_to_tpu_rt():
    sj, st = tpu_rt.load_file(XML), tpu_rt_torch.load_file(XML)
    g = st.geometry
    assert (g.n_tris, g.n_analytic) == (4, 194) and st.integrator == sj.integrator
    curve = g.an_type == CURVE
    assert int(curve.sum()) == 192 and bool((g.an_param[curve] > 0).all())
    assert bool((g.an_param[~curve] == 0).all())
    for k in GEOM_KEYS:
        a, b = np.asarray(getattr(sj.geometry, k)), getattr(g, k).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k
    # the BVH's leaves hold every CURVE prim's end spheres
    seg = {k: v.numpy() for k, v in _segments(g).items()}
    lo = np.minimum(seg["a"] - seg["r0"][:, None], seg["b"] - seg["r1"][:, None])
    hi = np.maximum(seg["a"] + seg["r0"][:, None], seg["b"] + seg["r1"][:, None])
    assert (g.bvh_min[0].numpy() <= lo.min(0)).all() and (g.bvh_max[0].numpy() >= hi.max(0)).all()


def _segments(g):
    from tpu_rt_torch.integrator.projective import curve_segments

    return curve_segments(g)


def test_exact_box_holds_a_span_shorter_than_its_radius(tmp_path):
    """A thick rod at 4 samples a span: r / h > 1, the [-1, 1]^3 image of
    a span misses its end spheres, the exact box (the one the BVH gets,
    as in tpu_rt) holds them."""
    f = tmp_path / "rod.txt"
    ys = np.linspace(-0.1, 0.1, 7)
    f.write_text("\n".join(f"0.3 {y:.6f} 0.2 0.05" for y in ys) + "\n")
    desc = {"type": "scene", "rod": {"type": "bsplinecurve", "filename": str(f)}}
    st = tpu_rt_torch.load_dict(desc)
    g = st.geometry
    seg = {k: v.numpy() for k, v in _segments(g).items()}
    h = np.linalg.norm(seg["b"] - seg["a"], axis=-1)
    assert (seg["r0"] / h > 1).all()
    b = build_t._Builder()
    tw = g.an_to_world.numpy()
    cube_lo, cube_hi = b._prim_bounds(np.zeros((0, 3), np.float32), None, None, tw,
                                      [None] * tw.shape[0])
    lo = np.minimum(seg["a"] - seg["r0"][:, None], seg["b"] - seg["r1"][:, None])
    assert (cube_lo > lo + 1e-3).any()  # the cube misses a cap
    assert (g.bvh_min[0].numpy() <= lo.min(0)).all()
    sj = tpu_rt.load_dict(desc)
    for k in GEOM_KEYS:
        assert np.asarray(getattr(sj.geometry, k)).tobytes() == getattr(g, k).numpy().tobytes(), k


def test_curve_hit_normals_unit_and_facing_the_camera():
    st = tpu_rt_torch.load_file(XML, resx=192, resy=96)
    g = st.geometry
    H, W = st.camera.height, st.camera.width
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    xy = torch.stack([xs, ys], -1).reshape(-1, 2).to(torch.float32) + 0.5
    o, d = cam_t.sample_ray(st.camera, xy)
    si = trace_t.ray_intersect(st, o, d)
    aid = torch.clamp(si.prim.long() - g.n_tris, 0, g.n_analytic - 1)
    is_curve = si.valid & (si.prim >= g.n_tris) & (g.an_type[aid] == CURVE)
    assert int(is_curve.sum()) > 20
    n = si.n[is_curve]
    assert float((n.norm(dim=-1) - 1).abs().max()) < 1e-4
    assert bool(((n * d[is_curve]).sum(-1) < 1e-4).all())


def _blocks(x):
    return x.reshape(8, 4, 16, 4, 3).mean(axis=(1, 3))


def test_exact_matches_mesh_mode_render():
    exact = tpu_rt_torch.load_file(XML, resx=64, resy=32)
    mesh = tpu_rt_torch.load_file(XML, curve_mode="mesh", resx=64, resy=32)
    assert mesh.geometry.n_tris == 6148 and mesh.geometry.cl_trisw is not None
    img_e = tpu_rt_torch.render(exact, spp=32, seed=5, device="cpu").numpy()
    img_m = tpu_rt_torch.render(mesh, spp=32, seed=5, device="cpu").numpy()
    assert np.isfinite(img_e).all() and np.isfinite(img_m).all()
    be, bm = _blocks(img_e), _blocks(img_m)
    rel = np.sqrt(((be - bm) ** 2).mean()) / max(bm.mean(), 1e-9)
    assert rel < 0.05, f"exact-vs-mesh curve render rel {rel:.4f}"


def test_the_two_not_implemented_errors(tmp_path):
    st = tpu_rt_torch.ScalarTransform4f
    desc = {"type": "scene", "wire": {"type": "bsplinecurve", "filename": WIRE,
                                      "to_world": st().scale([1.0, 2.0, 1.0])}}
    with pytest.raises(NotImplementedError, match="non-uniform"):
        tpu_rt_torch.load_dict(desc)
    assert tpu_rt_torch.load_dict(desc, curve_mode="mesh").geometry.n_tris == 6144
    f = tmp_path / "jump.txt"
    f.write_text("0 0 0 0.01\n0 0.01 0 0.01\n0 0.02 0 0.5\n0 0.03 0 0.01\n0 0.04 0 0.01\n")
    with pytest.raises(NotImplementedError, match="faster than arc"):
        tpu_rt_torch.load_dict({"type": "scene", "w": {"type": "bsplinecurve",
                                                       "filename": str(f)}})
    with pytest.raises(ValueError, match="curve_mode"):
        tpu_rt_torch.load_file(XML, curve_mode="tube")


@pytest.mark.parametrize("mode", ["exact", "mesh"])
def test_routes_and_path_trace_against_tpu_rt(monkeypatch, mode):
    kw = dict(resx=32, resy=16, spp=1)
    sj = tpu_rt.load_file(XML, **kw) if mode == "exact" else None
    if mode == "mesh":
        monkeypatch.setenv("TPU_RT_CURVE_MODE", "mesh")  # tpu_rt's switch
        sj = tpu_rt.load_file(XML, **kw)
        monkeypatch.delenv("TPU_RT_CURVE_MODE")
    st = tpu_rt_torch.load_file(XML, curve_mode=mode, **kw)
    assert sj.geometry.n_tris == st.geometry.n_tris
    calls = {"chunked": 0, "k7": 0}
    chunked, k7 = trace_t._trace_chunked, mesh_kernel.mesh_intersect

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(trace_t, "_trace_chunked", count("chunked", chunked))
    monkeypatch.setattr(mesh_kernel, "mesh_intersect", count("k7", k7))
    rng = np.random.default_rng(6)
    ys, xs = np.meshgrid(np.arange(16), np.arange(32), indexing="ij")
    xy = np.stack([xs, ys], -1).reshape(-1, 2) + rng.uniform(0, 1, (512, 2))
    o, d, t0, t1 = (np.array(x) for x in cam_j.sample_ray_extents(
        sj.camera, jnp.asarray(xy, jnp.float32)))
    key = jax.random.PRNGKey(11)
    n_iters = path_t.n_bounces(st)
    uniforms = np.stack([np.asarray(jax.random.uniform(k, (o.shape[0], 8)))
                         for k in jax.random.split(key, n_iters)])
    Lj, nj = path_j.path_trace(sj, jnp.asarray(o), jnp.asarray(d), key,
                               tmin0=jnp.asarray(t0), tmax0=jnp.asarray(t1))
    Lt, nt = path_t.path_trace(st, torch.from_numpy(o), torch.from_numpy(d),
                               uniforms=torch.from_numpy(uniforms),
                               tmin0=torch.from_numpy(t0), tmax0=torch.from_numpy(t1))
    # max_depth 2 under area lights: the primaries with their shadow rays,
    # then the BSDF-sampled rays that may hit a light; one sweep each
    want = {"chunked": 3, "k7": 0} if mode == "exact" else {"chunked": 0, "k7": 3}
    assert calls == want
    Lj, Lt = np.asarray(Lj), Lt.numpy()
    assert int(nt) == int(nj)
    close = np.isclose(Lt, Lj, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, f"only {close.mean():.4f} of lanes agree"
    assert (Lj.sum(-1) > 0).mean() > 0.5
