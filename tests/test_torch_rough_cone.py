"""The rough conductor's lane and cone prims of the film kernels' plain
versions against tpu_rt, on the CPU.

* The cone branch of the prim sweep (``path_kernel._sweep``, shared with
  the acquisition kernel) against ``pallas_path._sweep`` on the same rays:
  rays aimed at random points of the cone and rays through its apex agree
  on every lane (prim, t within rtol 1e-5, the normal within 1e-5); rays
  parallel to the cone's side make the quadratic's leading coefficient
  vanish, where the nearer root is a difference of nearly equal numbers
  over that coefficient, so an ulp of XLA's contracted multiply-adds moves
  it: there at least 99% of the cone's lanes and 99.9% of all agree.
* The bake of cbox_rough.xml, cbox_pol_rough.xml and
  ``envmap_rough_cone_desc`` equals tpu_rt's, and so do the packed tables.
* K1, K3, K5 and K4 plain versions against
  ``tests/golden/rough_cone_kernels_seed0.npz``, tpu_rt's interpret-mode
  outputs at tile_rows 8 (``tests/golden/make_rough_cone_golden.py``), with
  the tolerances of the existing kernel tests: K1 and K3 at least 99% of
  the entries within rtol 1e-4 / atol 1e-6, plane sums within 1e-3 (of the
  sum of magnitudes for the signed Stokes planes), the ray count within 1%
  (test_torch_path_kernel.py, test_torch_stokes_kernel.py); K5 and K4 at
  least 98% of the lanes with every value within rtol 1e-4 / atol 1e-6,
  the jitter equal, the ray count within 1% (test_torch_envmap_kernel.py).
  XLA on the CPU contracts multiply-adds and rounds rsqrt otherwise than
  ``1 / sqrt``, so a lane whose lobe or roulette draw sits on an ulp may
  take the other branch.  The renders are held by the golden script's
  block-mean gates at ``CPU_LIMIT``.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_rt
import tpu_rt_torch
from tpu_rt.ops import pallas_path
from tpu_rt_torch.ops import path_kernel as pk
from tpu_rt_torch.scene import types as TT

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "golden"))
import make_rough_cone_golden as G  # noqa: E402
from test_torch_scene import _assert_bake_equal, pallas_bake_as_port  # noqa: E402
from torch_port_scenes import envmap_rough_cone_desc  # noqa: E402

torch.set_num_threads(1)
# The render gates on the CPU: the same streams, so the block means agree
# but for the lanes that branch otherwise on an ulp.
CPU_LIMIT = 2e-3


@pytest.fixture(scope="module")
def golden():
    return np.load(G.OUT)


def _pair(which, res=8):
    if which == "cbox_rough":
        return (tpu_rt.load_file(G.CBOX_ROUGH, res=res, spp=1),
                tpu_rt_torch.load_file(G.CBOX_ROUGH, res=res, spp=1))
    if which == "pol_rough":
        return (tpu_rt.load_file(G.POL_ROUGH, res=res, spp=1),
                tpu_rt_torch.load_file(G.POL_ROUGH, res=res, spp=1))
    return (tpu_rt.load_dict(envmap_rough_cone_desc(tpu_rt.ScalarTransform4f, G.ENVMAP, res)),
            tpu_rt_torch.load_dict(envmap_rough_cone_desc(tpu_rt_torch.ScalarTransform4f,
                                                          G.ENVMAP, res)))


def _cone_rays(which, n=20000):
    """World rays at the cbox_rough cone, made in its object space (the
    unit cone, apex at z = 1): aimed at random points of it, through its
    apex, or parallel to a line of its side (dx^2 + dy^2 = dz^2)."""
    rng = np.random.default_rng({"random": 1, "apex": 2, "side": 3}[which])
    o = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(-1, 3, n)], 1)
    if which == "random":
        d = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(0, 1, n)], 1) - o
    elif which == "apex":
        d = np.float64([0, 0, 1]) + rng.normal(0, 1e-3, (n, 3)) - o
    else:
        o[:, 2] = rng.uniform(0.5, 2.0, n)
        phi = rng.uniform(0, 2 * np.pi, n)
        d = np.stack([np.cos(phi), np.sin(phi), -np.ones(n)], 1)
    return o, d


@pytest.mark.parametrize("which", ["random", "apex", "side"])
def test_cone_sweep_matches_tpu_rt(which):
    sj, st = _pair("cbox_rough")
    bj, bt = pallas_path.bake_scene(sj), pk.bake_scene(st)
    ci = [p.kind for p in bt.prims].index("cone")
    to_world = np.linalg.inv(np.vstack([np.asarray(bt.prims[ci].data, np.float64),
                                        [0.0, 0.0, 0.0, 1.0]]))
    o_obj, d_obj = _cone_rays(which)
    o = (o_obj @ to_world[:3, :3].T + to_world[:3, 3]).astype(np.float32)
    d = d_obj @ to_world[:3, :3].T
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tj, pj, nj = pallas_path._sweep(bj, tuple(jnp.asarray(o[:, i]) for i in range(3)),
                                    tuple(jnp.asarray(d[:, i]) for i in range(3)), 1e-4, 1e8)
    C = pk._Consts(pk.pack_tables(bt, st.camera, 8, "cpu"))
    tt, pt, nt = pk._sweep(C, tuple(torch.from_numpy(o[:, i]) for i in range(3)),
                           tuple(torch.from_numpy(d[:, i]) for i in range(3)), 1e-4, 1e8)
    pj, tj, nj = np.asarray(pj), np.asarray(tj), np.stack([np.asarray(x) for x in nj])
    pt, tt, nt = pt.numpy(), tt.numpy(), torch.stack(nt).numpy()
    agree = ((pj == pt) & np.isclose(tt, tj, rtol=1e-5, atol=1e-6)
             & np.isclose(nt, nj, atol=1e-5).all(0))
    cone = (pj == ci) | (pt == ci)
    assert cone.sum() > 1000
    if which == "side":
        assert agree[cone].mean() >= 0.99 and agree.mean() >= 0.999, agree[cone].mean()
    else:
        assert agree.all()
    # the normal is the unit object normal (x, y, 1 - z) through M_obj^T
    assert np.allclose(np.linalg.norm(nt[:, pt == ci], axis=0), 1.0, atol=1e-5)


@pytest.mark.parametrize("which", ["cbox_rough", "pol_rough", "env_rough_cone"])
def test_bake_and_tables_match_tpu_rt(which):
    sj, st = _pair(which)
    bj, bt = pallas_path.bake_scene(sj), pk.bake_scene(st)
    assert bt is not None and bj is not None
    _assert_bake_equal(bj, bt)
    stokes = which == "pol_rough"
    t1 = pk.pack_tables(bt, st.camera, 8, "cpu", stokes=stokes)
    t2 = pk.pack_tables(pallas_bake_as_port(sj), st.camera, 8, "cpu", stokes=stokes)
    assert t1.tab_list == t2.tab_list and t1.hdr_list == t2.hdr_list
    assert t1.rough_cone and t1.hdr_list[pk.HDR_ROUGH_CONE] == 1
    # each rough conductor's record keeps tpu_rt's alpha = max(alpha, 1e-3)
    for (bt_, prm), o in zip(bt.bsdfs, range(t1.hdr_list[pk.HDR_OFF_BSDF],
                                             t1.hdr_list[pk.HDR_OFF_EM], pk.BSDF_STRIDE)):
        if bt_ == TT.BSDF_ROUGH_CONDUCTOR:
            assert t1.tab_list[o + pk.B_ALPHA] == float(np.float32(max(prm[9], 1e-3)))
    assert ("cone" in {p.kind for p in bt.prims}) == (which != "pol_rough")
    if stokes:
        assert pk.stokes_in_scope(bt)


def _check_planes(got, want, signed=False):
    """test_torch_path_kernel.py's (signed=False) and
    test_torch_stokes_kernel.py's (signed=True) tolerances."""
    assert got.shape == want.shape
    close = np.isclose(got, want, rtol=1e-4, atol=1e-6)
    assert close.mean() >= 0.99, f"only {close.mean():.4f} of entries agree"
    err = np.abs(got[:-1].sum(1, dtype=np.float64) - want[:-1].sum(1, dtype=np.float64))
    scale = np.abs(want[:-1]).sum(1) if signed else np.abs(want[:-1].sum(1, dtype=np.float64))
    assert (err <= 1e-3 * scale + 1e-6).all()
    assert abs(got[-1].sum() - want[-1].sum()) <= 0.01 * want[-1].sum()


def test_film_plain_matches_pallas_interpret(golden):
    """K1 on cbox_rough.xml: the rough sphere, the cone, tent, depth 6."""
    st = tpu_rt_torch.load_file(G.CBOX_ROUGH, res=G.KERNEL["res"], spp=G.KERNEL["k"])
    t = pk.pack_tables(pk.bake_scene(st), st.camera, 8, "cpu")
    assert t.rough_cone and t.radius == 1 and not t.regen
    got = pk.film_trace(t, G.KERNEL["seed"], G.KERNEL["k"]).numpy()
    _check_planes(got, golden["k1_planes"])


def test_stokes_film_plain_matches_pallas_interpret(golden):
    """K3 on cbox_pol_rough.xml against tpu_rt's in K2's loop: two rough
    conductors, the NEE Mueller chain, gaussian, depth 16."""
    st = tpu_rt_torch.load_file(G.POL_ROUGH, res=G.KERNEL["res"], spp=G.KERNEL["k"])
    t = pk.pack_tables(pk.bake_scene(st), st.camera, 8, "cpu", stokes=True)
    assert t.rough_cone and not t.regen and t.radius == 2  # K3 has no loop form
    got = pk.stokes_film_trace(t, G.KERNEL["seed"], G.KERNEL["k"]).numpy()
    _check_planes(got, golden["k3_planes"], signed=True)
    assert np.abs(got[13:25]).max() > 0.0  # the next offset's Q, U, V are there


def _lanes_agree(got, want, share=0.98):
    close = np.isclose(got, want, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= share, f"only {close.mean():.4f} of lanes agree"


def test_raygen_plain_matches_pallas_interpret(golden):
    """K5 on the rough ball and the cone under the textured environment."""
    _, st = _pair("env_rough_cone", G.KERNEL["res"])
    t = pk.pack_tables(pk.bake_scene(st), st.camera, 8, "cpu")
    p = pk.raygen_trace(t, G.KERNEL["k5_seed"]).numpy()
    np.testing.assert_array_equal(p[4:6].T, golden["k5_jitter"])
    want = np.concatenate([golden["k5_" + k] for k in ("L", "esc_d", "esc_thr")], 1)
    _lanes_agree(p[[0, 1, 2, 6, 7, 8, 9, 10, 11]].T, want)
    rays = int(golden["k5_rays"])
    assert abs(p[3].sum() - rays) <= 0.01 * rays


def test_path_trace_plain_matches_pallas_interpret(golden):
    """K4 on the same scene, on rays from around its camera."""
    _, st = _pair("env_rough_cone")
    t = pk.pack_tables(pk.bake_scene(st), st.camera, 8, "cpu")
    o, d = (torch.from_numpy(x) for x in G.k4_rays())
    p = pk.path_trace(t, o, d, G.KERNEL["k4_seed"]).numpy()
    want = np.concatenate([golden["k4_" + k] for k in ("L", "esc_d", "esc_thr")], 1)
    _lanes_agree(np.concatenate([p[0:3].T, p[4:10].T], 1), want)
    rays = int(golden["k4_rays"])
    assert abs(p[3].sum() - rays) <= 0.01 * rays


@pytest.mark.parametrize("which", ["k1", "k3"])
def test_render_matches_pallas_interpret(golden, which):
    """render(cbox_rough.xml) (K1) and render(cbox_pol_rough.xml) (K3 in
    K2's loop) at 32x32, 8 spp, seed 0, tile_rows 8."""
    path = G.CBOX_ROUGH if which == "k1" else G.POL_ROUGH
    sc = tpu_rt_torch.load_file(path, res=G.RENDER["res"], spp=G.RENDER["spp"])
    img = tpu_rt_torch.render(sc, spp=G.RENDER["spp"], seed=G.RENDER["seed"], device="cpu",
                              tile_rows=8)
    gate = G.render_gate if which == "k1" else G.stokes_gate
    assert gate(img.numpy(), golden[which + "_render"]) <= CPU_LIMIT
    rays = int(golden[which + "_render_rays"])
    assert abs(int(tpu_rt_torch.render.last_ray_count) - rays) <= 0.01 * rays
