"""The per-sample kernels' plain versions against tpu_rt's Pallas kernels.

K5 (``raygen_trace_plain``) and K4 (``path_trace_plain``) on the in-repo
fixtures, held to ``tests/golden/envmap_kernels_seed0.npz``: tpu_rt's
interpret-mode outputs at tile_rows 8, stored by
``tests/golden/make_envmap_golden.py``.  Both draw the same SplitMix32
streams.  Tolerance (tests/test_torch_stokes_kernel.py's): at least 98% of
the lanes with every value within rtol 1e-4 / atol 1e-6 (XLA on the CPU
contracts multiply-adds and rounds rsqrt otherwise than ``1 / sqrt``, so a
lane whose lobe or roulette draw sits on an ulp may take the other
branch), the jitter equal, the ray count within 1%.  Then the lat-long
lookup ``eval_env`` against tpu_rt's, the constant-environment furnace
through the plain K4 (tests/test_pallas_kernel.py:80-115's twin), and K5 +
``splat_aligned`` against K1's film planes (tests/test_pallas_film_stokes.py:
72-140's twin).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpu_rt
import tpu_rt_torch
from tpu_rt.emitter import sample as sample_j
from tpu_rt_torch.emitter import sample as sample_t
from tpu_rt_torch.ops import path_kernel as pk
from tpu_rt_torch.scene import types as TT

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "golden"))
sys.path.insert(0, os.path.join(HERE, "assets", "polarizers"))
import make_envmap  # noqa: E402
import make_envmap_golden as G  # noqa: E402
from torch_port_scenes import envmap_desc  # noqa: E402

torch.set_num_threads(1)
POLARIZERS = G.POLARIZERS
POL_CONST = G.POL_CONST
CBOX = G.CBOX


@pytest.fixture(scope="module")
def golden():
    return np.load(G.OUT)


def _tables(scene, depth=None):
    if depth is not None:
        scene = scene.replace(max_depth=depth)
    return pk.pack_tables(pk.bake_scene(scene), scene.camera, 8, "cpu")


def _lanes_agree(got, want, share=0.98):
    """got, want: [N, k] per-lane values."""
    close = np.isclose(got, want, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= share, f"only {close.mean():.4f} of lanes agree"


def _check_k5(planes, golden, prefix):
    p = planes.numpy()
    assert p.shape[0] == 12
    np.testing.assert_array_equal(p[4:6].T, golden[prefix + "_jitter"])
    got = p[[0, 1, 2, 6, 7, 8, 9, 10, 11]].T
    want = np.concatenate([golden[prefix + k] for k in ("_L", "_esc_d", "_esc_thr")], 1)
    _lanes_agree(got, want)
    rays = int(golden[prefix + "_rays"])
    assert abs(p[3].sum() - rays) <= 0.01 * rays


@pytest.mark.parametrize("res", G.K5["res"])
def test_raygen_plain_matches_pallas_interpret(golden, res):
    sc = tpu_rt_torch.load_file(POLARIZERS, res=res, spp=1)
    t = _tables(sc, G.K5["depth"])
    assert t.env_textured and t.hdr_list[pk.HDR_ENV_TEXTURED] == 1
    planes = pk.raygen_trace(t, G.K5["seed"])  # the plain version on the CPU
    _check_k5(planes, golden, f"k5_{res}")
    esc = planes[9:12].sum(0) > 0
    assert 0.5 < esc.float().mean().item() <= 1.0  # most paths reach the sky


def test_raygen_plain_matches_pallas_interpret_mixed_lanes(golden):
    """Diffuse (with NEE), null, dielectric, polarizer and conductor lanes
    under the rotated map."""
    sc = tpu_rt_torch.load_dict(envmap_desc(tpu_rt_torch.ScalarTransform4f, G.ENVMAP,
                                            G.K5["mixed_res"]))
    t = _tables(sc)
    assert {bt for bt, _ in pk.bake_scene(sc).bsdfs} == {
        TT.BSDF_DIFFUSE, TT.BSDF_NULL, TT.BSDF_DIELECTRIC, TT.BSDF_POLARIZER, TT.BSDF_CONDUCTOR}
    _check_k5(pk.raygen_trace(t, G.K5["mixed_seed"]), golden, "k5_mixed")


def _check_k4(planes, golden, prefix):
    p = planes.numpy()
    got, want = p[0:3].T, golden[prefix + "_L"]
    if prefix + "_esc_d" in golden:
        assert p.shape[0] == 10
        got = np.concatenate([got, p[4:10].T], 1)
        want = np.concatenate([want, golden[prefix + "_esc_d"], golden[prefix + "_esc_thr"]], 1)
    else:
        assert p.shape[0] == 4
    _lanes_agree(got, want)
    rays = int(golden[prefix + "_rays"])
    assert abs(p[3].sum() - rays) <= 0.01 * rays


def test_path_trace_plain_matches_pallas_interpret_env(golden):
    sc = tpu_rt_torch.load_file(POLARIZERS, res=8, spp=1)
    o, d = (torch.from_numpy(x) for x in G.k4_env_rays())
    planes = pk.path_trace(_tables(sc), o, d, G.K4["seed"])
    _check_k4(planes, golden, "k4_env")
    thr = planes[7:10].numpy()
    # escapes through no sheet (1), one (0.5) or two (0.25): the tints
    assert set(np.unique(thr).tolist()) == {0.25, 0.5, 1.0}


@pytest.mark.parametrize("which", ["up", "out"])
def test_path_trace_plain_direct_visibility_exact(golden, which):
    """tests/test_pallas_kernel.py:53-68's twin on the in-repo cbox: depth-1
    paths from the centre up at the luminaire see its radiance; out of the
    open front they see nothing."""
    sc = tpu_rt_torch.load_file(CBOX, res=16, spp=1)
    o, up, fwd = (torch.from_numpy(x) for x in G.cbox_up_out())
    planes = pk.path_trace(_tables(sc, 1), o, up if which == "up" else fwd, G.K4["cbox_seed"])
    _check_k4(planes, golden, f"k4_cbox_{which}")
    L = planes[0:3].T
    if which == "up":
        assert torch.equal(L, torch.ones_like(L))  # the luminaire's radiance, exactly
    else:
        assert float(L.abs().max()) == 0.0


def test_path_trace_plain_matches_pallas_interpret_cbox_depth3(golden):
    """2 048 random rays in the cbox at depth 3: diffuse bounces, NEE and
    two RNG tiles."""
    sc = tpu_rt_torch.load_file(CBOX, res=16, spp=1)
    o, d = (torch.from_numpy(x) for x in G.k4_cbox3_rays())
    _check_k4(pk.path_trace(_tables(sc, 3), o, d, G.K4["cbox3_seed"]), golden, "k4_cbox3")


def test_eval_env_matches_tpu_rt_through_the_rotated_map():
    sj = tpu_rt.load_file(POLARIZERS, res=8, spp=1)
    st = tpu_rt_torch.load_file(POLARIZERS, res=8, spp=1)
    rng = np.random.default_rng(3)
    d = rng.normal(size=(20000, 3)).astype(np.float32)
    d[:5] = 0.0  # a path that never escaped: finite, and times zero throughput
    got = sample_t.eval_env(st, torch.from_numpy(d)).numpy()
    want = np.asarray(sample_j.eval_env(sj, jnp.asarray(d)))
    assert np.isfinite(got).all()
    same = (got == want).all(-1)
    assert same.mean() >= 0.999, f"only {same.mean():.5f} of lookups agree"
    # the sun, through to_world and scale
    sun = torch.tensor([make_envmap.SUN_WORLD], dtype=torch.float32)
    assert sample_t.eval_env(st, sun).min().item() > 5.0


def test_furnace_constant_env_through_plain_path_trace():
    """tests/test_pallas_kernel.py:80-115's twin: a diffuse sphere of
    albedo 0.7 in a unit constant environment gives 0.7; rays that miss it
    see exactly 1."""
    desc = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 8},
        "sensor": {"type": "perspective", "fov": 40,
                   "to_world": tpu_rt_torch.ScalarTransform4f().look_at(
                       origin=[0, 0, -4], target=[0, 0, 0], up=[0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": 16, "height": 16,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": 8}},
        "sph": {"type": "sphere", "bsdf": {"type": "diffuse", "reflectance": np.full(3, 0.7)}},
        "env": {"type": "constant", "radiance": np.ones(3)},
    }
    sc = tpu_rt_torch.load_dict(desc)
    bs = pk.bake_scene(sc)
    assert bs.env_rgb == (1.0, 1.0, 1.0) and not bs.env_textured
    t = pk.pack_tables(bs, sc.camera, 8, "cpu")
    o = torch.tensor([[0.0, 0.0, -4.0]]).repeat(1024, 1)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(1024, 1)
    acc = sum(float(pk.path_trace(t, o, d, s)[0:3].mean()) for s in range(16))
    np.testing.assert_allclose(acc / 16, 0.7, atol=0.02)
    d2 = torch.nn.functional.normalize(torch.tensor([[0.9, 0.44, 0.0]]), dim=-1).repeat(1024, 1)
    planes = pk.path_trace(t, o, d2, 0)
    assert planes.shape == (4, 1024)
    np.testing.assert_allclose(planes[0:3].numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("path,filt", [(POL_CONST, TT.FILTER_GAUSSIAN),
                                       (CBOX, TT.FILTER_TENT)], ids=["polarizers_const", "cbox"])
def test_per_sample_route_equals_film_planes(path, filt):
    """K5 + splat_aligned (render_sample_film) against K1's film planes with
    one sample a chunk: the same streams, so equal but for the splat's add
    order and the gaussian's exp (ulps)."""
    sc = tpu_rt_torch.load_file(path, res=8, spp=3).replace(max_depth=4)
    sc = sc.replace(camera=sc.camera.replace(filter_type=filt))
    img_s, rays_s = pk.render_sample_film(sc, spp=3, seed=5, device="cpu", tile_rows=8)
    img_f, rays_f = pk.render_film(sc, spp=3, seed=5, device="cpu", spp_per_pass=1, tile_rows=8)
    np.testing.assert_allclose(img_s.numpy(), img_f.numpy(), rtol=2e-5, atol=2e-6)
    assert int(rays_s) == int(rays_f) and img_f.mean() > 0


def test_wrappers_on_the_cpu_launch_nothing():
    sc = tpu_rt_torch.load_file(POLARIZERS, res=8, spp=1)
    t = _tables(sc, 2)
    before = (pk.raygen_trace.launches, pk.path_trace.launches)
    pk.raygen_trace(t, 0)
    pk.path_trace(t, torch.zeros((5, 3)), torch.tensor([[0.0, 0.0, 1.0]]).repeat(5, 1), 0)
    assert before == (pk.raygen_trace.launches, pk.path_trace.launches)
    with pytest.raises(ValueError, match="stokes=False"):
        pk.raygen_trace(pk.pack_tables(pk.bake_scene(sc), sc.camera, 8, "cpu", stokes=True), 0)
    with pytest.raises(ValueError, match=r"\[N, 3\]"):
        pk.path_trace(t, torch.zeros((5, 3)), torch.zeros((4, 3)), 0)
