"""Polarized rendering through the port's public entry points, on the CPU.

* The Stokes wavefront's ``stokes_trace`` against tpu_rt's on identical
  rays, fed tpu_rt's own threefry draws as ``uniforms``: the rebuilt
  cbox_pol at depth 16, a pair of polarizer sheets at 0 and 45 degrees,
  and a mesh scene whose queries go through K7 (interpret mode in tpu_rt,
  the plain version here).  Tolerance: at least 99% of the lanes' 12
  Stokes values within rtol 1e-4 / atol 1e-6 (XLA on the CPU contracts
  multiply-adds; a lane whose lobe or roulette draw sits on an ulp follows
  another path).
* The closed-form renders of tests/test_stokes.py:79-109 (one sheet
  halves and polarizes; two sheets follow Malus; theta acts like a
  rotation) and the polarizers_const.xml substitute.
* The loader's stokes and polarizer tables against tpu_rt's, the
  dispatch of ``render`` (in-scope scenes through the Stokes film kernel,
  polarizers and an explicit max_depth through the wavefront), and the
  cbox_pol golden of tests/golden/make_stokes_golden.py held by the plain
  version at 2 spp.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tpu_rt
import tpu_rt_torch
from tpu_rt.integrator import stokes as stokes_j
from tpu_rt.ops import pallas_mesh, pallas_path
from tpu_rt.sensor import camera as cam_j
from tpu_rt_torch.integrator import stokes as stokes_t
from tpu_rt_torch.ops import path_kernel
from tpu_rt_torch.scene import types as TT

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from test_torch_scene import _assert_bake_equal, pallas_bake_as_port  # noqa: E402
from torch_port_scenes import polarizer_desc  # noqa: E402

torch.set_num_threads(1)
CBOX_POL = os.path.join(HERE, "assets", "cbox_pol", "cbox_pol.xml")
POLARIZERS = os.path.join(HERE, "assets", "cbox_pol", "polarizers_const.xml")
MESH_GI = os.path.join(HERE, "assets", "mesh", "mesh_gi.xml")


def _pair(which, res=8):
    if which == "polarizers":
        return (tpu_rt.load_dict(polarizer_desc(tpu_rt.ScalarTransform4f, [0.0, 45.0],
                                                [0.5, 0.0], res=res)),
                tpu_rt_torch.load_dict(polarizer_desc(tpu_rt_torch.ScalarTransform4f,
                                                      [0.0, 45.0], [0.5, 0.0], res=res)))
    path = {"cbox_pol": CBOX_POL, "mesh": MESH_GI, "polarizers_const": POLARIZERS}[which]
    return tpu_rt.load_file(path, res=res, spp=1), tpu_rt_torch.load_file(path, res=res, spp=1)


# (scene, max_depth): cbox_pol at its depth 16 (roulette from 5); the
# sheets at 16 (the environment seen through them); the knot over a floor
# at depth 3, its queries through K7
CASES = {"cbox_pol": None, "polarizers": None, "mesh": 3}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stokes_trace_matches_tpu_rt_on_identical_rays_and_uniforms(monkeypatch, case):
    monkeypatch.setattr(pallas_mesh, "INTERPRET", True)
    sj, st = _pair(case)
    res = st.camera.width
    rng = np.random.default_rng(17)
    ys, xs = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    xy = np.stack([xs, ys], -1).reshape(-1, 2) + rng.uniform(0, 1, (res * res, 2))
    o, d, t0, t1 = (np.array(x) for x in cam_j.sample_ray_extents(
        sj.camera, jnp.asarray(xy, jnp.float32)))
    key = jax.random.PRNGKey(3)
    depth = stokes_t.resolved_depth(st, CASES[case])
    uniforms = np.stack([np.asarray(jax.random.uniform(k, (o.shape[0], 8)))
                         for k in jax.random.split(key, depth)])
    Sj = np.asarray(stokes_j.stokes_trace(sj, jnp.asarray(o), jnp.asarray(d), key,
                                          max_depth=CASES[case], tmin0=jnp.asarray(t0),
                                          tmax0=jnp.asarray(t1)))
    St, n_rays = stokes_t.stokes_trace(st, torch.from_numpy(o), torch.from_numpy(d),
                                       uniforms=torch.from_numpy(uniforms),
                                       max_depth=CASES[case], tmin0=torch.from_numpy(t0),
                                       tmax0=torch.from_numpy(t1))
    St = St.numpy()
    assert St.shape == (res * res, 4, 3) and np.isfinite(St).all()
    close = np.isclose(St, Sj, rtol=1e-4, atol=1e-6).all((1, 2))
    assert close.mean() >= 0.99, f"only {close.mean():.4f} of lanes agree"
    assert (Sj[:, 0].sum(-1) > 0).mean() > 0.1
    assert n_rays.dtype == torch.int64 and int(n_rays) >= res * res
    if case != "mesh":
        assert np.abs(Sj[:, 1:3]).max() > 1e-3  # polarized light is there


def _render(desc_args, spp=16):
    st = tpu_rt_torch.load_dict(polarizer_desc(tpu_rt_torch.ScalarTransform4f, *desc_args))
    return tpu_rt_torch.render(st, spp=spp, seed=0, device="cpu").numpy()


def test_single_polarizer_halves_and_polarizes():
    S = _render(([0.0], [0.0]))
    center = S[6:10, 6:10]  # through the sheet
    I = center[..., 0, :].mean()
    dop = np.sqrt(sum(center[..., k, :].mean() ** 2 for k in (1, 2, 3))) / max(I, 1e-9)
    np.testing.assert_allclose(I, 0.5, atol=0.03)
    assert dop > 0.95, f"transmitted light not fully polarized (DOP={dop})"


@pytest.mark.parametrize("delta", [0.0, 45.0, 90.0])
def test_two_polarizers_malus(delta):
    S = _render(([0.0, delta], [0.5, 0.0]))
    np.testing.assert_allclose(S[6:10, 6:10, 0, :].mean(), 0.5 * np.cos(np.deg2rad(delta)) ** 2,
                               atol=0.04)


def test_theta_prop_rotates_axis():
    geo = _render(([0.0, 60.0], [0.5, 0.0]))[6:10, 6:10, 0, :].mean()
    via_theta = _render(([0.0, 0.0], [0.5, 0.0], 16, [0.0, 60.0]))[6:10, 6:10, 0, :].mean()
    np.testing.assert_allclose(geo, via_theta, atol=0.04)


def test_polarizers_substitute_renders_through_the_wavefront():
    _, st = _pair("polarizers_const", 16)
    S = stokes_t.render_stokes(st, spp=2, device="cpu").numpy()
    assert S.shape == (16, 16, 4, 3) and np.isfinite(S).all()
    assert S[..., 0, :].mean() > 0.01  # the environment gets through
    assert np.sqrt((S[..., 1, :] ** 2).mean()) > 0.01  # polarized by the sheets
    assert int(stokes_t.render_stokes.last_ray_count) >= 2 * 16 * 16


@pytest.mark.parametrize("which", ["cbox_pol", "polarizers"])
def test_loader_tables_match_tpu_rt(which):
    sj, st = _pair(which)
    for k in ("bsdf_type", "bsdf_params", "shape_bsdf", "shape_emitter", "shape_to_world"):
        np.testing.assert_array_equal(getattr(st, k).numpy(), np.asarray(getattr(sj, k)),
                                      err_msg=k)
    assert st.integrator == sj.integrator == TT.INTEGRATOR_STOKES
    assert (st.max_depth, st.rr_depth, st.hide_emitters) == (
        sj.max_depth, sj.rr_depth, sj.hide_emitters)
    assert st.camera.filter_type == sj.camera.filter_type
    if which == "polarizers":
        assert TT.BSDF_POLARIZER in st.bsdf_types_present
        # baked (K1's pass-through lane), but the polarizer stays off the
        # Stokes kernel
        assert not path_kernel.stokes_in_scope(path_kernel.bake_scene(st))


def test_cbox_pol_is_in_the_kernel_scope_of_both_packages():
    sj, st = _pair("cbox_pol")
    bj, bt = pallas_path.bake_scene(sj), path_kernel.bake_scene(st)
    assert pallas_path.stokes_in_scope(bj) and path_kernel.stokes_in_scope(bt)
    assert len(bt.prims) == 16 <= 64 and bt.max_depth == 16
    _assert_bake_equal(bj, bt)
    t1 = path_kernel.pack_tables(bt, st.camera, 8, "cpu", stokes=True)
    t2 = path_kernel.pack_tables(pallas_bake_as_port(sj), st.camera, 8, "cpu", stokes=True)
    assert t1.tab_list == t2.tab_list and t1.hdr_list == t2.hdr_list
    assert not t1.regen and t1.stokes and t1.radius == 2  # K3 has no loop form
    em = np.asarray(sj.emitters.area_radiance)
    assert em.tolist() == [[25.0, 25.0, 25.0]]
    cond = st.bsdf_params[st.bsdf_type == TT.BSDF_CONDUCTOR]
    assert any(abs(float(r[0]) - 0.24873) < 1e-5 for r in cond)
    assert (st.bsdf_type == TT.BSDF_DIELECTRIC).sum() == 2 and len(cond) == 2


def _spy(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        calls.append(kwargs)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("which,max_depth", [("cbox_pol", None), ("polarizers", None),
                                             ("cbox_pol", 3)])
def test_dispatch(monkeypatch, which, max_depth):
    film = _spy(monkeypatch, path_kernel, "render_stokes_film")
    wave = _spy(monkeypatch, stokes_t, "stokes_trace")
    _, st = _pair(which)
    if max_depth is None:
        S = tpu_rt_torch.render(st, spp=1, seed=2, device="cpu", tile_rows=8)
        rays = tpu_rt_torch.render.last_ray_count
    else:
        S = stokes_t.render_stokes(st, spp=1, seed=2, max_depth=max_depth, device="cpu")
        rays = stokes_t.render_stokes.last_ray_count
    in_scope = which == "cbox_pol" and max_depth is None
    assert (len(film), len(wave)) == ((1, 0) if in_scope else (0, 1))
    assert S.shape == (8, 8, 4, 3) and bool(torch.isfinite(S).all()) and S[..., 0, :].mean() > 0
    assert rays.dim() == 0 and rays.dtype == torch.int64 and int(rays) >= 64


def test_stokes_I_tracks_the_scalar_render():
    """cbox_pol's Stokes-I against the scalar render of the same scene
    with the same streams (tests/test_stokes.py:112-127 allows 5% of the
    mean): equal on the diffuse paths; after two specular bounces the
    light's polarization changes what the second one reflects, so I and
    the unpolarized estimate part (0.15% of the mean here)."""
    _, st = _pair("cbox_pol", 32)
    S = tpu_rt_torch.render(st, spp=2, seed=1, device="cpu", tile_rows=8)
    img = tpu_rt_torch.render(st.replace(integrator=TT.INTEGRATOR_PATH), spp=2, seed=1,
                              device="cpu", tile_rows=8)
    rel = (S[..., 0, :] - img).abs().mean() / img.mean()
    assert float(rel) < 0.05
    assert float((S[..., 1, :] ** 2).mean().sqrt()) > 0.01  # Q
    assert float((S[..., 2, :] ** 2).mean().sqrt()) > 0.01  # U


def _golden_module():
    spec = importlib.util.spec_from_file_location(
        "make_stokes_golden", os.path.join(HERE, "golden", "make_stokes_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cbox_pol_golden_gate_holds_for_the_plain_version():
    g = _golden_module()
    want = np.load(g.OUT)
    st = tpu_rt_torch.load_file(CBOX_POL, res=g.RENDER["res"], spp=2)
    S = tpu_rt_torch.render(st, spp=2, seed=g.RENDER["seed"], device="cpu", tile_rows=8)
    rays = int(tpu_rt_torch.render.last_ray_count)
    assert S.shape == want["render_2"].shape and bool(torch.isfinite(S).all())
    assert g.render_gate(S.numpy(), want["render_2"]) <= g.RENDER_LIMIT / 10
    assert abs(rays - int(want["render_2_rays"])) <= 0.01 * int(want["render_2_rays"])
