"""The wavefront path tracer against tpu_rt's, on the CPU.

``path_trace`` on identical rays: tpu_rt's camera rays through a fixed
numpy jitter go through ``tpu_rt.integrator.path.path_trace`` (its mesh
queries through K7 in interpret mode) and through the port's, which is fed
tpu_rt's own threefry draws as ``uniforms``, so both follow the same
paths.  Tolerance: the rays cast equal, and at least 99% of the lanes'
radiance within rtol 1e-4 / atol 1e-6 (XLA on the CPU contracts
multiply-adds into FMAs; a lane whose shadow ray grazes an edge, or whose
lobe choice sits on an ulp, may take the other branch, and the path after
it differs).  Then the dispatch of ``render``, and the statistical golden
(``tests/golden/make_wavefront_golden.py``) held by the plain version at a
CPU-sized spp.
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
from tpu_rt.integrator import path as path_j
from tpu_rt.ops import pallas_mesh
from tpu_rt.sensor import camera as cam_j
from tpu_rt_torch.integrator import path as path_t
from tpu_rt_torch.ops import mesh_kernel, path_kernel
from tpu_rt_torch.scene import types as TT

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from torch_port_scenes import shapes_desc  # noqa: E402

torch.set_num_threads(1)
MESH = os.path.join(HERE, "assets", "mesh")
CBOX = os.path.join(HERE, "assets", "cbox", "cbox.xml")


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pallas_mesh, "INTERPRET", True)


def _load(which, res):
    if which == "shapes":
        return (tpu_rt.load_dict(shapes_desc(tpu_rt.ScalarTransform4f)),
                tpu_rt_torch.load_dict(shapes_desc(tpu_rt_torch.ScalarTransform4f)))
    path = {"big_gi": os.path.join(MESH, "mesh_big_gi.xml"), "cbox": CBOX,
            "simple_big": os.path.join(MESH, "simple_big.xml")}[which]
    return tpu_rt.load_file(path, res=res, spp=1), tpu_rt_torch.load_file(path, res=res, spp=1)


# (scene, film size, max_depth): the bunny-class mesh GI scene at depth 3;
# the cbox (glass and mirror spheres) at its depth 6, roulette from 5; the
# disk / cylinder / cone / rough conductor / null scene at depth 4 under an
# area light, a point light and a constant environment; the direct route
# (max_depth 2) of the bunny-class direct scene.
CASES = {"big_gi": ("big_gi", 16, None), "cbox": ("cbox", 16, None),
         "rough": ("shapes", 16, None), "direct": ("simple_big", 16, 2)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_path_trace_matches_tpu_rt_on_identical_rays_and_uniforms(case):
    which, res, max_depth = CASES[case]
    sj, st = _load(which, res)
    rng = np.random.default_rng(17)
    ys, xs = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    xy = np.stack([xs, ys], -1).reshape(-1, 2) + rng.uniform(0, 1, (res * res, 2))
    o, d, t0, t1 = (np.array(x) for x in cam_j.sample_ray_extents(
        sj.camera, jnp.asarray(xy, jnp.float32)))
    key = jax.random.PRNGKey(3)
    n_iters = path_t.n_bounces(st, max_depth)
    uniforms = np.stack([np.asarray(jax.random.uniform(k, (o.shape[0], 8)))
                         for k in jax.random.split(key, n_iters)])
    Lj, nj = path_j.path_trace(sj, jnp.asarray(o), jnp.asarray(d), key, max_depth=max_depth,
                               tmin0=jnp.asarray(t0), tmax0=jnp.asarray(t1))
    Lt, nt = path_t.path_trace(st, torch.from_numpy(o), torch.from_numpy(d),
                               uniforms=torch.from_numpy(uniforms), max_depth=max_depth,
                               tmin0=torch.from_numpy(t0), tmax0=torch.from_numpy(t1))
    Lj, Lt = np.asarray(Lj), Lt.numpy()
    assert nt.dtype == torch.int64 and int(nt) == int(nj)
    close = np.isclose(Lt, Lj, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, f"only {close.mean():.4f} of lanes agree"
    assert (Lj.sum(-1) > 0).mean() > 0.1 and np.isfinite(Lt).all()


def _spy(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        calls.append(kwargs)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("which", ["cbox", "simple", "mesh_gi"])
def test_scenes_in_a_kernels_scope_stay_on_it(monkeypatch, which):
    wave = _spy(monkeypatch, path_t, "render")
    film = _spy(monkeypatch, path_kernel, "render_film")
    direct = _spy(monkeypatch, mesh_kernel, "mesh_direct_render")
    path = {"cbox": CBOX, "simple": os.path.join(MESH, "simple.xml"),
            "mesh_gi": os.path.join(MESH, "mesh_gi.xml")}[which]
    img = tpu_rt_torch.render(tpu_rt_torch.load_file(path, res=8, spp=1), device="cpu")
    assert not wave and img.shape == (8, 8, 3)
    assert (len(direct), len(film)) == ((1, 0) if which == "simple" else (0, 1))


@pytest.mark.parametrize("which", ["big_gi", "shapes", "simple_big"])
def test_scenes_outside_the_kernels_scope_take_the_wavefront(monkeypatch, which):
    wave = _spy(monkeypatch, path_t, "render")
    film = _spy(monkeypatch, path_kernel, "render_film")
    direct = _spy(monkeypatch, mesh_kernel, "mesh_direct_render")
    _, st = _load(which, 8)
    st = st.replace(camera=st.camera.replace(width=8, height=8))
    img = tpu_rt_torch.render(st, spp=1, seed=2, device="cpu")
    assert len(wave) == 1 and not film and not direct
    assert wave[0].get("max_depth") == (2 if which == "simple_big" else None)
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all()) and img.mean() > 0
    rays = tpu_rt_torch.render.last_ray_count
    assert rays.dim() == 0 and rays.dtype == torch.int64 and int(rays) >= 64


def test_direct_projective_outside_the_kernels_scope_renders_as_direct():
    _, st = _load("simple_big", 8)
    st = st.replace(camera=st.camera.replace(width=8, height=8))
    img = tpu_rt_torch.render(st, spp=1, seed=2, device="cpu")
    proj = tpu_rt_torch.render(st.replace(integrator=TT.INTEGRATOR_DIRECT_PROJECTIVE),
                               spp=1, seed=2, device="cpu")
    assert torch.equal(img, proj)


def test_stokes_still_raises_naming_A6():
    """A6 has landed: a Stokes scene no longer raises but renders its
    (H, W, 4, 3) Stokes image, through the Stokes film kernel here."""
    st = tpu_rt_torch.load_file(CBOX, res=8, spp=1).replace(integrator=TT.INTEGRATOR_STOKES)
    S = tpu_rt_torch.render(st, device="cpu")
    assert S.shape == (8, 8, 4, 3) and bool(torch.isfinite(S).all()) and S[..., 0, :].mean() > 0


def test_render_is_reproducible_per_seed():
    _, st = _load("shapes", 8)
    st = st.replace(camera=st.camera.replace(width=8, height=8))
    a = path_t.render(st, spp=2, seed=5, device="cpu")
    b = path_t.render(st, spp=2, seed=5, device="cpu")
    c = path_t.render(st, spp=2, seed=6, device="cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)


def _golden():
    spec = importlib.util.spec_from_file_location(
        "make_wavefront_golden", os.path.join(HERE, "golden", "make_wavefront_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_wavefront_golden_gate_holds_for_the_plain_version():
    g = _golden()
    want = np.load(os.path.join(HERE, "golden", g.CFG["out"]))
    st = tpu_rt_torch.load_file(os.path.join(MESH, g.CFG["scene"]), res=g.CFG["res"],
                                spp=g.CPU_SPP)
    img = tpu_rt_torch.render(st, spp=g.CPU_SPP, seed=0, device="cpu").numpy()
    rays = int(tpu_rt_torch.render.last_ray_count)
    assert np.isfinite(img).all()
    assert g.gate(img, want["img"]) <= g.CPU_LIMIT
    assert abs(img.mean() - want["img"].mean()) <= 0.02 * want["img"].mean()
    per_spp = int(want["rays"]) / g.CFG["spp"]
    assert abs(rays / g.CPU_SPP - per_spp) <= 0.02 * per_spp
