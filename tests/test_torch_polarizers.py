"""The textured-environment route through the port's public entry point, on the CPU.

* ``render`` of tests/assets/polarizers/polarizers.xml (path, two
  polarizer sheets under the rotated, scaled EXR envmap) at 32x32, 2 spp,
  tile_rows 8 against tpu_rt's ``render_pallas`` in interpret mode
  (tests/golden/make_envmap_golden.py): the same streams, so 8x8 block
  means within ``CPU_LIMIT`` (1e-5) of the golden's mean, the ray count
  within 1%.
* tests/test_pallas_kernel.py:176-202's twin: the per-sample route against
  the port's scalar wavefront (other streams, the environment sampled by
  NEE there), 128 spp each: global mean within 2%, 8x8 block means within
  0.2 of the mean.
* The routes: a textured-environment path scene reaches
  ``render_sample_film``; polarizers_const.xml as a path scene reaches K1's
  film route (the pass-through lane) and matches its golden; the Stokes
  kernels refuse polarizers and textured environments.
"""

import os
import sys

import numpy as np
import pytest
import torch

import tpu_rt_torch
from tpu_rt_torch.integrator import path as wavefront
from tpu_rt_torch.integrator import stokes as stokes_t
from tpu_rt_torch.ops import path_kernel as pk
from tpu_rt_torch.scene import types as TT

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "golden"))
import make_envmap_golden as G  # noqa: E402
from torch_port_scenes import polarizer_desc  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    return np.load(G.OUT)


def test_render_matches_the_tpu_rt_golden(golden):
    sc = tpu_rt_torch.load_file(G.POLARIZERS, res=G.RENDER["res"], spp=2)
    img = tpu_rt_torch.render(sc, spp=2, seed=G.RENDER["seed"], device="cpu", tile_rows=8)
    rays = int(tpu_rt_torch.render.last_ray_count)
    want = golden["render_2"]
    assert img.shape == want.shape == (32, 32, 3) and img.dtype == torch.float32
    assert bool(torch.isfinite(img).all())
    assert G.render_gate(img.numpy(), want) <= G.CPU_LIMIT
    assert abs(rays - int(golden["render_2_rays"])) <= 0.01 * int(golden["render_2_rays"])
    assert img.max() > 5.0  # the sun is in view


def test_per_sample_route_agrees_with_the_wavefront():
    """At 128 spp: the block around the sun carries the jitter noise of
    its rim (0.16 of the mean at 64 spp for one pair of seeds, 0.009 for
    another).  A path here has at most three segments (two sheets and the
    escape), so max_depth 4 loses nothing."""
    sc = tpu_rt_torch.load_file(G.POLARIZERS, res=32, spp=1).replace(max_depth=4)
    imp, _ = pk.render_sample_film(sc, spp=128, seed=1, device="cpu")
    imx = wavefront.render(sc, spp=128, seed=2, device="cpu")
    imp, imx = imp.numpy(), imx.numpy()
    assert np.isfinite(imp).all() and np.isfinite(imx).all()
    assert abs(imp.mean() - imx.mean()) / imx.mean() < 0.02

    def blk(x):
        return x.reshape(4, 8, 4, 8, 3).mean(axis=(1, 3))

    assert (np.abs(blk(imp) - blk(imx)) / imx.mean() < 0.2).all()


def _spy(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        calls.append(kwargs)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)
    return calls


def test_textured_environment_takes_the_per_sample_route(monkeypatch):
    routes = {name: _spy(monkeypatch, pk, name)
              for name in ("render_sample_film", "render_film", "raygen_trace")}
    wave = _spy(monkeypatch, wavefront, "render")
    sc = tpu_rt_torch.load_file(G.POLARIZERS, res=16, spp=3)
    img = tpu_rt_torch.render(sc, seed=4, device="cpu", tile_rows=8)
    # one K5 call for the 3-sample chunk (render's spp_per_pass, 64)
    assert [len(routes[k]) for k in ("render_sample_film", "render_film", "raygen_trace")] \
        == [1, 0, 1]
    assert routes["render_sample_film"][0]["spp_per_pass"] == 64
    assert not wave and img.shape == (16, 16, 3) and img.mean() > 0
    assert pk.bake_scene(sc).env_textured


def test_polarizers_const_takes_the_film_kernel_and_matches_its_golden(monkeypatch, golden):
    film = _spy(monkeypatch, pk, "render_film")
    per_sample = _spy(monkeypatch, pk, "render_sample_film")
    spp = G.RENDER["const_spp"]
    sc = tpu_rt_torch.load_file(G.POL_CONST, res=G.RENDER["res"], spp=spp)
    bs = pk.bake_scene(sc)
    assert bs is not None and bs.env_rgb == (1.0, 1.0, 1.0) and not bs.env_textured
    assert [bt for bt, _ in bs.bsdfs] == [TT.BSDF_POLARIZER] * 2
    img = tpu_rt_torch.render(sc, spp=spp, seed=G.RENDER["seed"], device="cpu", tile_rows=8)
    assert (len(film), len(per_sample)) == (1, 0)
    rays = int(tpu_rt_torch.render.last_ray_count)
    assert G.render_gate(img.numpy(), golden["const_render"]) <= G.CPU_LIMIT
    assert abs(rays - int(golden["const_render_rays"])) <= 0.01 * int(golden["const_render_rays"])
    # through no sheet 1, one 0.5, two 0.25: the tints of the pass-through lane
    t = pk.pack_tables(bs, sc.camera, 8, "cpu")
    for rec in range(2):
        off = t.hdr_list[pk.HDR_OFF_BSDF] + rec * pk.BSDF_STRIDE
        assert t.tab_list[off + 1:off + 4] == [0.5, 0.5, 0.5]


def test_stokes_kernels_refuse_polarizers_and_textured_environments():
    pol = tpu_rt_torch.load_dict(polarizer_desc(tpu_rt_torch.ScalarTransform4f, [0.0], [0.0]))
    tex = tpu_rt_torch.load_file(G.POLARIZERS, res=8, spp=1)
    null_only = tex.replace(bsdf_type=torch.full_like(tex.bsdf_type, TT.BSDF_NULL))
    for sc in (pol, tex, null_only):
        assert pk.bake_scene(sc) is not None
    assert not pk.stokes_in_scope(pk.bake_scene(pol))  # a polarizer
    assert not pk.stokes_in_scope(pk.bake_scene(tex))  # a textured environment
    assert not pk.stokes_in_scope(pk.bake_scene(null_only))
    const = tpu_rt_torch.load_file(G.POL_CONST, res=8, spp=1)
    nulls = const.replace(bsdf_type=torch.full_like(const.bsdf_type, TT.BSDF_NULL))
    assert pk.stokes_in_scope(pk.bake_scene(nulls))  # null passes through K3
    S = stokes_t.render_stokes(nulls, spp=1, device="cpu", tile_rows=8)
    # null sheets change nothing: the constant white environment, unpolarized
    np.testing.assert_allclose(S[..., 0, :].numpy(), 1.0, rtol=1e-6)
    assert float(S[..., 1:, :].abs().max()) == 0.0


def test_stokes_scene_under_the_envmap_stays_on_the_stokes_wavefront(monkeypatch):
    """render_stokes of the fixture: the Stokes wavefront looks the real map
    up at each escape (no Stokes kernel runs); the sheets polarize it."""
    kernel = _spy(monkeypatch, pk, "render_stokes_film")
    sc = tpu_rt_torch.load_file(G.POLARIZERS, res=16, spp=4)
    S = stokes_t.render_stokes(sc, seed=3, device="cpu")
    assert not kernel and S.shape == (16, 16, 4, 3) and bool(torch.isfinite(S).all())
    I = S[..., 0, :]
    assert I.min() >= 0.0 and I.max() > 5.0  # the sun, through to_world and scale
    assert (S[..., 1, :] ** 2).mean().sqrt() > 0.05 * I.mean()
