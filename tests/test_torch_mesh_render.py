"""The mesh scenes through the port's public ``render`` on the CPU: the
dispatch, the whole direct render against tpu_rt's, and the two mesh
golden gates (tests/golden/make_mesh_golden.py) held by the plain
versions, as chip_smoke.py holds the kernels to them on the card.

The direct render's jitter is a ``torch.Generator`` in the port and
``jax.random`` in tpu_rt, so the two agree statistically only.  At 32x32,
16 spp: the image mean within 1%, the ray count within 1%, and the
relative RMSE of the 8x8 block means within 8% (two renders of other
streams give 4.3% to 6.1%: the noise sits on the knot's silhouette and
shadow edges, where the jitter decides coverage).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import tpu_rt
import tpu_rt_torch
from tpu_rt.ops import pallas_mesh
from tpu_rt_torch.ops import mesh_kernel, path_kernel
from tpu_rt_torch.scene import types as TT

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
MESH = os.path.join(HERE, "assets", "mesh")
SIMPLE = os.path.join(MESH, "simple.xml")
MESH_GI = os.path.join(MESH, "mesh_gi.xml")


def _gates():
    spec = importlib.util.spec_from_file_location(
        "make_mesh_golden", os.path.join(HERE, "golden", "make_mesh_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _block_means(img):
    return img.reshape(img.shape[0] // 8, 8, img.shape[1] // 8, 8, 3).mean(axis=(1, 3))


def test_direct_render_matches_tpu_rt_statistically(monkeypatch):
    monkeypatch.setattr(pallas_mesh, "INTERPRET", True)
    sj = tpu_rt.load_file(SIMPLE, res=32, spp=16)
    st = tpu_rt_torch.load_file(SIMPLE, res=32, spp=16)
    want = np.asarray(tpu_rt.render(sj, spp=16, seed=0))
    want_rays = int(pallas_mesh.mesh_direct_render.last_ray_count)
    got = tpu_rt_torch.render(st, spp=16, seed=0, device="cpu")
    assert got.shape == (32, 32, 3) and got.dtype == torch.float32
    got = got.numpy()
    rays = int(tpu_rt_torch.render.last_ray_count)
    assert abs(got.mean() - want.mean()) <= 0.01 * want.mean()
    assert abs(rays - want_rays) <= 0.01 * want_rays
    a, b = _block_means(got), _block_means(want)
    assert np.sqrt(((a - b) ** 2).mean()) / b.mean() <= 0.08


def _spy(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)
    return calls


def test_render_sends_a_direct_mesh_scene_to_the_direct_kernel(monkeypatch):
    calls = _spy(monkeypatch, mesh_kernel, "mesh_direct_render")
    film = _spy(monkeypatch, path_kernel, "render_film")
    st = tpu_rt_torch.load_file(SIMPLE, res=8, spp=2)
    img = tpu_rt_torch.render(st, seed=3, device="cpu")
    assert len(calls) == 1 and not film
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
    rays = tpu_rt_torch.render.last_ray_count
    assert rays.dim() == 0 and rays.dtype == torch.int64 and int(rays) > 8 * 8 * 2


def test_direct_projective_renders_as_direct(monkeypatch):
    calls = _spy(monkeypatch, mesh_kernel, "mesh_direct_render")
    st = tpu_rt_torch.load_file(SIMPLE, res=8, spp=2)
    img = tpu_rt_torch.render(st, seed=3, device="cpu")
    proj = tpu_rt_torch.render(st.replace(integrator=TT.INTEGRATOR_DIRECT_PROJECTIVE),
                               seed=3, device="cpu")
    assert len(calls) == 2 and torch.equal(img, proj)


def test_render_sends_a_mesh_path_scene_to_the_film_kernels_mesh_mode(monkeypatch):
    film = _spy(monkeypatch, path_kernel, "render_film")
    direct = _spy(monkeypatch, mesh_kernel, "mesh_direct_render")
    st = tpu_rt_torch.load_file(MESH_GI, res=8, spp=2)
    img = tpu_rt_torch.render(st, seed=3, device="cpu", tile_rows=8)
    assert len(film) == 1 and not direct
    assert film[0][1]["baked"].mesh is not None
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
    assert int(tpu_rt_torch.render.last_ray_count) > 8 * 8 * 2


@pytest.mark.parametrize("which", ["analytic", "few_triangles", "area_light"])
def test_direct_scene_outside_the_kernels_scope_raises_naming_A4(which):
    desc = {
        "type": "scene",
        "integrator": {"type": "direct"},
        "sensor": {"type": "perspective", "fov": 40,
                   "film": {"type": "hdrfilm", "width": 8, "height": 8}},
        "knot": {"type": "ply", "filename": os.path.join(MESH, "knot.ply"),
                 "bsdf": {"type": "diffuse"}},
        "light": {"type": "point", "position": [3, 4, 3], "intensity": 50.0},
    }
    if which == "analytic":
        desc["ball"] = {"type": "sphere", "bsdf": {"type": "diffuse"}}
    elif which == "few_triangles":  # no cluster tables under 193 triangles
        desc["knot"] = {"type": "rectangle", "bsdf": {"type": "diffuse"}}
    else:
        desc["lamp"] = {"type": "rectangle", "emitter": {"type": "area", "radiance": 1.0}}
    st = tpu_rt_torch.load_dict(desc)
    # ROADMAP.md A4 landed: the wavefront tracer renders it at max_depth 2
    assert mesh_kernel.bake_direct_scene(st) is None
    wave = []
    from tpu_rt_torch.integrator import path as wavefront

    render_wave = wavefront.render

    def spy(*args, **kwargs):
        wave.append(kwargs)
        return render_wave(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wavefront, "render", spy)
        img = tpu_rt_torch.render(st, spp=1, device="cpu")
    assert len(wave) == 1 and wave[0]["max_depth"] == 2
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())


def test_direct_golden_gate_holds_for_the_plain_version():
    gates = _gates()
    want = np.load(os.path.join(HERE, "golden", gates.DIRECT["out"]))
    assert int(want["res"]) == 64
    st = tpu_rt_torch.load_file(SIMPLE, res=64, spp=256)
    img = tpu_rt_torch.render(st, spp=256, seed=1, device="cpu").numpy()
    assert np.isfinite(img).all()
    assert gates.direct_gate(img, want["img"]) <= gates.DIRECT_LIMIT


def test_gi_golden_gate_holds_for_the_plain_version():
    gates = _gates()
    want = np.load(os.path.join(HERE, "golden", gates.GI["out"]))
    st = tpu_rt_torch.load_file(MESH_GI, res=32, spp=16)
    img = tpu_rt_torch.render(st, spp=16, seed=int(want["seed"]), device="cpu",
                              tile_rows=8).numpy()
    rays = int(tpu_rt_torch.render.last_ray_count)
    assert gates.gi_gate(img, want["img"]) <= gates.GI_LIMIT
    assert abs(rays - int(want["rays"])) <= 0.01 * int(want["rays"])
    # the gate tells streams apart: another seed fails it
    other = tpu_rt_torch.render(st, spp=16, seed=int(want["seed"]) + 1, device="cpu",
                                tile_rows=8).numpy()
    assert gates.gi_gate(other, want["img"]) > 10 * gates.GI_LIMIT
