"""tpu_rt_torch scene layer and bake against tpu_rt's, on the CPU.

Both packages load the in-repo cbox fixture (tests/assets/cbox/cbox.xml)
and the white-furnace dict scene of test_pallas_kernel.py; the scene
arrays and the film kernel's baked constants must be equal.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import tpu_rt
import tpu_rt_torch
from tpu_rt.ops import pallas_path
from tpu_rt_torch.integrator import render as torch_render
from tpu_rt_torch.ops import path_kernel
from tpu_rt_torch.scene import scene_from_arrays
from tpu_rt_torch.scene.convert import optional_tensor_fields
from tpu_rt_torch.scene import types as TT

torch.set_num_threads(1)

CBOX = os.path.join(os.path.dirname(__file__), "assets", "cbox", "cbox.xml")


def _tensor_fields(cls):
    return [f.name for f in dataclasses.fields(cls) if f.type == "torch.Tensor"]


def tpu_rt_arrays(scene):
    """A tpu_rt scene's state as numpy arrays + metadata for
    ``scene_from_arrays`` (the port itself never sees a JAX array)."""
    arrays = {k: np.asarray(getattr(scene.geometry, k)) for k in _tensor_fields(TT.Geometry)}
    for k in optional_tensor_fields(TT.Geometry):  # the mesh cluster tables, or None
        v = getattr(scene.geometry, k)
        arrays[k] = None if v is None else np.asarray(v)
    arrays.update({k: np.asarray(getattr(scene.emitters, k))
                   for k in _tensor_fields(TT.Emitters)})
    for k in ("shape_bsdf", "shape_emitter", "bsdf_type", "bsdf_params", "shape_to_world"):
        arrays[k] = np.asarray(getattr(scene, k))
    if scene.has_textures:  # the atlas, the true sizes, each BSDF row's texture
        arrays.update({k: np.asarray(getattr(scene, k)) for k in ("tex_data", "tex_hw", "bsdf_tex")})
    meta = dict(
        n_tris=scene.geometry.n_tris, n_analytic=scene.geometry.n_analytic,
        n_area=scene.emitters.n_area, n_point=scene.emitters.n_point,
        has_env=scene.emitters.has_env, has_textures=scene.has_textures,
        integrator=scene.integrator, max_depth=scene.max_depth,
        rr_depth=scene.rr_depth, hide_emitters=scene.hide_emitters,
    )
    cam = scene.camera
    if cam is not None:
        for k in _tensor_fields(TT.Camera):
            arrays["camera_" + k] = np.asarray(getattr(cam, k))
        meta["camera"] = dict(width=cam.width, height=cam.height,
                              filter_type=cam.filter_type, spp=cam.spp,
                              pixel_format=cam.pixel_format)
    us = scene.ultrasound
    if us is not None:
        for f in dataclasses.fields(TT.UltrasoundConfig):
            if f.type == "torch.Tensor":
                arrays["us_" + f.name] = np.asarray(getattr(us, f.name))
        meta["ultrasound"] = {f.name: getattr(us, f.name)
                              for f in dataclasses.fields(TT.UltrasoundConfig)
                              if f.type != "torch.Tensor"}
    return arrays, meta


def furnace_desc(st):
    """test_pallas_kernel.py::test_pallas_furnace_constant_env's scene."""
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 8},
        "sensor": {
            "type": "perspective", "fov": 40,
            "to_world": st().look_at(origin=[0, 0, -4], target=[0, 0, 0], up=[0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 16, "height": 16,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": 8},
        },
        "sph": {"type": "sphere",
                "bsdf": {"type": "diffuse", "reflectance": np.full(3, 0.7)}},
        "env": {"type": "constant", "radiance": np.ones(3)},
    }


def _pair(which):
    if which == "cbox":
        return (tpu_rt.load_file(CBOX, res=16, spp=2),
                tpu_rt_torch.load_file(CBOX, res=16, spp=2))
    return (tpu_rt.load_dict(furnace_desc(tpu_rt.ScalarTransform4f)),
            tpu_rt_torch.load_dict(furnace_desc(tpu_rt_torch.ScalarTransform4f)))


def _assert_bake_equal(bj, bt):
    assert [p.kind for p in bt.prims] == [p.kind for p in bj.prims]
    for pj, pt in zip(bj.prims, bt.prims):
        assert (pt.bsdf, pt.emitter) == (pj.bsdf, pj.emitter)
        flat = lambda data: np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in data])  # noqa: E731
        np.testing.assert_array_equal(flat(pt.data), flat(pj.data))
    assert bt.bsdfs == bj.bsdfs
    assert bt.em_radiance == bj.em_radiance
    assert bt.em_area == bj.em_area
    assert bt.em_tris == bj.em_tris
    assert bt.point_lights == bj.point_lights
    assert bt.env_rgb == bj.env_rgb
    assert (bt.n_lights, bt.max_depth, bt.rr_depth, bt.hide_emitters) == (
        bj.n_lights, bj.max_depth, bj.rr_depth, bj.hide_emitters)


@pytest.mark.parametrize("which", ["cbox", "furnace"])
def test_loader_parity(which):
    sj, st = _pair(which)
    arrays, meta = tpu_rt_arrays(sj)
    names = (_tensor_fields(TT.Geometry), _tensor_fields(TT.Emitters),
             ["shape_bsdf", "shape_emitter", "bsdf_type", "bsdf_params"])
    for group, obj in zip(names, (st.geometry, st.emitters, st)):
        for k in group:
            np.testing.assert_array_equal(getattr(obj, k).numpy(), arrays[k], err_msg=k)
    for k in _tensor_fields(TT.Camera):
        np.testing.assert_allclose(getattr(st.camera, k).numpy(), arrays["camera_" + k],
                                   rtol=1e-6, err_msg=k)
    for k, v in meta["camera"].items():
        assert getattr(st.camera, k) == v, k
    for k in ("n_tris", "n_analytic"):
        assert getattr(st.geometry, k) == meta[k]
    for k in ("n_area", "n_point", "has_env"):
        assert getattr(st.emitters, k) == meta[k]
    for k in ("integrator", "max_depth", "rr_depth", "hide_emitters"):
        assert getattr(st, k) == meta[k], k


@pytest.mark.parametrize("which", ["cbox", "furnace"])
def test_bake_parity(which):
    sj, st = _pair(which)
    _assert_bake_equal(pallas_path.bake_scene(sj), path_kernel.bake_scene(st))


def test_fixture_geometry():
    bs = path_kernel.bake_scene(tpu_rt_torch.load_file(CBOX, res=16, spp=1))
    kinds = [p.kind for p in bs.prims]
    assert kinds.count("tri") == 12 and kinds.count("sphere") == 2
    assert len(bs.em_tris) == 1 and len(bs.em_tris[0]) == 2
    assert bs.em_tris[0][-1][1] == pytest.approx(1.0)
    radii = sorted(p.data[1] for p in bs.prims if p.kind == "sphere")
    np.testing.assert_allclose(radii, [0.25, 0.5], rtol=1e-5)
    for p in bs.prims:
        if p.kind != "tri":
            continue
        p0, e1, e2, ng = (np.asarray(x, np.float64) for x in p.data)
        centroid = p0 + (e1 + e2) / 3.0
        assert np.dot(ng, -centroid) > 0.0, "geometric normal must face into the box"
        if p.emitter >= 0:
            np.testing.assert_allclose(ng, [0.0, -1.0, 0.0], atol=1e-7)
    assert (bs.max_depth, bs.rr_depth, bs.n_lights) == (6, 5, 1)


def test_scene_from_arrays_bakes_like_load_file():
    sj = tpu_rt.load_file(CBOX, res=16, spp=2)
    carried = scene_from_arrays(*tpu_rt_arrays(sj))
    _assert_bake_equal(path_kernel.bake_scene(tpu_rt_torch.load_file(CBOX, res=16, spp=2)),
                       path_kernel.bake_scene(carried))
    t1 = path_kernel.pack_tables(path_kernel.bake_scene(carried), carried.camera, 8, "cpu")
    t2 = path_kernel.pack_tables(pallas_bake_as_port(sj), carried.camera, 8, "cpu")
    assert t1.tab_list == t2.tab_list and t1.hdr_list == t2.hdr_list


def pallas_bake_as_port(sj):
    """tpu_rt's own bake, in the port's BakedScene type."""
    bj = pallas_path.bake_scene(sj)
    return path_kernel.BakedScene(
        prims=[path_kernel.BakedPrim(p.kind, p.data, p.bsdf, p.emitter) for p in bj.prims],
        bsdfs=bj.bsdfs, em_radiance=bj.em_radiance, em_area=bj.em_area,
        em_tris=bj.em_tris, point_lights=bj.point_lights, env_rgb=bj.env_rgb,
        env_textured=bj.env_textured, n_lights=bj.n_lights, max_depth=bj.max_depth, rr_depth=bj.rr_depth,
        hide_emitters=bj.hide_emitters)


@pytest.mark.parametrize("shape,in_scope", [
    ({"type": "sphere", "bsdf": {"type": "roughconductor", "alpha": 0.2}}, True),
    ({"type": "cone", "bsdf": {"type": "diffuse"}}, True),
    ({"type": "disk", "bsdf": {"type": "diffuse"}}, False),
    ({"type": "cylinder", "bsdf": {"type": "diffuse"}}, False),
], ids=["shape0", "shape1", "shape2", "shape3"])
def test_out_of_scope_scene(shape, in_scope):
    """The film kernel's scope is tpu_rt's: a rough conductor and a cone
    are in it, and the port's bake and packed tables equal tpu_rt's bake's;
    a disk and a cylinder are outside it in both packages, and the
    wavefront tracer renders them."""
    desc = furnace_desc(tpu_rt.ScalarTransform4f)
    desc["sph"] = shape
    sj = tpu_rt.load_dict(desc)
    carried = scene_from_arrays(*tpu_rt_arrays(sj))
    bt = path_kernel.bake_scene(carried)
    assert (bt is not None) == in_scope == (pallas_path.bake_scene(sj) is not None)
    if in_scope:
        _assert_bake_equal(pallas_path.bake_scene(sj), bt)
        t1 = path_kernel.pack_tables(bt, carried.camera, 8, "cpu")
        t2 = path_kernel.pack_tables(pallas_bake_as_port(sj), carried.camera, 8, "cpu")
        assert t1.tab_list == t2.tab_list and t1.hdr_list == t2.hdr_list
        assert t1.rough_cone
        return
    img = torch_render(carried, spp=1, device="cpu")
    assert img.shape == (16, 16, 3) and bool(torch.isfinite(img).all()) and img.mean() > 0


def test_loader_names_roadmap_for_unported_plugins():
    desc = furnace_desc(tpu_rt_torch.ScalarTransform4f)
    # the polarizer and the stokes integrator load since polarized
    # transport was ported, a bitmap texture and a bsplinecurve since
    # textures and curves were (ROADMAP A8)
    desc["sph"] = {"type": "sphere", "bsdf": {"type": "polarizer"}}
    assert tpu_rt_torch.load_dict(desc).bsdf_type.tolist() == [TT.BSDF_POLARIZER]
    assets = os.path.join(os.path.dirname(__file__), "assets")
    desc["sph"] = {"type": "sphere", "bsdf": {"type": "diffuse", "reflectance": {
        "type": "bitmap", "filename": os.path.join(assets, "textured", "gray16.png")}}}
    tex = tpu_rt_torch.load_dict(desc)
    assert tex.has_textures and tex.tex_data.shape == (1, 40, 48, 3)
    assert tex.bsdf_tex.tolist() == [0]
    desc["sph"] = {"type": "bsplinecurve",
                   "filename": os.path.join(assets, "shadow_art", "wire.txt")}
    curve = tpu_rt_torch.load_dict(desc).geometry
    assert curve.n_analytic == 192 and set(curve.an_type.tolist()) == {TT.CURVE}
    assert bool((curve.an_param > 0).all())
    # the envmap loads since the textured environment was ported
    desc["sph"] = {"type": "sphere", "bsdf": {"type": "diffuse"}}
    desc["env"] = {"type": "envmap", "scale": 2.0, "filename": os.path.join(
        os.path.dirname(__file__), "assets", "polarizers", "envmap.exr")}
    env = tpu_rt_torch.load_dict(desc).emitters
    assert env.has_env and env.env_map.shape == (256, 512, 3)
