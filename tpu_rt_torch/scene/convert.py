"""Carry a scene's state across as plain arrays.

``scene_from_arrays`` builds the port's ``Scene`` from numpy arrays named
after its fields plus the static metadata.  The XML/dict builder ends
here, and so does a scene handed over from the JAX package: a caller
takes ``np.asarray`` of each field of a ``tpu_rt`` scene, so this package
never sees a JAX array.

Array names: the ``Geometry`` and ``Emitters`` tensor fields (the
optional mesh cluster tables may be absent or None; their cull hierarchy
``cl_tree`` is built from ``cl_bounds`` where it is absent),
``shape_bsdf``, ``shape_emitter``, ``bsdf_type``, ``bsdf_params``,
``shape_to_world`` (optional: the polarizer's axis frame), ``tex_data``,
``tex_hw`` and ``bsdf_tex`` (present where ``has_textures`` is set), and
``camera_<field>`` for the camera's tensor fields, ``us_<field>`` for
the ultrasound configuration's.  ``meta`` holds the ints and flags:
``n_tris``, ``n_analytic``, ``n_area``, ``n_point``, ``has_env``,
``has_textures``, ``integrator``, ``max_depth``, ``rr_depth``,
``hide_emitters``, ``ids`` (optional: the description's shape and BSDF
names, as ``Scene.ids``), ``camera`` (a dict of the camera's static fields, or
absent) and ``ultrasound`` (a dict of the ultrasound configuration's
static fields, or absent).  The
sets of analytic shape types and of BSDF types present are computed here
from ``an_type`` and ``bsdf_type``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_rt_torch.scene.types import Camera, Emitters, Geometry, Scene, UltrasoundConfig


def _tensor_fields(cls):
    return [f.name for f in dataclasses.fields(cls) if f.type == "torch.Tensor"]


# optional fields derived from the others, not carried: the cull hierarchy
# over the cluster boxes
_DERIVED = ("cl_tree",)


def optional_tensor_fields(cls):
    """Fields that a caller carries as a tensor or None (the mesh cluster
    tables; not ``cl_tree``, which is built from them)."""
    return [f.name for f in dataclasses.fields(cls)
            if f.type == "Optional[torch.Tensor]" and f.name not in _DERIVED]


def scene_from_arrays(arrays: dict, meta: dict) -> Scene:
    def t(name):
        return torch.from_numpy(np.array(arrays[name]))

    cl_tree = None
    if arrays.get("cl_tree") is not None:
        cl_tree = t("cl_tree")
    elif arrays.get("cl_bounds") is not None:  # a scene handed over from tpu_rt
        from tpu_rt_torch.ops.mesh_kernel import build_cluster_tree

        cl_tree = torch.from_numpy(build_cluster_tree(np.asarray(arrays["cl_bounds"])))
    geometry = Geometry(
        **{k: t(k) for k in _tensor_fields(Geometry)},
        **{k: None if arrays.get(k) is None else t(k)
           for k in optional_tensor_fields(Geometry)},
        cl_tree=cl_tree,
        n_tris=int(meta["n_tris"]), n_analytic=int(meta["n_analytic"]),
        analytic_types=tuple(sorted(set(np.asarray(arrays["an_type"]).tolist()))),
    )
    emitters = Emitters(
        **{k: t(k) for k in _tensor_fields(Emitters)},
        n_area=int(meta["n_area"]), n_point=int(meta["n_point"]),
        has_env=bool(meta["has_env"]),
    )
    camera = None
    if meta.get("camera") is not None:
        camera = Camera(**{k: t("camera_" + k) for k in _tensor_fields(Camera)},
                        **meta["camera"])
    ultrasound = None
    if meta.get("ultrasound") is not None:
        ultrasound = UltrasoundConfig(
            **{k: t("us_" + k) for k in _tensor_fields(UltrasoundConfig)},
            **meta["ultrasound"])
    bsdf_type = t("bsdf_type")
    return Scene(
        geometry=geometry,
        emitters=emitters,
        shape_bsdf=t("shape_bsdf"),
        shape_emitter=t("shape_emitter"),
        bsdf_type=bsdf_type,
        bsdf_types_present=tuple(sorted(set(bsdf_type.tolist()))),
        bsdf_params=t("bsdf_params"),
        shape_to_world=None if arrays.get("shape_to_world") is None else t("shape_to_world"),
        **{k: t(k) if meta["has_textures"] else None
           for k in ("tex_data", "tex_hw", "bsdf_tex")},
        camera=camera,
        ultrasound=ultrasound,
        has_textures=bool(meta["has_textures"]),
        integrator=int(meta["integrator"]),
        max_depth=int(meta["max_depth"]),
        rr_depth=int(meta["rr_depth"]),
        hide_emitters=bool(meta["hide_emitters"]),
        ids=meta.get("ids"),
    )
