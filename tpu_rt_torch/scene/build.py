"""Scene compiler: Mitsuba-style description dict -> ``Scene``.

Counterpart of ``tpu_rt/scene/build.py``, for the subset the cbox class of
scenes, the mesh scenes and the ultrasound scenes use: ``perspective`` +
``hdrfilm`` with a box / tent / gaussian rfilter, the ``independent``
sampler, the ``path``, ``direct``, ``direct_projective`` and
``ultrasound_integrator`` integrators and ``stokes`` wrapping one of
them, the ``ultrasound_sensor``, ``obj`` /
``ply`` / ``sphere`` / ``rectangle`` / ``disk`` / ``cylinder`` / ``cone``
shapes and ``bsplinecurve`` (exact swept-sphere spans, or a tube mesh
with ``curve_mode="mesh"``), ``diffuse`` (its reflectance a constant or
a ``bitmap`` texture: PNG, JPEG or EXR) / ``dielectric`` / ``conductor`` /
``roughconductor`` / ``polarizer`` / ``null`` / ``ultrasound_bsdf`` /
``twosided`` BSDFs, ``area`` / ``point`` / ``constant`` / ``envmap``
emitters (the envmap's EXR read by ``scene/exr.py``, times its ``scale``,
in the frame of its ``to_world``) and the ``ultraray`` /
``ultrasound_emitter`` transducer props.  Every other plugin raises
``ValueError``.

Meshes are transformed to world space (vertex normals by the inverse
transpose), the BVH is built by the same native builder, the mesh cluster
tables are cut from it, and the emitter tables are built with the same
numpy arithmetic as the JAX package, so both packages bake identical
kernel constants.
"""

from __future__ import annotations

import math as pymath
import os

import numpy as np

from tpu_rt_torch.geometry.bvh import build_bvh
from tpu_rt_torch.ops import mesh_kernel
from tpu_rt_torch.scene import transforms as tf
from tpu_rt_torch.scene import types as T
from tpu_rt_torch.scene.convert import scene_from_arrays
from tpu_rt_torch.scene.curves import flatten_bspline, tessellate_bspline_tube
from tpu_rt_torch.scene.obj import load_obj
from tpu_rt_torch.scene.ply import load_ply

_BSDF_TYPES = {"diffuse", "dielectric", "conductor", "roughconductor", "polarizer",
               "null", "ultrasound_bsdf", "twosided"}
_TRANSDUCER_EMITTERS = {"ultraray", "ultrasound_emitter"}
_EMITTERS_IN_SHAPES = {"area"} | _TRANSDUCER_EMITTERS
_ANALYTIC_ENUM = {"sphere": T.SPHERE, "rectangle": T.RECTANGLE, "disk": T.DISK,
                  "cylinder": T.CYLINDER, "cone": T.CONE}
_FILTERS = {"box": T.FILTER_BOX, "tent": T.FILTER_TENT,
            "gaussian": T.FILTER_GAUSSIAN}
_INTEGRATORS = {"path": T.INTEGRATOR_PATH, "direct": T.INTEGRATOR_DIRECT,
                "direct_projective": T.INTEGRATOR_DIRECT_PROJECTIVE,
                "ultrasound_integrator": T.INTEGRATOR_ULTRASOUND}

# Default IORs of Mitsuba's dielectric plugin.
_IOR = {"bk7": 1.5046, "air": 1.000277, "water": 1.3330, "diamond": 2.419}


def _unsupported(kind, name):
    raise ValueError(f"unsupported {kind} {name!r}")


def _rgb(v, default):
    if v is None:
        v = default
    arr = np.asarray(v, np.float32).reshape(-1)
    if arr.size == 1:
        arr = np.repeat(arr, 3)
    return arr[:3]


def _plugin_child(d, types):
    return next((v for v in d.values()
                 if isinstance(v, dict) and v.get("type") in types), None)


class _Builder:
    def __init__(self, curve_mode="exact"):
        if curve_mode not in ("exact", "mesh"):
            raise ValueError(f"curve_mode is 'exact' or 'mesh', not {curve_mode!r}")
        self.curve_mode = curve_mode
        self.bsdf_rows = []  # (type, params[16])
        self.bsdf_index = {}  # id(dict) -> index
        self.bsdf_tex = []  # per BSDF row its texture, -1: constant
        self.textures = []  # decoded float32 (H, W, 3) images
        self.texture_index = {}  # (absolute filename, raw) -> texture
        self.bsdf_names = {}  # scene key or id -> BSDF row
        self.shape_names = {}  # scene key -> shape id
        self.shape_bsdf = []
        self.shape_emitter = []
        self.shape_to_world = []
        self.shape_tri_ranges = []  # per shape: (tri_start, tri_end)
        self.tri = {k: [] for k in ("p0", "e1", "e2", "n0", "n1", "n2",
                                    "uv0", "uv1", "uv2", "shape")}
        # "param": a CURVE prim's (r0, r1) over its length, else zeros;
        # "bb": its exact world box, else None (the image of [-1, 1]^3)
        self.an = {"type": [], "to_world": [], "shape": [], "param": [], "bb": []}
        self.area_radiance = []
        self.area_shape = []  # shape id of each area emitter
        self.point_pos = []
        self.point_intensity = []
        self.env = None
        self.camera = None
        self.integrator = T.INTEGRATOR_PATH
        self.max_depth = -1
        self.rr_depth = 5
        self.hide_emitters = False
        self.us_int = {}
        self.us_sensor = {}
        self.us_emitter = {}

    # -- BSDFs ---------------------------------------------------------------

    def add_bsdf(self, bd, name=None):
        if bd is None:
            bd = {"type": "diffuse", "reflectance": np.full(3, 0.5, np.float32)}
        key = id(bd)
        if key in self.bsdf_index:
            return self.bsdf_index[key]
        btype = bd.get("type")
        if btype == "twosided":
            idx = self.add_bsdf(_plugin_child(bd, _BSDF_TYPES), name)
            self.bsdf_index[key] = idx
            return idx
        p = np.zeros(16, np.float32)
        tex = -1
        if btype == "diffuse":
            code = T.BSDF_DIFFUSE
            refl = bd.get("reflectance")
            if isinstance(refl, dict):
                if refl.get("type") != "bitmap":
                    _unsupported("texture", refl.get("type"))
                tex = self._add_texture(refl)
                # the constant row holds the texture's mean: the Stokes
                # routes read it, the scalar wavefront reads the texture
                p[0:3] = self.textures[tex].reshape(-1, 3).mean(0)
            else:
                p[0:3] = _rgb(refl, 0.5)
        elif btype == "dielectric":
            code = T.BSDF_DIELECTRIC
            int_ior = bd.get("int_ior", "bk7")
            ext_ior = bd.get("ext_ior", "air")
            p[0] = _IOR.get(int_ior, int_ior if isinstance(int_ior, (int, float)) else 1.5046)
            p[1] = _IOR.get(ext_ior, ext_ior if isinstance(ext_ior, (int, float)) else 1.000277)
            p[3:6] = _rgb(bd.get("specular_reflectance"), 1.0)
            p[6:9] = _rgb(bd.get("specular_transmittance"), 1.0)
        elif btype in ("conductor", "roughconductor"):
            code = T.BSDF_CONDUCTOR if btype == "conductor" else T.BSDF_ROUGH_CONDUCTOR
            if "eta" in bd:
                p[0:3] = _rgb(bd.get("eta"), 0.0)
                p[3:6] = _rgb(bd.get("k"), 1.0)
            else:
                p[0] = -1.0  # marker: perfect mirror (Mitsuba material="none")
            p[6:9] = _rgb(bd.get("specular_reflectance"), 1.0)
            p[9] = float(np.asarray(bd.get("alpha", 0.1)).reshape(-1)[0])
        elif btype == "polarizer":
            code = T.BSDF_POLARIZER
            p[0] = float(np.asarray(bd.get("theta", 0.0)).reshape(-1)[0])
            p[3:6] = _rgb(bd.get("transmittance"), 1.0)
        elif btype == "ultrasound_bsdf":
            code = T.BSDF_ULTRASOUND
            p[0] = float(bd.get("impedance", 1.54))
            p[1] = float(bd.get("roughness", 0.5))
            p[2] = float(bd.get("exterior_impedance", 1.2))
        elif btype == "null":
            code = T.BSDF_NULL
        else:
            _unsupported("bsdf", btype)
        idx = len(self.bsdf_rows)
        if name:
            self.bsdf_names[name] = idx
        if bd.get("id"):
            self.bsdf_names[bd["id"]] = idx
        self.bsdf_rows.append((code, p))
        self.bsdf_tex.append(tex)
        self.bsdf_index[key] = idx
        return idx

    def _add_texture(self, td):
        """Decode a ``bitmap`` texture into RGB (once per file and ``raw``)
        and return its index.  ``raw`` false decodes sRGB to linear; a
        gray image expands to RGB, and an alpha channel is dropped."""
        fn = td.get("filename")
        if not fn:
            raise ValueError("bitmap texture requires a filename")
        raw = bool(td.get("raw", False))
        key = (os.path.abspath(fn), raw)
        if key in self.texture_index:
            return self.texture_index[key]
        ext = os.path.splitext(fn)[1].lower()
        if ext == ".png":
            from tpu_rt_torch.scene.png import read_png

            img = read_png(fn, srgb=not raw)
        elif ext in (".jpg", ".jpeg"):
            from tpu_rt_torch.scene.jpeg import read_jpeg

            img = read_jpeg(fn, srgb=not raw)
        elif ext == ".exr":
            from tpu_rt_torch.scene.exr import load_exr_or_fallback

            img = load_exr_or_fallback(fn)  # already linear
        else:
            raise ValueError(f"unsupported texture format {ext!r} ({fn})")
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] in (1, 2):  # gray, gray + alpha
            img = np.repeat(img[..., :1], 3, axis=-1)
        elif img.shape[-1] >= 4:
            img = img[..., :3]
        idx = len(self.textures)
        self.textures.append(np.ascontiguousarray(img, np.float32))
        self.texture_index[key] = idx
        return idx

    # -- Shapes --------------------------------------------------------------

    def _add_mesh(self, verts, faces, normals, uvs, to_world, shape_id):
        mw = np.asarray(to_world, np.float32)
        v_world = verts @ mw[:3, :3].T + mw[:3, 3]
        p0 = v_world[faces[:, 0]]
        p1 = v_world[faces[:, 1]]
        p2 = v_world[faces[:, 2]]
        if normals is not None:
            inv_t = np.linalg.inv(mw[:3, :3]).T
            n_world = normals @ inv_t.T
            ln = np.linalg.norm(n_world, axis=-1, keepdims=True)
            n_world = n_world / np.maximum(ln, 1e-12)
            n0, n1, n2 = n_world[faces[:, 0]], n_world[faces[:, 1]], n_world[faces[:, 2]]
        else:
            n0 = n1 = n2 = np.zeros_like(p0)
        if uvs is not None:
            uv0, uv1, uv2 = uvs[faces[:, 0]], uvs[faces[:, 1]], uvs[faces[:, 2]]
        else:
            uv0 = uv1 = uv2 = np.zeros((faces.shape[0], 2), np.float32)
        start = sum(x.shape[0] for x in self.tri["p0"])
        self.tri["p0"].append(p0.astype(np.float32))
        self.tri["e1"].append((p1 - p0).astype(np.float32))
        self.tri["e2"].append((p2 - p0).astype(np.float32))
        self.tri["n0"].append(n0.astype(np.float32))
        self.tri["n1"].append(n1.astype(np.float32))
        self.tri["n2"].append(n2.astype(np.float32))
        self.tri["uv0"].append(uv0.astype(np.float32))
        self.tri["uv1"].append(uv1.astype(np.float32))
        self.tri["uv2"].append(uv2.astype(np.float32))
        self.tri["shape"].append(np.full(faces.shape[0], shape_id, np.int32))
        return start, start + faces.shape[0]

    def add_shape(self, sd, name=None):
        stype = sd.get("type")
        if stype not in ("obj", "ply", "bsplinecurve") and stype not in _ANALYTIC_ENUM:
            _unsupported("shape", stype)
        shape_id = len(self.shape_bsdf)
        if name is not None:
            self.shape_names[name] = shape_id
        bsdf = _plugin_child(sd, _BSDF_TYPES)
        emitter = _plugin_child(sd, _EMITTERS_IN_SHAPES)
        bsdf_idx = self.add_bsdf(bsdf)
        to_world = tf.as_matrix(sd.get("to_world"))

        emitter_idx = -1
        radiance = None
        if emitter is not None:
            if emitter["type"] == "area":
                radiance = _rgb(emitter.get("radiance"), 1.0)
            else:
                # an embedded transducer block: its props configure the
                # acquisition; for light transport it is an area light of
                # its intensity, as in tpu_rt
                self.us_emitter = {k: v for k, v in emitter.items() if k != "type"}
                if "intensity" in emitter:
                    radiance = _rgb(emitter.get("intensity"), 1.0)
        if radiance is not None:
            emitter_idx = len(self.area_radiance)
            self.area_radiance.append(radiance)
            self.area_shape.append(shape_id)

        tri_range = (0, 0)
        if stype in ("obj", "ply"):
            mesh = (load_obj if stype == "obj" else load_ply)(sd["filename"])
            normals = None if sd.get("face_normals", False) else mesh["normals"]
            tri_range = self._add_mesh(mesh["vertices"], mesh["faces"], normals,
                                       mesh["uvs"], to_world, shape_id)
        elif stype == "bsplinecurve" and self.curve_mode == "mesh":
            verts, faces, normals = tessellate_bspline_tube(sd["filename"])
            tri_range = self._add_mesh(verts, faces, normals, None, to_world, shape_id)
        elif stype == "bsplinecurve":
            self._add_curve(sd["filename"], to_world, shape_id)
        else:
            if stype == "sphere" and ("center" in sd or "radius" in sd):
                c = np.asarray(sd.get("center", (0.0, 0.0, 0.0)), np.float32)
                r = float(sd.get("radius", 1.0))
                to_world = to_world @ tf.translate(c) @ tf.scale(r)
            if stype == "cylinder" and ("p0" in sd or "p1" in sd or "radius" in sd):
                pa = np.asarray(sd.get("p0", (0, 0, 0)), np.float64)
                pb = np.asarray(sd.get("p1", (0, 0, 1)), np.float64)
                r = float(sd.get("radius", 1.0))
                axis = pb - pa
                h = np.linalg.norm(axis)
                mrot = np.eye(4, dtype=np.float32)
                mrot[:3, :3] = _frame_from_z(axis / max(h, 1e-12))
                to_world = to_world @ tf.translate(pa) @ mrot @ tf.scale((r, r, h))
            if emitter_idx >= 0 and stype == "rectangle":
                # emissive rectangles become 2 triangles for area sampling
                verts = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                                 np.float32)
                faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
                tri_range = self._add_mesh(verts, faces, None, None, to_world, shape_id)
            elif emitter_idx >= 0:
                raise ValueError(f"area emitter on analytic shape {stype!r} "
                                 "is not supported")
            else:
                self.an["type"].append(_ANALYTIC_ENUM[stype])
                self.an["to_world"].append(to_world)
                self.an["shape"].append(shape_id)
                self.an["param"].append((0.0, 0.0))
                self.an["bb"].append(None)

        self.shape_bsdf.append(bsdf_idx)
        self.shape_emitter.append(emitter_idx)
        self.shape_to_world.append(np.asarray(to_world, np.float32))
        self.shape_tri_ranges.append(tri_range)

    def _add_curve(self, filename, to_world, shape_id):
        """A B-spline as exact swept-sphere prims, one CURVE prim per
        flattened span (tpu_rt/scene/build.py:328-361): the frame of its
        axis times its length h from its start, radii (r0, r1) / h, and the
        exact world box of its two end spheres."""
        pts = flatten_bspline(filename)
        M = np.asarray(to_world, np.float64)
        axn = [float(np.linalg.norm(M[:3, i])) for i in range(3)]
        s_uni = sum(axn) / 3.0
        if max(axn) - min(axn) > 1e-4 * max(s_uni, 1e-12):
            raise NotImplementedError("bsplinecurve with non-uniform to_world scale")
        ctrs = pts[:, :3] @ M[:3, :3].T + M[:3, 3]
        radii = pts[:, 3] * s_uni
        for i in range(len(ctrs) - 1):
            pa, pb = ctrs[i], ctrs[i + 1]
            r0, r1 = float(radii[i]), float(radii[i + 1])
            axis = pb - pa
            h = float(np.linalg.norm(axis))
            if h < 1e-9:
                continue
            if abs(r1 - r0) >= 0.99 * h:
                # one end sphere (nearly) holds the other: the envelope
                # degenerates (1 - dr^2 <= 0)
                raise NotImplementedError(
                    "bsplinecurve radius varies faster than arc length; refine "
                    "samples_per_span")
            mseg = np.eye(4, dtype=np.float64)
            mseg[:3, :3] = _frame_from_z(axis / h).astype(np.float64) * h
            mseg[:3, 3] = pa
            self.an["type"].append(T.CURVE)
            self.an["to_world"].append(mseg.astype(np.float32))
            self.an["shape"].append(shape_id)
            self.an["param"].append((r0 / h, r1 / h))
            lo = np.minimum(pa - r0, pb - r1).astype(np.float32) - 1e-6
            hi = np.maximum(pa + r0, pb + r1).astype(np.float32) + 1e-6
            self.an["bb"].append((lo, hi))

    # -- Emitters, sensor, integrator -----------------------------------------

    def add_emitter(self, ed):
        etype = ed.get("type")
        if etype == "point":
            self.point_pos.append(
                np.asarray(ed.get("position", (0.0, 0.0, 0.0)), np.float32))
            self.point_intensity.append(_rgb(ed.get("intensity"), 1.0))
        elif etype == "envmap":
            from tpu_rt_torch.scene.exr import load_exr_or_fallback

            img = load_exr_or_fallback(ed["filename"])
            self.env = {"map": img * float(ed.get("scale", 1.0)),
                        "to_world": tf.as_matrix(ed.get("to_world"))}
        elif etype == "constant":
            self.env = {"map": _rgb(ed.get("radiance"), 1.0).reshape(1, 1, 3),
                        "to_world": np.eye(4, dtype=np.float32)}
        elif etype in _TRANSDUCER_EMITTERS:
            self.us_emitter = {k: v for k, v in ed.items() if k != "type"}
        else:
            _unsupported("emitter", etype)

    def add_sensor(self, sd):
        if sd.get("type") == "ultrasound_sensor":
            self.us_sensor = {k: v for k, v in sd.items() if k != "type"}
            return
        if sd.get("type") != "perspective":
            _unsupported("sensor", sd.get("type"))
        film = sd.get("film", {})
        width = int(film.get("width", 768))
        height = int(film.get("height", 576))
        rfilter = film.get("rfilter", {})
        ftype = rfilter.get("type", "gaussian") if isinstance(rfilter, dict) else str(rfilter)
        sampler = sd.get("sampler", {})
        fov = float(sd.get("fov", 34.0))
        fov_axis = sd.get("fov_axis", "x")
        aspect = width / height
        tan_half = pymath.tan(pymath.radians(fov) * 0.5)
        if fov_axis == "x" or (fov_axis == "smaller" and aspect <= 1.0) or (
            fov_axis == "larger" and aspect >= 1.0
        ):
            tan_x, tan_y = tan_half, tan_half / aspect
        else:
            tan_x, tan_y = tan_half * aspect, tan_half
        self.camera = dict(
            to_world=tf.as_matrix(sd.get("to_world")),
            tan_fov_x=np.float32(tan_x),
            tan_fov_y=np.float32(tan_y),
            near=np.float32(sd.get("near_clip", 1e-2)),
            far=np.float32(sd.get("far_clip", 1e4)),
            width=width,
            height=height,
            filter_type=_FILTERS.get(ftype, T.FILTER_GAUSSIAN),
            spp=int(sampler.get("sample_count", 4)),
            pixel_format=str(film.get("pixel_format", "rgb")),
        )

    def add_integrator(self, idict):
        itype = idict.get("type")
        if itype == "stokes":
            # the wrapped integrator's depth, roulette and emitter settings
            inner = next((v for v in idict.values() if isinstance(v, dict) and "type" in v),
                         None)
            self.integrator = T.INTEGRATOR_STOKES
            if inner is not None:
                self.max_depth = int(inner.get("max_depth", -1))
                self.rr_depth = int(inner.get("rr_depth", 5))
                self.hide_emitters = bool(inner.get("hide_emitters", False))
            return
        if itype not in _INTEGRATORS:
            _unsupported("integrator", itype)
        self.integrator = _INTEGRATORS[itype]
        if itype == "ultrasound_integrator":
            self.us_int = {k: v for k, v in idict.items() if k != "type"}
            self.max_depth = int(idict.get("max_depth", 2))
            return
        self.hide_emitters = bool(idict.get("hide_emitters", False))
        if itype in ("direct", "direct_projective"):
            self.max_depth = 2  # direct illumination == two path segments
        else:
            self.max_depth = int(idict.get("max_depth", -1))
            self.rr_depth = int(idict.get("rr_depth", 5))

    # -- Finalize --------------------------------------------------------------

    def finalize(self):
        def cat(key, width, dtype=np.float32):
            if self.tri[key]:
                return np.concatenate(self.tri[key], axis=0)
            return np.zeros((0, width) if width else (0,), dtype)

        tri_p0, tri_e1, tri_e2 = cat("p0", 3), cat("e1", 3), cat("e2", 3)
        n_tris = tri_p0.shape[0]
        n_an = len(self.an["type"])
        an_to_world = (np.stack(self.an["to_world"]) if n_an
                       else np.zeros((0, 4, 4), np.float32))
        an_to_object = (np.stack([tf.inverse(x) for x in self.an["to_world"]])
                        if n_an else np.zeros((0, 4, 4), np.float32))
        bvh = build_bvh(*self._prim_bounds(tri_p0, tri_e1, tri_e2, an_to_world,
                                           self.an["bb"]))
        clusters = {}
        if n_tris > mesh_kernel.TREELET_SPLIT:
            cl = mesh_kernel.build_clusters(
                tri_p0, tri_e1, tri_e2, bvh=bvh,
                max_count=mesh_kernel.treelet_size(bvh, n_tris))
            clusters = {"cl_" + k: cl[k] for k in ("tris", "bounds", "prim", "trisw", "tree")}
        arrays = dict(
            tri_p0=tri_p0, tri_e1=tri_e1, tri_e2=tri_e2,
            tri_n0=cat("n0", 3), tri_n1=cat("n1", 3), tri_n2=cat("n2", 3),
            tri_uv0=cat("uv0", 2), tri_uv1=cat("uv1", 2), tri_uv2=cat("uv2", 2),
            tri_shape=cat("shape", 0, np.int32),
            an_type=np.asarray(self.an["type"], np.int32),
            an_to_world=an_to_world.astype(np.float32),
            an_to_object=an_to_object,
            an_shape=np.asarray(self.an["shape"], np.int32),
            an_param=np.asarray(self.an["param"], np.float32).reshape(n_an, 2),
            bvh_min=bvh["node_min"], bvh_max=bvh["node_max"],
            bvh_a=bvh["a"], bvh_b=bvh["b"], bvh_count=bvh["count"],
            prim_order=bvh["prim_order"],
            **clusters,
            shape_bsdf=np.asarray(self.shape_bsdf, np.int32),
            shape_emitter=np.asarray(self.shape_emitter, np.int32),
            bsdf_type=np.asarray([r[0] for r in self.bsdf_rows], np.int32),
            bsdf_params=(np.stack([r[1] for r in self.bsdf_rows]) if self.bsdf_rows
                         else np.zeros((0, 16), np.float32)),
            shape_to_world=(np.stack(self.shape_to_world) if self.shape_to_world
                            else np.zeros((0, 4, 4), np.float32)),
            **self._emitter_arrays(tri_e1, tri_e2),
            **self._texture_arrays(),
        )
        meta = dict(
            n_tris=n_tris, n_analytic=n_an,
            n_area=len(self.area_radiance), n_point=len(self.point_pos),
            has_env=self.env is not None, has_textures=bool(self.textures),
            integrator=self.integrator, max_depth=self.max_depth,
            rr_depth=self.rr_depth, hide_emitters=self.hide_emitters,
            ids={"shapes": dict(self.shape_names), "bsdfs": dict(self.bsdf_names),
                 "shape_bsdf": list(self.shape_bsdf)},
        )
        if self.camera is not None:
            cam = dict(self.camera)
            for k in ("to_world", "tan_fov_x", "tan_fov_y", "near", "far"):
                arrays["camera_" + k] = np.asarray(cam.pop(k), np.float32)
            meta["camera"] = cam
        if self.us_int or self.us_sensor or self.us_emitter:
            us_arrays, meta["ultrasound"] = self._ultrasound()
            arrays.update({"us_" + k: v for k, v in us_arrays.items()})
        return scene_from_arrays(arrays, meta)

    def _texture_arrays(self):
        """The padded atlas (zeros beyond each texture's true size), the
        true sizes and each BSDF row's texture, as tpu_rt lays them out;
        none without a texture."""
        if not self.textures:
            return {}
        hm = max(t.shape[0] for t in self.textures)
        wm = max(t.shape[1] for t in self.textures)
        atlas = np.zeros((len(self.textures), hm, wm, 3), np.float32)
        hw = np.zeros((len(self.textures), 2), np.float32)
        for i, t in enumerate(self.textures):
            atlas[i, :t.shape[0], :t.shape[1]] = t
            hw[i] = t.shape[:2]
        return dict(tex_data=atlas, tex_hw=hw,
                    bsdf_tex=np.asarray(self.bsdf_tex, np.int32))

    @staticmethod
    def _prim_bounds(tri_p0, tri_e1, tri_e2, an_to_world, an_bb):
        """Per-prim AABBs for the BVH, as tpu_rt computes them: triangle
        corners, and for analytic shapes the image of the [-1, 1]^3 box or
        the exact box ``an_bb`` carries (a CURVE prim's end spheres, which
        that cube does not hold), each widened by 1e-6."""
        bbs = []
        if tri_p0.shape[0]:
            p1, p2 = tri_p0 + tri_e1, tri_p0 + tri_e2
            bbs.append((np.minimum(np.minimum(tri_p0, p1), p2) - 1e-6,
                        np.maximum(np.maximum(tri_p0, p1), p2) + 1e-6))
        if an_to_world.shape[0]:
            corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                                for z in (-1, 1)], np.float32)
            pts = (np.einsum("aij,cj->aci", an_to_world[:, :3, :3], corners)
                   + an_to_world[:, None, :3, 3])
            an_lo, an_hi = pts.min(axis=1) - 1e-6, pts.max(axis=1) + 1e-6
            for i, bb in enumerate(an_bb):
                if bb is not None:
                    an_lo[i], an_hi[i] = bb
            bbs.append((an_lo, an_hi))
        if not bbs:
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
        return (np.concatenate([b[0] for b in bbs], axis=0),
                np.concatenate([b[1] for b in bbs], axis=0))

    def _ultrasound(self):
        """The ultrasound configuration as float32 arrays and static
        fields, with tpu_rt's prop names, defaults and float32 rounding."""
        ii, ss, ee = self.us_int, self.us_sensor, self.us_emitter
        angles = np.asarray(ii.get("angles", np.linspace(-30, 30, 25)), np.float32)
        radius = ss.get("radius", float("inf"))
        if isinstance(radius, str):
            radius = float(radius)
        f32 = np.float32
        arrays = dict(
            frequency=f32(ii.get("frequency", 5e6)),
            sound_speed=f32(ii.get("sound_speed", 1540.0)),
            attenuation=f32(ii.get("attenuation", 0.5)),
            main_beam_angle=f32(ii.get("main_beam_angle", 10.0)),
            cutoff_angle=f32(ii.get("cutoff_angle", 20.0)),
            sampling_rate=f32(ii.get("sampling_rate", 50e6)),
            pitch=f32(ii.get("pitch", 0.00035)),
            angles=angles,
            sensor_to_world=tf.as_matrix(ss.get("to_world")),
            elements_width=f32(ss.get("elements_width", ee.get("element_width", 0.003))),
            elements_height=f32(ss.get("elements_height", ee.get("element_height", 0.01))),
            radius=f32(radius),
            directivity=f32(ss.get("directivity", 1.0)),
        )
        static = dict(
            max_depth=int(ii.get("max_depth", 2)),
            wave_cycles=int(ii.get("wave_cycles", 5)),
            n_elements=int(ii.get("n_elements", 128)),
            time_samples=int(ii.get("time_samples", 3000)),
            n_angles=int(angles.shape[0]),
            num_elements_lateral=int(ss.get("num_elements_lateral", 128)),
            number_of_rays_per_element=int(ee.get("number_of_rays_per_element", 1)),
            opening_angle=float(ee.get("opening_angle", 0.0)),
            steering_angle_min=float(ee.get("steering_angle_min", -10.0)),
            steering_angle_max=float(ee.get("steering_angle_max", 10.0)),
        )
        return arrays, static

    def _emitter_arrays(self, tri_e1, tri_e2):
        em_offsets, em_tri_prim, em_tri_cdf, area_total = [0], [], [], []
        for shape_id in self.area_shape:
            lo, hi = self.shape_tri_ranges[shape_id]
            areas = 0.5 * np.linalg.norm(
                np.cross(tri_e1[lo:hi], tri_e2[lo:hi]), axis=-1)
            total = float(areas.sum())
            cdf = np.cumsum(areas) / max(total, 1e-20)
            em_tri_prim.append(np.arange(lo, hi, dtype=np.int32))
            em_tri_cdf.append(cdf.astype(np.float32))
            em_offsets.append(em_offsets[-1] + hi - lo)
            area_total.append(total)
        n_area = len(self.area_radiance)
        if self.env is not None:
            env_map = np.asarray(self.env["map"], np.float32)
            env_to_world = np.asarray(self.env["to_world"], np.float32)
        else:
            env_map = np.zeros((1, 1, 3), np.float32)
            env_to_world = np.eye(4, dtype=np.float32)
        # the lat-long sampling CDFs, as tpu_rt builds them (luminance x sin
        # theta per texel); a constant environment is one texel
        H = env_map.shape[0]
        lum = env_map @ np.array([0.212671, 0.715160, 0.072169], np.float32)
        sin_theta = np.sin((np.arange(H) + 0.5) / H * np.pi).astype(np.float32)
        w = lum * sin_theta[:, None] + 1e-12
        row_w = w.sum(axis=1)
        return dict(
            area_radiance=(np.stack(self.area_radiance) if n_area
                           else np.zeros((0, 3), np.float32)),
            area_total=np.asarray(area_total, np.float32),
            em_offsets=np.asarray(em_offsets, np.int32),
            em_tri_prim=(np.concatenate(em_tri_prim) if em_tri_prim
                         else np.zeros(0, np.int32)),
            em_tri_cdf=(np.concatenate(em_tri_cdf) if em_tri_cdf
                        else np.zeros(0, np.float32)),
            point_pos=(np.stack(self.point_pos) if self.point_pos
                       else np.zeros((0, 3), np.float32)),
            point_intensity=(np.stack(self.point_intensity) if self.point_pos
                             else np.zeros((0, 3), np.float32)),
            env_map=env_map,
            env_to_world=env_to_world,
            env_to_local=tf.inverse(env_to_world),
            env_cdf_rows=(np.cumsum(row_w) / row_w.sum()).astype(np.float32),
            env_cdf_cols=(np.cumsum(w, axis=1) / w.sum(axis=1, keepdims=True)).astype(np.float32),
            env_scale=np.float32(1.0),
        )


def _frame_from_z(z):
    """An orthonormal frame (columns x, y, z) around the unit axis z, as
    tpu_rt/scene/build.py builds the cylinder's."""
    z = np.asarray(z, np.float64)
    a = np.array([0.0, 1.0, 0.0]) if abs(z[1]) < 0.9 else np.array([1.0, 0.0, 0.0])
    x = np.cross(a, z)
    x /= max(np.linalg.norm(x), 1e-12)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1).astype(np.float32)


def build_scene(desc: dict, curve_mode="exact"):
    """The ``Scene`` of a description dict; ``curve_mode`` "exact" makes a
    ``bsplinecurve`` swept-sphere prims, "mesh" an 8-sided tube mesh."""
    if desc.get("type") != "scene":
        raise ValueError("scene description must have type 'scene'")
    b = _Builder(curve_mode)
    for key, val in desc.items():
        if key == "type" or not isinstance(val, dict):
            continue
        vtype = val.get("type")
        if vtype in _INTEGRATORS or vtype in ("stokes", "direct_projective"):
            b.add_integrator(val)
        elif vtype in ("perspective", "ultrasound_sensor"):
            b.add_sensor(val)
        elif vtype in ("obj", "ply", "sphere", "rectangle", "disk", "cylinder",
                       "cone", "bsplinecurve"):
            b.add_shape(val, name=key)
        elif vtype in ("point", "constant", "envmap", "ultraray",
                       "ultrasound_emitter"):
            b.add_emitter(val)
        elif vtype in _BSDF_TYPES:
            b.add_bsdf(val, name=key)
        elif vtype == "ref":
            raise KeyError(f"unresolved ref at scene key {key!r}")
        else:
            raise ValueError(f"unsupported scene entry {key!r} (type={vtype!r})")
    return b.finalize()
