"""Film path-tracing kernels: host side, plain PyTorch versions, wrappers.

Counterpart of ``tpu_rt/ops/pallas_path.py`` for the film megakernel
(``pallas_film_trace`` / ``_build_kernel(film=...)``: K1; its Stokes form
K3; K2, the regeneration loop ``_regen_loop``, around K1), the
per-sample kernels (``pallas_raygen_trace``: K5; ``pallas_path_trace``,
its rays-in form: K4; ``pallas_stokes_trace``: K6) and the render loops
around them (``render_pallas``, ``render_stokes_pallas``).

* ``bake_scene`` extracts the kernel's constants, as the JAX package does.
  Prims: triangles, spheres of a uniform scale, rectangles and cones.
  BSDFs: diffuse, smooth dielectric, smooth conductor, the GGX rough
  conductor (VNDF sampling, NEE with MIS on both sides), and
  the polarizer and ``null`` as delta pass-through (the polarizer's
  intensity fallback: straight on, weight 0.5 x transmittance).
  Environments: constant, or textured (``env_textured``: the kernels
  record each path's escape direction and throughput, and the lat-long
  lookup runs after them).  Scenes outside the scope give ``None``: disks,
  cylinders, curves, bitmap textures.  The header's rough-cone flag marks a
  scene with a rough conductor or a cone: the launch takes the kernels that
  carry those lanes, and every other scene runs kernels without them.  A scene of more than 64 prims takes the
  clustered-mesh mode (``_bake_mesh``): its non-emissive triangles, which
  must share one BSDF, move into cluster tables of at most 64 clusters
  that the kernel sweeps per ray (root box, quarter boxes, Baldwin-Weber
  test, shading normal interpolated from the vertex normals, geometric
  normal for the spawn offsets); emissive triangles and analytic prims stay
  unrolled.
* ``pack_tables`` turns the baked scene into an int32 header and one
  float32 table.  Constants that the JAX kernel derives from Python floats
  (``eta_rel``, ``1/area``, the raygen constants, ...) are derived here in
  float64 and rounded once, so both packages use the same float32 values.
  The tables are built once per render; the scene is not compiled into
  the kernel.
* ``pack_tables(..., stokes=True)`` packs the Stokes kernels' tables
  (the camera's x axis, the header's Stokes flag).  The header's regen
  flag records K1's auto loop form (K2's loop from max_depth 8, as
  ``_use_regen``; 0 on Stokes tables, since K3 has no loop form); a K1
  launch takes it unless the wrapper's ``regen=`` names the other form.
* ``film_trace`` (K1), ``stokes_film_trace`` (K3), ``raygen_trace``
  (K5), ``path_trace`` (K4) and ``stokes_sample_trace`` (K6) are the
  wrappers: on a CPU tensor they run the plain PyTorch versions below, on
  a CUDA tensor they launch the hand-written kernels of
  ``csrc/path_film.cu`` or raise.  K2 needs no
  plain version of its own: it computes K1's function, each lane meeting
  its samples in order.  K6, K5 and K4 take the sample in the grid:
  ``n_samples`` samples in one launch, sample i seeded seed + i.
* On the card K1 (either loop form) and K3 run as two kernels: a trace
  kernel writes one record per finished sample, its values and ray count
  laid out [value][sample][pixel], and ``film_splat`` adds the records
  onto the planes in sample order; ``split_film`` streams a launch in
  chunks of at most ``RECORD_CHUNK`` samples.  K1's trace kernel is
  ``film_records``; K3's is a ``stokes_sample_trace`` launch, whose first
  13 planes are K3's records.  Their plain version,
  ``film_records_plain``, and ``film_splat_plain`` give
  ``film_trace_plain``'s planes bit for bit.
* The plain version keeps the JAX kernel's math in its order, over flat
  ``(N,)`` tensors, one per component, with ``torch.where`` masks.  Its
  SplitMix32 RNG emulates uint32 arithmetic in int64 (CPU torch has no
  uint32 shifts), so it reproduces the JAX package's random streams bit
  for bit.
* ``render_film`` and ``render_stokes_film`` loop over
  ``spp_per_pass``-sample chunks (``film_chunks``), deposit each chunk's
  filter planes into the film and develop the image (H, W, 3) or the
  Stokes image (H, W, 4, 3).  ``sample_film`` is the per-sample routes'
  film: a per-sample kernel launched once a chunk, the samples splatted in
  order.  ``render_sample_film``, the route of a textured environment,
  runs it on K5, adding the environment seen at each path's escape, and
  develops.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from tpu_rt_torch.ops import mesh_kernel as _mk
from tpu_rt_torch.scene.types import (
    BSDF_CONDUCTOR,
    BSDF_DIELECTRIC,
    BSDF_DIFFUSE,
    BSDF_NULL,
    BSDF_POLARIZER,
    BSDF_ROUGH_CONDUCTOR,
    CONE,
    FILTER_GAUSSIAN,
    FILTER_TENT,
    RECTANGLE,
    SPHERE,
    Camera,
    Scene,
)
from tpu_rt_torch.sensor import film as _film
from tpu_rt_torch.utils.profiling import span

_MAX_PRIMS = 64
_MAX_LIGHT_TRIS = 8
_MAX_DEPTH = 16
_BIG = 1e8
_GAUSS_TAIL = float(np.float32(np.exp(-8.0)))  # Mitsuba gaussian's offset at radius 2
_SUPPORTED_BSDFS = {BSDF_DIFFUSE, BSDF_DIELECTRIC, BSDF_CONDUCTOR, BSDF_ROUGH_CONDUCTOR,
                    BSDF_POLARIZER, BSDF_NULL}
# In-kernel film footprint radius per filter: box keeps the sample in its
# own pixel, tent touches 3x3, Mitsuba's gaussian (stddev 0.5, radius 2)
# touches 5x5.
_FILTER_FOOT = {"box": 0, "tent": 1, "gaussian": 2}
# The most samples a film launch on the card traces into one record buffer
# before film_splat adds them: (n_val, 64, H*W) floats, 218 MB for K3 at 256^2.
RECORD_CHUNK = 64
# The most samples a per-sample route splats at once: ``splat_in_order``
# holds a piece's filter terms whole.
SPLAT_CHUNK = 64


# ---------------------------------------------------------------------------
# Scene baking
# ---------------------------------------------------------------------------

@dataclass
class BakedPrim:
    kind: str  # 'tri' | 'sphere' | 'rect' | 'cone'
    # tri: (p0, e1, e2, ng); sphere: (center, radius); rect: rows of
    # to_object + world normal; cone: rows of to_object (the world normal
    # is computed per hit from the object normal through M_obj^T)
    data: tuple
    bsdf: int
    emitter: int  # area-emitter index or -1


@dataclass
class BakedScene:
    prims: List[BakedPrim]
    bsdfs: List[Tuple[int, tuple]]  # (type, params16)
    em_radiance: List[tuple]  # per emitter rgb
    em_area: List[float]
    em_tris: List[List[Tuple[int, float]]]  # per emitter: [(prim, cdf)]
    point_lights: List[Tuple[tuple, tuple]]  # (pos, intensity)
    env_rgb: Optional[tuple] = None  # constant environment radiance
    # a textured environment: the kernels record each path's escape, and
    # the lat-long lookup runs after them (render_sample_film)
    env_textured: bool = False
    n_lights: int = 0
    max_depth: int = 6
    rr_depth: int = 5
    hide_emitters: bool = False
    # clustered-mesh tables (_bake_mesh) or None
    mesh: Optional[dict] = None


_MESH_MAX_C = 64  # the mesh mode's scope: at most 64 clusters


def _bake_mesh(scene: Scene) -> Optional[dict]:
    """Cluster tables of the scene's non-emissive triangles, which must all
    share one BSDF (tpu_rt/ops/pallas_path.py::_bake_mesh): clusters are
    rebuilt over that subset in the order of the scene's BVH clusters
    (runs of 128 along ``cl_prim``).  Returns dict(bounds (C, 32), trisw
    (C, 12, 128), nrm (C, 9, 128) vertex normals, bsdf, tri_mask) or
    None."""
    g = scene.geometry
    if g.n_tris == 0 or g.cl_prim is None:
        return None
    tri_shape = g.tri_shape.numpy()
    mask = scene.shape_emitter.numpy()[tri_shape] < 0
    if not mask.any():
        return None
    b_ids = set(scene.shape_bsdf.numpy()[tri_shape[mask]].tolist())
    if len(b_ids) != 1 or int(mask.sum()) > _MESH_MAX_C * _mk.CLUSTER:
        return None
    order, seen = [], np.zeros(g.n_tris, bool)
    for t in g.cl_prim.numpy().tolist():
        if 0 <= t < g.n_tris and mask[t] and not seen[t]:
            seen[t] = True
            order.append(t)
    order = np.asarray(order, np.int32)
    cl = _mk.build_clusters(g.tri_p0.numpy()[order], g.tri_e1.numpy()[order],
                            g.tri_e2.numpy()[order])
    if cl["tris"].shape[0] > _MESH_MAX_C:
        return None
    nrm = _mk.build_shading_table(
        cl["prim"], g.tri_n0.numpy()[order], g.tri_n1.numpy()[order],
        g.tri_n2.numpy()[order], np.zeros((order.shape[0], 3), np.float32))[:, :9]
    return dict(bounds=cl["bounds"], trisw=cl["trisw"], nrm=np.ascontiguousarray(nrm),
                bsdf=int(b_ids.pop()), tri_mask=mask)


def bake_prims(scene: Scene, with_emitters=True, skip=None) -> Optional[List[BakedPrim]]:
    """The scene's triangles, spheres, rectangles and cones as kernel
    prims, in prim-id order, leaving out the triangles where ``skip`` is
    set; None when a prim is outside the sweep's scope (another analytic
    type, or a sphere without a uniform scale).  With
    ``with_emitters=False`` every prim's emitter is -1."""
    g = scene.geometry
    an_type = g.an_type.numpy()
    if not set(an_type.tolist()) <= {SPHERE, RECTANGLE, CONE}:
        return None
    shape_bsdf = scene.shape_bsdf.numpy()
    shape_emitter = scene.shape_emitter.numpy()

    def emitter(sid):
        return int(shape_emitter[sid]) if with_emitters else -1

    tri_p0 = g.tri_p0.numpy()
    tri_e1 = g.tri_e1.numpy()
    tri_e2 = g.tri_e2.numpy()
    tri_shape = g.tri_shape.numpy()
    prims = []
    for i in range(g.n_tris):
        if skip is not None and skip[i]:
            continue
        ng = np.cross(tri_e1[i], tri_e2[i])
        ng = ng / max(np.linalg.norm(ng), 1e-20)
        sid = int(tri_shape[i])
        prims.append(BakedPrim(
            "tri", (tuple(tri_p0[i]), tuple(tri_e1[i]), tuple(tri_e2[i]), tuple(ng)),
            int(shape_bsdf[sid]), emitter(sid)))
    an_to_world = g.an_to_world.numpy()
    an_to_object = g.an_to_object.numpy()
    an_shape = g.an_shape.numpy()
    for i in range(g.n_analytic):
        sid = int(an_shape[i])
        if int(an_type[i]) == SPHERE:
            m = an_to_world[i]
            sx = np.linalg.norm(m[:3, 0])
            sy = np.linalg.norm(m[:3, 1])
            sz = np.linalg.norm(m[:3, 2])
            if abs(sx - sy) > 1e-5 * sx or abs(sx - sz) > 1e-5 * sx:
                return None  # the sphere path needs a uniform scale
            prims.append(BakedPrim("sphere", (tuple(m[:3, 3].tolist()), float(sx)),
                                   int(shape_bsdf[sid]), emitter(sid)))
        elif int(an_type[i]) == CONE:  # object transform rows
            mo = an_to_object[i]
            prims.append(BakedPrim(
                "cone", (tuple(mo[0].tolist()), tuple(mo[1].tolist()), tuple(mo[2].tolist())),
                int(shape_bsdf[sid]), emitter(sid)))
        else:  # rectangle: object transform rows + world normal
            mo = an_to_object[i]
            nw = np.linalg.inv(an_to_world[i][:3, :3]).T @ np.array([0.0, 0.0, 1.0])
            nw = nw / max(np.linalg.norm(nw), 1e-20)
            prims.append(BakedPrim(
                "rect", (tuple(mo[0].tolist()), tuple(mo[1].tolist()),
                         tuple(mo[2].tolist()), tuple(nw.tolist())),
                int(shape_bsdf[sid]), emitter(sid)))
    return prims


def bake_scene(scene: Scene) -> Optional[BakedScene]:
    """The kernel's constants, or None when the scene is out of scope."""
    with span("tpu_rt_torch.bake_scene"):
        g = scene.geometry
        if g.n_tris + g.n_analytic == 0 or scene.has_textures:
            return None
        mesh = None
        if g.n_tris + g.n_analytic > _MAX_PRIMS:
            mesh = _bake_mesh(scene)
            if mesh is None:
                return None
        env_rgb = None
        em = scene.emitters
        env_textured = False
        if em.has_env:
            env_map = em.env_map.numpy()
            if env_map.shape[:2] == (1, 1):
                env_rgb = tuple((env_map[0, 0] * float(em.env_scale)).tolist())
            else:
                env_textured = True
        btypes = scene.bsdf_type.numpy()
        if not set(btypes.tolist()) <= _SUPPORTED_BSDFS:
            return None
        skip = None if mesh is None else mesh["tri_mask"]
        prims = bake_prims(scene, skip=skip)
        if prims is None or len(prims) > _MAX_PRIMS:
            return None
        # emissive triangles keep their place among the unrolled prims
        tri_remap = np.arange(g.n_tris)
        if skip is not None:
            tri_remap = np.cumsum(~skip) - 1

        bsdf_params = scene.bsdf_params.numpy()
        bsdfs = [(int(t), tuple(bsdf_params[i].tolist())) for i, t in enumerate(btypes)]

        offsets = em.em_offsets.numpy()
        em_tri_prim = em.em_tri_prim.numpy()
        em_tri_cdf = em.em_tri_cdf.numpy()
        em_tris = []
        for e in range(em.n_area):
            lo, hi = int(offsets[e]), int(offsets[e + 1])
            if hi - lo > _MAX_LIGHT_TRIS:
                return None
            em_tris.append([(int(tri_remap[int(em_tri_prim[k])]), float(em_tri_cdf[k]))
                            for k in range(lo, hi)])
        point_lights = [(tuple(p), tuple(i)) for p, i in zip(
            em.point_pos.numpy().tolist(), em.point_intensity.numpy().tolist())]
        max_depth = scene.max_depth if scene.max_depth and scene.max_depth > 0 else _MAX_DEPTH
        return BakedScene(
            prims=prims,
            bsdfs=bsdfs,
            em_radiance=[tuple(r) for r in em.area_radiance.numpy().tolist()],
            em_area=em.area_total.numpy().tolist(),
            em_tris=em_tris,
            point_lights=point_lights,
            env_rgb=env_rgb,
            env_textured=env_textured,
            # the environment stays out of the NEE light set: the kernels
            # sample it by the BSDF only
            n_lights=em.n_area + len(point_lights),
            max_depth=min(max_depth, _MAX_DEPTH),
            rr_depth=scene.rr_depth,
            hide_emitters=scene.hide_emitters,
            mesh=mesh,
        )


def _make_raygen(camera: Camera, n_pix):
    """Camera constants of the kernel, with the Mitsuba near/far clip
    planes: primary rays start at the near plane and depth-0 hits beyond
    the far plane are discarded."""
    m = camera.to_world.numpy()
    return dict(
        R=tuple(tuple(float(x) for x in m[i, :3]) for i in range(3)),
        origin=tuple(float(x) for x in m[:3, 3]),
        tfx=float(camera.tan_fov_x),
        tfy=float(camera.tan_fov_y),
        W=camera.width, H=camera.height, n_pix=n_pix,
        near=float(camera.near), far=float(camera.far),
    )


def _filter_name(filter_type):
    if filter_type == FILTER_TENT:
        return "tent"
    if filter_type == FILTER_GAUSSIAN:
        return "gaussian"
    return "box"


# ---------------------------------------------------------------------------
# Table packing (layout shared with csrc/path_film.cu)
# ---------------------------------------------------------------------------

# int32 header
HDR_N_PRIMS, HDR_N_AREA, HDR_N_LIGHTS, HDR_MAX_DEPTH, HDR_RR_DEPTH = 0, 1, 2, 3, 4
HDR_HIDE_EMITTERS, HDR_HAS_ENV, HDR_HAS_FAR, HDR_W, HDR_H = 5, 6, 7, 8, 9
HDR_TILE_LANES, HDR_OFF_PRIM, HDR_OFF_BSDF, HDR_OFF_EM, HDR_OFF_PT = 10, 11, 12, 13, 14
HDR_MESH_C = 15  # clusters of the mesh tables; 0 without a mesh
# Stokes tables (K3 / K6: 12 Stokes values a sample); K1's auto loop form,
# 1 for K2's regeneration loop (0 on Stokes tables: K3 has none).  Host-side words: the
# kernel takes its mode and loop form as launch arguments and reads neither.
HDR_STOKES, HDR_REGEN = 16, 17
HDR_ENV_TEXTURED = 18  # 1: a textured environment, K4 / K5 write escape records
# 1: the scene has a rough conductor (tpu_rt's static ``has_rough``) or a
# cone; the launch takes the kernels that carry the rough lane and the
# sweep's cone test.  Host-side, as HDR_STOKES.
HDR_ROUGH_CONE = 19
HDR_LEN = 20

# float32 table: a global block, then prim, bsdf, emitter, point records
G_ENV, G_INV_NL, G_NL, G_NL_M1 = 0, 3, 5, 6
G_R, G_ORG, G_TFX, G_TFY, G_INVW, G_INVH = 8, 17, 20, 21, 22, 23
G_NEAR, G_FAR_NEAR, G_GAUSS_TAIL, G_MESH_BSDF = 24, 25, 26, 27
G_CAM_X = 28  # the camera's x axis (Stokes tables only)
G_LEN = 32
# tpu_rt's _REGEN_AUTO_DEPTH: from this max_depth on, K1 runs in K2's
# loop (a lane restarts on its next sample as soon as its path ends); so
# do tpu_rt's K1 and K3
REGEN_AUTO_DEPTH = 8
PRIM_STRIDE, BSDF_STRIDE, EM_STRIDE, PT_STRIDE = 20, 16, 32, 8
KIND_TRI, KIND_SPHERE, KIND_RECT, KIND_CONE = 0, 1, 2, 3
B_ALPHA = 15  # a rough conductor's GGX alpha in its BSDF record
# The kernel stages the table in shared memory: 48 KB without opt-in.
_MAX_TABLE_FLOATS = 12 * 1024


@dataclass
class FilmTables:
    """A baked scene and camera packed for the film kernel, on one device."""

    hdr: torch.Tensor  # int32 [HDR_LEN]
    tab: torch.Tensor  # float32 [n]
    hdr_list: list  # host copies, read by the plain version
    tab_list: list
    H: int
    W: int
    radius: int  # filter footprint radius: 0 box, 1 tent, 2 gaussian
    # mesh tables, float32 [C*32 bounds | C*12*128 Baldwin-Weber rows |
    # C*9*128 vertex normals], or None; the kernel reads them from global
    # memory
    mesh: Optional[torch.Tensor] = None

    def mesh_views(self):
        """The mesh tables as (bounds (C, 32), trisw (C, 12, 128), nrm
        (C, 9, 128)) views of ``mesh``."""
        C = self.hdr_list[HDR_MESH_C]
        nb, nt = C * 32, C * 12 * _mk.CLUSTER
        return (self.mesh[:nb].view(C, 32), self.mesh[nb:nb + nt].view(C, 12, _mk.CLUSTER),
                self.mesh[nb + nt:].view(C, 9, _mk.CLUSTER))

    @property
    def n_pix(self):
        return self.H * self.W

    @property
    def stokes(self):
        return bool(self.hdr_list[HDR_STOKES])

    @property
    def regen(self):
        return bool(self.hdr_list[HDR_REGEN])

    @property
    def env_textured(self):
        return bool(self.hdr_list[HDR_ENV_TEXTURED])

    @property
    def rough_cone(self):
        return bool(self.hdr_list[HDR_ROUGH_CONE])

    @property
    def n_val(self):
        """Planes per filter offset: the sample's values (r, g, b, or the
        12 Stokes values I, Q, U, V x r, g, b) and the filter weight."""
        return 13 if self.stokes else 4

    @property
    def n_acc(self):
        return (2 * self.radius + 1) ** 2 * self.n_val


def _f32(x):
    return float(np.float32(x))


def pack_prims(prims: List[BakedPrim]) -> list:
    """Prim records of PRIM_STRIDE floats: kind, bsdf, emitter, pad, then
    tri (p0, e1, e2, ng), sphere (center, r*r, 1/r), rectangle (rows of
    to_object, world normal) or cone (rows of to_object).  Constants the
    JAX kernel derives from Python floats (r*r, 1/r) are derived in
    float64 and rounded once."""
    tab = []
    for p in prims:
        rec = [0.0] * PRIM_STRIDE
        rec[1], rec[2] = float(p.bsdf), float(p.emitter)
        if p.kind == "tri":
            rec[0] = KIND_TRI
            rec[4:16] = [_f32(x) for v in p.data for x in v]
        elif p.kind == "sphere":
            (c, r) = p.data
            rec[0] = KIND_SPHERE
            rec[4:9] = [_f32(c[0]), _f32(c[1]), _f32(c[2]), _f32(r * r), _f32(1.0 / r)]
        elif p.kind == "cone":
            rec[0] = KIND_CONE
            rec[4:16] = [_f32(x) for v in p.data for x in v]
        else:
            rec[0] = KIND_RECT
            rec[4:19] = [_f32(x) for v in p.data for x in v]
        tab += rec
    return tab


def use_regen(bs: BakedScene) -> bool:
    """tpu_rt's ``_use_regen`` in its auto mode: K2's loop from
    max_depth 8 on."""
    return bs.max_depth >= REGEN_AUTO_DEPTH


def pack_tables(bs: BakedScene, camera: Camera, tile_rows: int, device,
                stokes=False) -> FilmTables:
    """Pack a baked scene and its camera for the film kernel on ``device``.
    ``tile_rows`` keys the RNG: tile = pixel // (tile_rows * 128).
    ``stokes`` packs the tables of the Stokes kernel (K3, K6), with the
    camera's x axis.  The header's regen flag is ``use_regen``, 0 on Stokes
    tables."""
    with span("tpu_rt_torch.pack_tables"):
        H, W = camera.height, camera.width
        n_pix = H * W
        if n_pix > 1 << 24:
            raise ValueError("in-kernel raygen needs H*W <= 2^24")
        if tile_rows < 1:
            raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
        rg = _make_raygen(camera, n_pix)
        n_lights = bs.n_lights
        g = [0.0] * G_LEN
        if bs.env_rgb is not None:
            g[G_ENV:G_ENV + 3] = [_f32(x) for x in bs.env_rgb]
        g[G_INV_NL] = _f32(1.0 / max(n_lights, 1))
        g[G_NL] = _f32(n_lights)
        g[G_NL_M1] = _f32(n_lights - 1)
        g[G_R:G_R + 9] = [_f32(x) for row in rg["R"] for x in row]
        g[G_ORG:G_ORG + 3] = [_f32(x) for x in rg["origin"]]
        g[G_TFX], g[G_TFY] = _f32(rg["tfx"]), _f32(rg["tfy"])
        g[G_INVW], g[G_INVH] = _f32(1.0 / W), _f32(1.0 / H)
        g[G_NEAR], g[G_FAR_NEAR] = _f32(rg["near"]), _f32(rg["far"] - rg["near"])
        g[G_GAUSS_TAIL] = _GAUSS_TAIL
        if stokes:
            g[G_CAM_X:G_CAM_X + 3] = [_f32(x) for x in camera.to_world.numpy()[:3, 0]]
        mesh = None
        if bs.mesh is not None:
            g[G_MESH_BSDF] = float(bs.mesh["bsdf"])
            mesh = torch.from_numpy(np.concatenate(
                [bs.mesh[k].reshape(-1) for k in ("bounds", "trisw", "nrm")])).to(device)

        prim_tab = pack_prims(bs.prims)
        bsdf_tab = []
        for bt, prm in bs.bsdfs:
            rec = [0.0] * BSDF_STRIDE
            rec[0] = float(bt)
            rec[4] = 1.0  # eta_rel
            rec[8:11] = [1.0, 1.0, 1.0]  # conductor k
            rec[12:15] = [1.0, 1.0, 1.0]  # conductor specular_reflectance
            if bt == BSDF_DIFFUSE:
                rec[1:4] = [_f32(x) for x in prm[0:3]]
            elif bt == BSDF_DIELECTRIC:
                rec[4] = _f32(prm[0] / max(prm[1], 1e-6))
            elif bt == BSDF_NULL:
                rec[1:4] = [1.0, 1.0, 1.0]  # pass-through tint
            elif bt == BSDF_POLARIZER:
                # the intensity fallback's tint: half the transmittance
                rec[1:4] = [_f32(x * 0.5) for x in prm[3:6]]
            else:  # conductor, smooth or rough
                if prm[0] < 0.0:  # perfect mirror marker
                    rec[11] = 1.0
                else:
                    rec[5:8] = [_f32(x) for x in prm[0:3]]
                    rec[8:11] = [_f32(x) for x in prm[3:6]]
                rec[12:15] = [_f32(x) for x in prm[6:9]]
                if bt == BSDF_ROUGH_CONDUCTOR:
                    rec[B_ALPHA] = _f32(max(prm[9], 1e-3))
            bsdf_tab += rec

        em_tab = []
        for e, rad in enumerate(bs.em_radiance):
            rec = [0.0] * EM_STRIDE
            rec[0:3] = [_f32(x) for x in rad]
            rec[3] = _f32(1.0 / bs.em_area[e])
            rec[4] = float(len(bs.em_tris[e]))
            prev_cdf = 0.0
            for j, (tp, cdf_hi) in enumerate(bs.em_tris[e]):
                rec[5 + 3 * j:8 + 3 * j] = [float(tp), _f32(prev_cdf), _f32(cdf_hi + 1e-9)]
                prev_cdf = cdf_hi
            em_tab += rec

        pt_tab = []
        for pos, inten in bs.point_lights:
            pt_tab += [_f32(x) for x in pos] + [_f32(x) for x in inten] + [0.0, 0.0]

        off_prim = G_LEN
        off_bsdf = off_prim + len(prim_tab)
        off_em = off_bsdf + len(bsdf_tab)
        off_pt = off_em + len(em_tab)
        tab = g + prim_tab + bsdf_tab + em_tab + pt_tab
        if len(tab) > _MAX_TABLE_FLOATS:
            raise ValueError(f"scene tables of {len(tab)} floats exceed the "
                             f"kernel's shared-memory budget ({_MAX_TABLE_FLOATS})")
        hdr = [0] * HDR_LEN
        hdr[HDR_N_PRIMS] = len(bs.prims)
        hdr[HDR_N_AREA] = len(bs.em_radiance)
        hdr[HDR_N_LIGHTS] = n_lights
        hdr[HDR_MAX_DEPTH] = bs.max_depth
        hdr[HDR_RR_DEPTH] = bs.rr_depth
        hdr[HDR_HIDE_EMITTERS] = int(bs.hide_emitters)
        hdr[HDR_HAS_ENV] = int(bs.env_rgb is not None)
        hdr[HDR_HAS_FAR] = int(rg["far"] < 1e8)
        hdr[HDR_W], hdr[HDR_H] = W, H
        hdr[HDR_TILE_LANES] = tile_rows * 128
        hdr[HDR_OFF_PRIM], hdr[HDR_OFF_BSDF] = off_prim, off_bsdf
        hdr[HDR_OFF_EM], hdr[HDR_OFF_PT] = off_em, off_pt
        hdr[HDR_MESH_C] = 0 if bs.mesh is None else bs.mesh["bounds"].shape[0]
        hdr[HDR_STOKES] = int(bool(stokes))
        hdr[HDR_REGEN] = int(use_regen(bs) and not stokes)
        hdr[HDR_ENV_TEXTURED] = int(bs.env_textured)
        hdr[HDR_ROUGH_CONE] = int(any(bt == BSDF_ROUGH_CONDUCTOR for bt, _ in bs.bsdfs)
                                  or any(p.kind == "cone" for p in bs.prims))
        return FilmTables(
            hdr=torch.tensor(hdr, dtype=torch.int32, device=device),
            tab=torch.tensor(tab, dtype=torch.float32, device=device),
            hdr_list=hdr, tab_list=tab, H=H, W=W,
            radius=_FILTER_FOOT[_filter_name(camera.filter_type)],
            mesh=mesh,
        )


# ---------------------------------------------------------------------------
# Plain PyTorch version of the kernel: flat (N,) tensors, one per component
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_INV_PI = 1.0 / math.pi


class _Consts:
    """The packed tables read back as Python floats (exact float32 values),
    so the plain version uses the kernel's constants."""

    def __init__(self, tables: FilmTables):
        h, t = tables.hdr_list, tables.tab_list
        self.n_area = h[HDR_N_AREA]
        self.n_lights = h[HDR_N_LIGHTS]
        self.max_depth = h[HDR_MAX_DEPTH]
        self.rr_depth = h[HDR_RR_DEPTH]
        self.hide_emitters = bool(h[HDR_HIDE_EMITTERS])
        self.has_env = bool(h[HDR_HAS_ENV])
        self.env_textured = bool(h[HDR_ENV_TEXTURED])
        self.has_far = bool(h[HDR_HAS_FAR])
        self.W, self.H = h[HDR_W], h[HDR_H]
        self.tile_lanes = h[HDR_TILE_LANES]
        self.g = t[:G_LEN]
        self.R = [t[G_R + 3 * i:G_R + 3 * i + 3] for i in range(3)]
        self.stokes = bool(h[HDR_STOKES])
        self.cam_x = t[G_CAM_X:G_CAM_X + 3]
        self.tab_device = tables.tab.device

        def recs(lo, hi, stride):
            return [t[o:o + stride] for o in range(lo, hi, stride)]

        self.prims = recs(h[HDR_OFF_PRIM], h[HDR_OFF_BSDF], PRIM_STRIDE)
        self.bsdfs = recs(h[HDR_OFF_BSDF], h[HDR_OFF_EM], BSDF_STRIDE)
        # tpu_rt's static has_rough: the rough lane's code runs only then
        self.has_rough = any(int(rec[0]) == BSDF_ROUGH_CONDUCTOR for rec in self.bsdfs)
        self.ems = recs(h[HDR_OFF_EM], h[HDR_OFF_PT], EM_STRIDE)
        self.points = recs(h[HDR_OFF_PT], len(t), PT_STRIDE)
        self.mesh_c = h[HDR_MESH_C]
        if self.mesh_c:
            self.mesh_id = float(h[HDR_N_PRIMS])  # the prim id of a mesh hit
            self.mesh_bsdf = t[G_MESH_BSDF]
            self.mesh_bounds, self.mesh_trisw, self.mesh_nrm = tables.mesh_views()
            self.mesh_bounds_list = self.mesh_bounds.cpu().tolist()


def _mul32(x, c):
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64, without int64
    overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _rng_init(seed, tile, lane):
    """Per-lane SplitMix32 state from (seed, tile, lane): a Python int seed
    (negative int32 seeds wrap as the JAX cast to uint32 does) and int64
    tile / lane tensors.  uint32 values are held in int64."""
    s = (_mul32(seed & _M32, 0x9E3779B9) + _mul32(tile, 0x85EBCA6B)
         + _mul32(lane, 0xC2B2AE35) + 0x165667B1) & _M32
    s = _mul32(s ^ (s >> 16), 0x7FEB352D)
    s = _mul32(s ^ (s >> 15), 0x846CA68B)
    s = s ^ (s >> 16)
    return s | 1  # avoid the all-zero fixed point


def _rng_next(state):
    """SplitMix32 draw: Weyl increment + murmur3 finalizer.
    Returns (new_state, U[0,1) float32)."""
    state = (state + 0x9E3779B9) & _M32
    z = _mul32(state ^ (state >> 16), 0x21F0AAAD)
    z = _mul32(z ^ (z >> 15), 0x735A2D97)
    z = z ^ (z >> 15)
    bits = (z >> 9) | 0x3F800000
    return state, bits.to(torch.int32).view(torch.float32) - 1.0


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _where3(m, a, b):
    return tuple(torch.where(m, a[i], b[i]) for i in range(3))


def _normalize(a):
    inv = 1.0 / torch.sqrt(torch.clamp(_dot(a, a), min=1e-24))
    return _scale(a, inv)


def _safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=1e-20))


def _rdiv(c, x):
    """c / x for a Python float c (``c / tensor`` in torch is
    ``reciprocal(x) * c``, which rounds twice)."""
    return torch.full_like(x, c) / x


def _clamp_abs(x, eps):
    """Keep |x| >= eps, preserving the sign (the kernel's det/dz guards)."""
    return torch.where(torch.abs(x) < eps,
                       torch.where(x < 0, -eps, eps), x)


def _mis(pdf_a, pdf_b):
    a2 = pdf_a * pdf_a
    w = a2 / torch.clamp(a2 + pdf_b * pdf_b, min=1e-20)
    return torch.where(pdf_a > 0.0, w, 0.0)


def _frame(n):
    """Duff et al. branchless ONB; returns (s, t) for unit n."""
    sign = torch.where(n[2] >= 0.0, 1.0, -1.0)
    a = -(1.0 / (sign + n[2]))
    b = n[0] * n[1] * a
    s = (1.0 + sign * n[0] * n[0] * a, sign * b, -sign * n[0])
    t = (b, sign + n[1] * n[1] * a, -n[1])
    return s, t


def _to_local(n, s, t, v):
    return (_dot(v, s), _dot(v, t), _dot(v, n))


def _to_world(n, s, t, v):
    return (s[0] * v[0] + t[0] * v[1] + n[0] * v[2],
            s[1] * v[0] + t[1] * v[1] + n[1] * v[2],
            s[2] * v[0] + t[2] * v[1] + n[2] * v[2])


def _cone_hit(q, o, d, tmin, tmax):
    """The unit cone x^2 + y^2 = (1 - z)^2, z in [0, 1] in object space
    (rows m0, m1, m2 of to_object in q[0:12]; pallas_path.py:524-560):
    (t, hit, world normal).  The nearer root where it lies in (tmin, tmax)
    and on the cone's height, else the farther; the quadratic's leading
    coefficient kept >= 1e-12 in magnitude (rays along the cone's side);
    the normal M_obj^T (x, y, 1 - z) normalised."""
    m0, m1, m2 = q[0:4], q[4:8], q[8:12]
    oxp = m0[0] * o[0] + m0[1] * o[1] + m0[2] * o[2] + m0[3]
    oyp = m1[0] * o[0] + m1[1] * o[1] + m1[2] * o[2] + m1[3]
    ozp = m2[0] * o[0] + m2[1] * o[1] + m2[2] * o[2] + m2[3]
    dxp = m0[0] * d[0] + m0[1] * d[1] + m0[2] * d[2]
    dyp = m1[0] * d[0] + m1[1] * d[1] + m1[2] * d[2]
    dzp = m2[0] * d[0] + m2[1] * d[1] + m2[2] * d[2]
    kk = 1.0 - ozp
    a_ = dxp * dxp + dyp * dyp - dzp * dzp
    b_ = 2.0 * (oxp * dxp + oyp * dyp + kk * dzp)
    c_ = oxp * oxp + oyp * oyp - kk * kk
    disc = b_ * b_ - 4.0 * a_ * c_
    sq = _safe_sqrt(disc)
    a2 = 2.0 * _clamp_abs(a_, 1e-12)
    r0 = (-b_ - sq) / a2
    r1 = (-b_ + sq) / a2
    tn_ = torch.minimum(r0, r1)
    tf_ = torch.maximum(r0, r1)
    z_n = ozp + tn_ * dzp
    z_f = ozp + tf_ * dzp
    v_n = (disc >= 0.0) & (tn_ > tmin) & (tn_ < tmax) & (z_n >= 0.0) & (z_n <= 1.0)
    v_f = (disc >= 0.0) & (tf_ > tmin) & (tf_ < tmax) & (z_f >= 0.0) & (z_f <= 1.0)
    t = torch.where(v_n, tn_, tf_)
    xh = oxp + t * dxp
    yh = oyp + t * dyp
    zh = 1.0 - (ozp + t * dzp)
    pn = _normalize((m0[0] * xh + m1[0] * yh + m2[0] * zh,
                     m0[1] * xh + m1[1] * yh + m2[1] * zh,
                     m0[2] * xh + m1[2] * yh + m2[2] * zh))
    return t, v_n | v_f, pn


def _sweep(C: _Consts, o, d, tmin, tmax, any_hit=False):
    """Closest hit over every prim: (t, prim index as float or -1, normal).
    With any_hit=True only the hit mask."""
    zeros = torch.zeros_like(o[0])
    best_t = torch.full_like(o[0], _BIG)
    best_prim = zeros - 1.0
    n = (zeros, zeros, zeros)
    for pi, rec in enumerate(C.prims):
        kind, q = int(rec[0]), rec[4:]
        if kind == KIND_TRI:
            p0, e1, e2, ng = q[0:3], q[3:6], q[6:9], q[9:12]
            pv = _cross(d, e2)
            det = e1[0] * pv[0] + e1[1] * pv[1] + e1[2] * pv[2]
            inv = 1.0 / _clamp_abs(det, 1e-9)
            tv = (o[0] - p0[0], o[1] - p0[1], o[2] - p0[2])
            u = (tv[0] * pv[0] + tv[1] * pv[1] + tv[2] * pv[2]) * inv
            qv = _cross(tv, e1)
            v = _dot(d, qv) * inv
            t = (e2[0] * qv[0] + e2[1] * qv[1] + e2[2] * qv[2]) * inv
            ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin) & (t < tmax)
            pn = (ng[0] + zeros, ng[1] + zeros, ng[2] + zeros)
        elif kind == KIND_SPHERE:
            cx, cy, cz, r2, inv_r = q[0:5]
            oc = (o[0] - cx, o[1] - cy, o[2] - cz)
            b2 = _dot(oc, d)
            cc = _dot(oc, oc) - r2
            disc = b2 * b2 - cc * _dot(d, d)
            sq = _safe_sqrt(disc)
            a_ = _dot(d, d)
            t0 = (-b2 - sq) / a_
            t1 = (-b2 + sq) / a_
            t = torch.where((t0 > tmin) & (t0 < tmax), t0, t1)
            ok = (disc >= 0.0) & (t > tmin) & (t < tmax)
            pn = ((o[0] + t * d[0] - cx) * inv_r,
                  (o[1] + t * d[1] - cy) * inv_r,
                  (o[2] + t * d[2] - cz) * inv_r)
        elif kind == KIND_CONE:
            t, ok, pn = _cone_hit(q, o, d, tmin, tmax)
        else:  # rectangle: rows m0, m1, m2 of to_object; world normal nw
            m0, m1, m2, nw = q[0:4], q[4:8], q[8:12], q[12:15]
            ozp = m2[0] * o[0] + m2[1] * o[1] + m2[2] * o[2] + m2[3]
            dzp = m2[0] * d[0] + m2[1] * d[1] + m2[2] * d[2]
            t = -ozp / _clamp_abs(dzp, 1e-9)
            oxp = m0[0] * o[0] + m0[1] * o[1] + m0[2] * o[2] + m0[3]
            dxp = m0[0] * d[0] + m0[1] * d[1] + m0[2] * d[2]
            oyp = m1[0] * o[0] + m1[1] * o[1] + m1[2] * o[2] + m1[3]
            dyp = m1[0] * d[0] + m1[1] * d[1] + m1[2] * d[2]
            xh = oxp + t * dxp
            yh = oyp + t * dyp
            ok = ((torch.abs(dzp) > 1e-12) & (t > tmin) & (t < tmax)
                  & (torch.abs(xh) <= 1.0) & (torch.abs(yh) <= 1.0))
            pn = (nw[0] + zeros, nw[1] + zeros, nw[2] + zeros)
        closer = ok & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_prim = torch.where(closer, float(pi), best_prim)
        n = _where3(closer, pn, n)
    if any_hit:
        return best_prim >= 0.0
    return best_t, best_prim, n


def _mesh_closest(C: _Consts, o, d, t0, prim0, n0, active):
    """Merge the mesh's closest hit into the unrolled sweep's (t0, prim0,
    n0) on the active lanes (pallas_path._mesh_closest).  Returns (t,
    prim_f, n, n_g): on mesh hits prim_f is the mesh's prim id, n the
    normalised interpolated vertex normal (the geometric one where that is
    ~0) and n_g the normalised geometric normal; elsewhere n = n_g = n0."""
    invd = [_mk._inv(x) for x in d]
    best_t, prim = t0.clone(), prim0.clone()
    att = torch.cat([torch.stack(n0), torch.stack(n0)])  # raw ns, raw ng
    for c, brow in enumerate(C.mesh_bounds_list):
        rows, s, e = _mk.cluster_candidates(brow, o, invd, best_t)
        keep = active[rows]
        rows, s, e = rows[keep], s[keep], e[keep]
        if rows.numel() == 0:
            continue
        k = int(brow[6])
        tw, nr = C.mesh_trisw[c, :, :k], C.mesh_nrm[c, :, :k]
        ok, t, u, v = _mk.bw_test(tw, [x[rows] for x in o], [x[rows] for x in d],
                               best_t[rows], s, e)
        hit, lane = _mk.first_min(ok, t)
        rows, lane = rows[hit], lane[hit]
        ar = torch.arange(lane.shape[0], device=lane.device)
        t, u, v = t[hit][ar, lane], u[hit][ar, lane], v[hit][ar, lane]
        tr, nv = tw[:, lane], nr[:, lane]
        w0 = 1.0 - u - v
        nsv = [w0 * nv[j] + u * nv[3 + j] + v * nv[6 + j] for j in range(3)]
        best_t[rows] = t
        prim[rows] = C.mesh_id
        att[:, rows] = torch.stack(nsv + [tr[0], tr[1], tr[2]])
    is_mesh = prim == C.mesh_id
    ns_raw = (att[0], att[1], att[2])
    ns = _normalize(ns_raw)
    ng = _normalize((att[3], att[4], att[5]))
    ns = _where3(_dot(ns_raw, ns_raw) > 1e-12, ns, ng)
    return best_t, prim, _where3(is_mesh, ns, n0), _where3(is_mesh, ng, n0)


def _mesh_anyhit(C: _Consts, o, d, tmax, lanes):
    """True on the ``lanes`` whose segment (1e-4, tmax) hits a mesh
    triangle (pallas_path._mesh_anyhit)."""
    return _mk.cluster_any_hit(C.mesh_bounds_list, C.mesh_trisw, _mk.bw_test, o, d, tmax, lanes)


def _camera_ray(C: _Consts, idx, jx, jy):
    """Primary ray of each lane from its pixel index and in-pixel jitter,
    starting at the near clip plane.  Returns (o, d)."""
    g = C.g
    py = (idx // C.W).to(torch.float32)
    px = (idx % C.W).to(torch.float32)
    u = (px + jx) * g[G_INVW]
    v = (py + jy) * g[G_INVH]
    cx = (2.0 * u - 1.0) * g[G_TFX]
    cy = (1.0 - 2.0 * v) * g[G_TFY]
    R = C.R
    d = _normalize((R[0][0] * cx + R[0][1] * cy + R[0][2],
                    R[1][0] * cx + R[1][1] * cy + R[1][2],
                    R[2][0] * cx + R[2][1] * cy + R[2][2]))
    t_near = g[G_NEAR] * torch.sqrt(cx * cx + cy * cy + 1.0)
    og = g[G_ORG:G_ORG + 3]
    o = (og[0] + t_near * d[0], og[1] + t_near * d[1], og[2] + t_near * d[2])
    return o, d


def _sample_state_init(C: _Consts, rng, idx, rays=None):
    """Fresh per-sample path state; draws the jitter and casts the camera
    ray.  Returns (state, (jx, jy)).  With ``rays`` = (o, d), [N, 3] each,
    the lanes start on those rays instead, with no jitter drawn (K4;
    ``_sample_state_init(raygen=None)``): (jx, jy) are then None.  On a
    textured environment the state carries the escape record (esc_d,
    esc_thr), zero until the path escapes.

    Stokes tables add the polarized state (pallas_path.py:1024-1039): T
    (3, 4, 4, N), the camera-side Mueller matrix per RGB channel, starting
    as the identity; the carried Stokes basis, the camera's x axis
    projected perpendicular to the primary ray; S (4, 3, N), the Stokes
    radiance.  The scalar thr / w_s machinery keeps running beside them: it
    drives Russian roulette and supplies the M00 weights."""
    zeros = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    ones = zeros + 1.0
    if rays is None:
        rng, jx = _rng_next(rng)
        rng, jy = _rng_next(rng)
        o, d = _camera_ray(C, idx, jx, jy)
    else:
        jx = jy = None
        o, d = (tuple(r[:, i] for i in range(3)) for r in rays)
    active = ones > 0.0
    st = dict(rng=rng, o=o, d=d, thr=(ones, ones, ones), L=(zeros, zeros, zeros),
              active=active, prev_pdf=ones, prev_delta=active, eta_scale=ones,
              ray_count=zeros)
    if C.env_textured:
        st.update(esc_d=(zeros, zeros, zeros), esc_thr=(zeros, zeros, zeros))
    if C.stokes:
        n = idx.shape[0]
        T = torch.zeros((3, 4, 4, n), dtype=torch.float32, device=idx.device)
        for i in range(4):
            T[:, i, i] = 1.0
        st.update(T=T, S=torch.zeros((4, 3, n), dtype=torch.float32, device=idx.device),
                  basis=_perp_basis(_scale(d, -1.0), [x + zeros for x in C.cam_x]))
    return st, (jx, jy)


# ---- polarized transport (pallas_path.py:803-890) ----
# vectors as component tuples, T as a (3, 4, 4, N) tensor

def _perp_basis(w, ref):
    """ref projected perpendicular to the unit w and normalized; where that
    is degenerate, the deterministic horizontal basis of
    ``bsdf/mueller.py::stokes_basis``.  ``1 / sqrt`` stands for the JAX
    package's ``rsqrt``, so the card rounds it the same way."""
    dp = _dot(w, ref)
    proj = (ref[0] - w[0] * dp, ref[1] - w[1] * dp, ref[2] - w[2] * dp)
    ln2 = _dot(proj, proj)
    ax = torch.where(torch.abs(w[0]) > 0.9, 0.0, 1.0)
    fb = _normalize(_cross((ax, 1.0 - ax, torch.zeros_like(ax)), w))
    inv = 1.0 / torch.sqrt(torch.clamp(ln2, min=1e-24))
    return _where3(ln2 > 1e-12, _scale(proj, inv), fb)


def _cdiv(ar, ai, br, bi):
    """(ar + i ai) / (br + i bi) in (re, im) pairs."""
    den = torch.clamp(br * br + bi * bi, min=1e-30)
    return (ar * br + ai * bi) / den, (ai * br - ar * bi) / den


def _fres_pol(cos_f, e_re, e_im):
    """Polarization components of Fresnel reflection for the complex
    relative IOR e_re + i e_im at |cos_f|: (a, b, c, s) with
    a = (|rs|^2 + |rp|^2) / 2, b = (|rs|^2 - |rp|^2) / 2, c + i s =
    rs conj(rp) (``bsdf/mueller.py::specular_reflection``'s terms; a
    dielectric's total internal reflection comes through the same complex
    square root)."""
    c = torch.abs(cos_f)
    sin2 = torch.clamp(1.0 - c * c, min=0.0)
    zr = e_re * e_re - e_im * e_im - sin2  # eta^2 - sin^2, complex
    zi = 2.0 * e_re * e_im
    mag = torch.sqrt(torch.clamp(zr * zr + zi * zi, min=0.0))
    u = torch.sqrt(torch.clamp(0.5 * (mag + zr), min=0.0))
    v = torch.sqrt(torch.clamp(0.5 * (mag - zr), min=0.0))
    rs_r, rs_i = _cdiv(c - u, -v, c + u, v)
    e2r = (zr + sin2) * c  # eta^2 cos
    e2i = zi * c
    rp_r, rp_i = _cdiv(e2r - u, e2i - v, e2r + u, e2i + v)
    Rs = rs_r * rs_r + rs_i * rs_i
    Rp = rp_r * rp_r + rp_i * rp_i
    return (0.5 * (Rs + Rp), 0.5 * (Rs - Rp), rs_r * rp_r + rs_i * rp_i,
            rs_i * rp_r - rs_r * rp_i)


def _mueller_chain(T, basis, p_B, p_A, M6):
    """T <- T R(phi) M for the sparse interaction matrix M = [[m00, m01, 0,
    0], [m10, m11, 0, 0], [0, 0, mc, ms], [0, 0, -ms, mc]], given per
    channel as M6 = (m00, m01, m10, m11, mc, ms), each (3, N).  phi turns
    the carried basis onto the scattering plane's s axis around the
    (camera-pointing) propagation direction p_B; cos 2 phi and sin 2 phi
    come from dot and cross products.  Returns (T_new, basis_new)."""
    s_raw = _cross(p_A, p_B)
    ln2 = _dot(s_raw, s_raw)
    degen = ln2 < 1e-12
    inv = 1.0 / torch.sqrt(torch.clamp(ln2, min=1e-24))
    s_axis = _where3(degen, _perp_basis(p_B, basis), _scale(s_raw, inv))
    cs = _dot(s_axis, basis)
    sn = _dot(_cross(s_axis, basis), p_B)
    n2 = torch.clamp(cs * cs + sn * sn, min=1e-20)
    C2 = (cs * cs - sn * sn) / n2
    S2 = 2.0 * cs * sn / n2
    m00, m01, m10, m11, mc, ms = (m[:, None] for m in M6)  # (3, 1, N)
    t0, t1, t2, t3 = T[:, :, 0], T[:, :, 1], T[:, :, 2], T[:, :, 3]  # (3, 4, N)
    rot_a = t1 * C2 - t2 * S2
    rot_b = t1 * S2 + t2 * C2
    T_new = torch.stack([t0 * m00 + rot_a * m10, t0 * m01 + rot_a * m11,
                         rot_b * mc - t3 * ms, rot_b * ms + t3 * mc], 2)
    return T_new, _where3(degen, _perp_basis(p_A, s_axis), s_axis)


def _add_emission(S, T, w, f=1.0):
    """Unpolarized emission: S[i][ch] += T[ch][i][0] * w[ch] * f, w (3, 1)
    or (3, N), f a lane factor (a product by 1.0 is exact)."""
    return S + T[:, :, 0].transpose(0, 1) * w * f


def _col3(vals, dev):
    """Three per-channel table constants as a (3, 1) tensor."""
    return torch.tensor(vals, dtype=torch.float32, device=dev)[:, None]


def _prim_attr_f(C: _Consts, prim_f, field, default):
    """Per-prim record entry of each lane's winning prim."""
    out = torch.full_like(prim_f, default)
    for pi, rec in enumerate(C.prims):
        out = torch.where(prim_f == float(pi), rec[field], out)
    return out


def _fres_cond(cos_f, c_eta, c_k, is_mirror):
    """Per-channel conductor Fresnel at |cos_f| (mirror -> 1)."""
    c2 = cos_f * cos_f
    s2 = 1.0 - c2
    out = []
    for ch in range(3):
        e2_ = c_eta[ch] * c_eta[ch]
        k2_ = c_k[ch] * c_k[ch]
        t0_ = e2_ - k2_ - s2
        a2b2 = _safe_sqrt(t0_ * t0_ + 4.0 * e2_ * k2_)
        t1_ = a2b2 + c2
        a_ = _safe_sqrt(torch.clamp(0.5 * (a2b2 + t0_), min=0.0))
        t2_ = 2.0 * a_ * cos_f
        rs_ = (t1_ - t2_) / torch.clamp(t1_ + t2_, min=1e-12)
        t3_ = c2 * a2b2 + s2 * s2
        t4_ = t2_ * s2
        rp_ = rs_ * (t3_ - t4_) / torch.clamp(t3_ + t4_, min=1e-12)
        out.append(torch.where(is_mirror, 1.0, 0.5 * (rs_ + rp_)))
    return tuple(out)


def _ggx_d_up(cz, alpha):
    """GGX D of an upper-hemisphere half vector, the cancellation-free form
    (pallas_path.py:1300-1308)."""
    c2 = cz * cz
    s2 = torch.clamp(1.0 - c2, min=0.0)
    a2 = alpha * alpha
    den = a2 * c2 + s2
    dd = a2 / torch.clamp(math.pi * den * den, min=1e-18)
    return torch.where(cz > 0.0, dd, 0.0)


def _ggx_g1(cz, alpha, two_sided=False):
    """Smith G1 of isotropic GGX at the local cosine cz: zero below the
    surface (pallas_path.py:1310-1313), or with ``two_sided`` only at
    cz == 0 (the sampled lobe's form, :1553-1557, cz taken after the
    flip)."""
    tan2 = torch.clamp(1.0 - cz * cz, min=0.0) / torch.clamp(cz * cz, min=1e-12)
    lam = 0.5 * (_safe_sqrt(1.0 + alpha * alpha * tan2) - 1.0)
    return torch.where((cz != 0.0) if two_sided else (cz > 0.0), 1.0 / (1.0 + lam), 0.0)


def _vndf_half(wi_l, alpha, u_a, u_b):
    """A GGX half vector drawn from the distribution of visible normals
    (Heitz's spherical cap) in the local frame, two-sided: wi is flipped
    into the upper hemisphere and the half vector flipped back.  Returns
    (m, flip).  The rough conductor (pallas_path.py:1524-1549) and the
    acoustic BSDF (pallas_us.py) draw it the same way; ``1 / sqrt`` stands
    for the JAX package's ``rsqrt``, so the card rounds it the same way."""
    flip = torch.where(wi_l[2] >= 0.0, 1.0, -1.0)
    wif = _scale(wi_l, flip)
    vh = _normalize((alpha * wif[0], alpha * wif[1], wif[2]))
    lensq = vh[0] * vh[0] + vh[1] * vh[1]
    inv_len = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    big = lensq > 1e-20
    t1v = (torch.where(big, -vh[1] * inv_len, 1.0),
           torch.where(big, vh[0] * inv_len, 0.0), torch.zeros_like(lensq))
    t2v = _cross(vh, t1v)
    r_h = torch.sqrt(torch.clamp(u_a, min=0.0))
    phi_h = (2.0 * math.pi) * u_b
    p1h = r_h * torch.cos(phi_h)
    p2h = r_h * torch.sin(phi_h)
    s_h = 0.5 * (1.0 + vh[2])
    p2h = (1.0 - s_h) * _safe_sqrt(1.0 - p1h * p1h) + s_h * p2h
    nh = _add(_add(_scale(t1v, p1h), _scale(t2v, p2h)),
              _scale(vh, _safe_sqrt(1.0 - p1h * p1h - p2h * p2h)))
    mh = _normalize((alpha * nh[0], alpha * nh[1], torch.clamp(nh[2], min=1e-6)))
    return _scale(mh, flip), flip


def _make_bounce_step(C: _Consts, raygen=True):
    """step(depth, st) -> st: one bounce (sweep, emitter hit + MIS, one NEE
    sample with a shadow ray, BSDF sampling, Russian roulette) at a static
    depth, as the JAX kernel's unrolled form.  On Stokes tables every
    emission also reaches S through T's first column, and the sampled
    interaction's Mueller matrix is chained onto T (pallas_path.py:
    1194-1199, 1228-1233, 1439-1477, 1616-1709).  A polarizer or ``null``
    hit passes straight on, a delta lobe of the BSDF table's tint
    (pallas_path.py:1246-1262, 1575-1602), a neutral attenuator in the
    Stokes form (:1635-1660).  On a textured environment an escaping path
    records its direction and throughput (:1199-1204).  ``raygen=False``
    (K4's rays) drops the camera's far-plane clip at depth 0."""
    g = C.g
    inv_nl = g[G_INV_NL]
    dev = C.tab_device

    def step(depth, st):
        rng, o, d, thr, L = st["rng"], st["o"], st["d"], st["thr"], st["L"]
        active, prev_pdf, prev_delta = st["active"], st["prev_pdf"], st["prev_delta"]
        eta_scale, ray_count = st["eta_scale"], st["ray_count"]
        if C.stokes:
            T, S, basis = st["T"], st["S"], st["basis"]
        if C.env_textured:
            esc_d, esc_thr = st["esc_d"], st["esc_thr"]
        zeros = torch.zeros_like(o[0])
        ones = zeros + 1.0
        t, prim_f, n = _sweep(C, o, d, 1e-4, _BIG)
        if C.mesh_c:
            # n stays the shading normal, n_g is the geometric one that
            # the spawn offsets follow
            t, prim_f, n, n_g = _mesh_closest(C, o, d, torch.where(active, t, 1e-4),
                                              prim_f, n, active)
        else:
            n_g = n
        hit = (prim_f >= 0.0) & active
        if raygen and C.has_far and depth == 0:
            # the primary origin sits at the near plane, so the clip length
            # left is (far - near) * |d_cam|, |d_cam| = 1 / (d . forward)
            R = C.R
            dz = d[0] * R[0][2] + d[1] * R[1][2] + d[2] * R[2][2]
            t_far = _rdiv(g[G_FAR_NEAR], torch.clamp(dz, min=1e-9))
            hit = hit & (t <= t_far)
        ray_count = ray_count + torch.where(active, 1.0, 0.0)
        show_em = not (depth == 0 and C.hide_emitters)

        if C.has_env and show_em:
            # constant environment, BSDF-sampled only: escape weight is 1
            ef = torch.where(active & ~hit, 1.0, 0.0)
            L = tuple(L[c] + thr[c] * g[G_ENV + c] * ef for c in range(3))
            if C.stokes:
                S = _add_emission(S, T, _col3(g[G_ENV:G_ENV + 3], dev), ef)
        if C.env_textured and show_em:
            # the lat-long lookup of the escape runs after the kernel
            esc = active & ~hit
            esc_d, esc_thr = _where3(esc, d, esc_d), _where3(esc, thr, esc_thr)

        p_hit = _add(o, _scale(d, torch.where(hit, t, 0.0)))
        wi = _scale(d, -1.0)
        cos_l = _dot(n, wi)

        # ---- emitter hit + MIS ----------------------------------------
        if C.n_area and show_em:
            em_id = _prim_attr_f(C, prim_f, 2, -1.0)
            for e, rec in enumerate(C.ems):
                m = hit & (em_id == float(e)) & (cos_l > 0.0)
                pdf_light = rec[3] * t * t / torch.clamp(cos_l, min=1e-6) * inv_nl
                w_b = torch.where(prev_delta, 1.0, _mis(prev_pdf, pdf_light))
                wfac = torch.where(m, w_b, 0.0)
                L = tuple(L[c] + thr[c] * rec[c] * wfac for c in range(3))
                if C.stokes:
                    S = _add_emission(S, T, _col3(rec[0:3], dev), wfac)

        # ---- per-lane BSDF constants ----------------------------------
        bsdf_id = _prim_attr_f(C, prim_f, 1, -1.0)
        if C.mesh_c:
            bsdf_id = torch.where(prim_f == C.mesh_id, C.mesh_bsdf, bsdf_id)
        btype = zeros - 1.0
        refl = (zeros, zeros, zeros)
        eta_rel = ones
        c_eta = (zeros, zeros, zeros)
        c_k = (ones, ones, ones)
        is_mirror = zeros > 1.0
        alpha_rc = zeros + 1e-3  # the rough conductor's GGX alpha
        spec_c = (ones, ones, ones)
        pass_t = (ones, ones, ones)  # pass-through tint (polarizer / null)
        for bi, rec in enumerate(C.bsdfs):
            m = bsdf_id == float(bi)
            bt = int(rec[0])
            btype = torch.where(m, float(bt), btype)
            if bt == BSDF_DIFFUSE:
                refl = _where3(m, [x + zeros for x in rec[1:4]], refl)
            elif bt == BSDF_DIELECTRIC:
                eta_rel = torch.where(m, rec[4], eta_rel)
            elif bt in (BSDF_POLARIZER, BSDF_NULL):
                pass_t = _where3(m, [x + zeros for x in rec[1:4]], pass_t)
            else:
                if rec[11]:
                    is_mirror = is_mirror | m
                else:
                    c_eta = _where3(m, [x + zeros for x in rec[5:8]], c_eta)
                    c_k = _where3(m, [x + zeros for x in rec[8:11]], c_k)
                spec_c = _where3(m, [x + zeros for x in rec[12:15]], spec_c)
                if bt == BSDF_ROUGH_CONDUCTOR:
                    alpha_rc = torch.where(m, rec[B_ALPHA], alpha_rc)

        s_fr, t_fr = _frame(n)
        wi_l = _to_local(n, s_fr, t_fr, wi)
        cos_i = wi_l[2]
        u = []
        for _ in range(9):
            rng, ui = _rng_next(rng)
            u.append(ui)
        u0, u1, u2, u3, u4, u5, u6, u7, u8 = u
        is_diffuse = btype == float(BSDF_DIFFUSE)
        is_rough = btype == float(BSDF_ROUGH_CONDUCTOR)

        # ---- NEE: one light sample, diffuse and rough-conductor lanes --
        if C.n_lights > 0 and depth + 2 <= C.max_depth:
            li_f = torch.clamp(torch.floor(u0 * g[G_NL]), max=g[G_NL_M1])
            lp = ln = l_rad = (zeros, zeros, zeros)
            pdf_a = zeros  # area pdf 1/area; 0 marks a delta light
            light_idx = 0
            for rec in C.ems:
                m_l = li_f == float(light_idx)
                for j in range(int(rec[4])):
                    tp, lo, hi = rec[5 + 3 * j:8 + 3 * j]
                    q = C.prims[int(tp)][4:]
                    p0, e1, e2, ng = q[0:3], q[3:6], q[6:9], q[9:12]
                    m_t = m_l & (u1 >= lo) & (u1 < hi)
                    st_ = _safe_sqrt(1.0 - u2)
                    ub = 1.0 - st_
                    vb = st_ * u3
                    cand = (p0[0] + ub * e1[0] + vb * e2[0],
                            p0[1] + ub * e1[1] + vb * e2[1],
                            p0[2] + ub * e1[2] + vb * e2[2])
                    lp = _where3(m_t, cand, lp)
                    ln = _where3(m_t, [x + zeros for x in ng], ln)
                l_rad = _where3(m_l, [x + zeros for x in rec[0:3]], l_rad)
                pdf_a = torch.where(m_l, rec[3], pdf_a)
                light_idx += 1
            for rec in C.points:
                m_l = li_f == float(light_idx)
                lp = _where3(m_l, [x + zeros for x in rec[0:3]], lp)
                l_rad = _where3(m_l, [x + zeros for x in rec[3:6]], l_rad)
                light_idx += 1

            to_l = (lp[0] - p_hit[0], lp[1] - p_hit[1], lp[2] - p_hit[2])
            dist2 = torch.clamp(_dot(to_l, to_l), min=1e-20)
            dist = torch.sqrt(dist2)
            wl = _scale(to_l, 1.0 / dist)
            cos_sl = _dot(n, wl)
            cos_ll = -_dot(wl, ln)
            is_delta_l = pdf_a == 0.0
            pdf_nee = torch.where(
                is_delta_l, inv_nl,
                pdf_a * dist2 / torch.clamp(cos_ll, min=1e-6) * inv_nl)
            nee_f = _scale(refl, _INV_PI * torch.clamp(cos_sl, min=0.0))
            pdf_bsdf_l = torch.clamp(cos_sl, min=0.0) * _INV_PI
            nee_lanes = is_diffuse & (cos_i > 0.0)
            if C.has_rough:
                # the rough conductor toward the light (pallas_path.py:
                # 1387-1408): f cos = spec F(cos_ih) D G2 / (4 cos_i), pdf
                # G1(wi) D / (4 cos_i) in the VNDF's measure
                wl_l = _to_local(n, s_fr, t_fr, wl)
                hn = _normalize(_add(wi_l, wl_l))
                D_l = _ggx_d_up(hn[2], alpha_rc)
                G2_l = _ggx_g1(cos_i, alpha_rc) * _ggx_g1(wl_l[2], alpha_rc)
                cos_ih_l = torch.abs(_dot(wi_l, hn))
                F_l = _fres_cond(cos_ih_l, c_eta, c_k, is_mirror)
                base = D_l * G2_l / torch.clamp(4.0 * cos_i, min=1e-12)
                rough_nee = is_rough & (cos_i > 0.0) & (wl_l[2] > 0.0)
                nee_f = _where3(rough_nee, [spec_c[c] * F_l[c] * base for c in range(3)], nee_f)
                pdf_bsdf_l = torch.where(
                    rough_nee,
                    _ggx_g1(cos_i, alpha_rc) * D_l / torch.clamp(4.0 * cos_i, min=1e-12),
                    pdf_bsdf_l)
                nee_lanes = nee_lanes | rough_nee
            nee_ok = hit & nee_lanes & (cos_sl > 0.0)
            nee_ok = nee_ok & (is_delta_l | (cos_ll > 1e-6))
            shadow_o = _add(p_hit, _scale(
                n_g, 1e-4 * torch.where(_dot(n_g, wl) >= 0, 1.0, -1.0)))
            occ = _sweep(C, shadow_o, wl, 1e-4, dist * (1.0 - 1e-3), any_hit=True)
            if C.mesh_c:
                occ = occ | _mesh_anyhit(C, shadow_o, wl, dist * (1.0 - 1e-3), nee_ok)
            vis = nee_ok & ~occ
            ray_count = ray_count + torch.where(nee_ok, 1.0, 0.0)
            w_nee = torch.where(is_delta_l, 1.0, _mis(pdf_nee, pdf_bsdf_l))
            scale_area = w_nee / torch.clamp(pdf_nee, min=1e-20)
            scale_delta = _rdiv(g[G_NL], dist2)  # 1/pdf = L; I/d^2
            scf = torch.where(vis, torch.where(is_delta_l, scale_delta, scale_area), 0.0)
            L = tuple(L[c] + thr[c] * nee_f[c] * l_rad[c] * scf for c in range(3))
            if C.stokes:
                # diffuse NEE depolarizes: (T R M_dep)[:, 0] = T[:, 0] w;
                # rough-conductor NEE chains its specular Mueller matrix
                # through the NEE scattering plane (pallas_path.py:1439-1477)
                nee_w = torch.stack([nee_f[c] * l_rad[c] * scf for c in range(3)])
                if C.has_rough:
                    rough_f = torch.where(rough_nee, 1.0, 0.0)
                    M6n = [[] for _ in range(6)]
                    for ch in range(3):
                        a_c, b_c, c_c, s_c = _fres_pol(cos_ih_l,
                                                       torch.where(is_mirror, 1e6, c_eta[ch]),
                                                       torch.where(is_mirror, 1e8, c_k[ch]))
                        inv_a = 1.0 / torch.clamp(a_c, min=1e-12)
                        w_ch = nee_w[ch]
                        for k, m in enumerate((w_ch, w_ch * b_c * inv_a * rough_f,
                                               w_ch * b_c * inv_a * rough_f, w_ch * rough_f,
                                               w_ch * c_c * inv_a * rough_f,
                                               w_ch * s_c * inv_a * rough_f)):
                            M6n[k].append(m)
                    T_nee, _ = _mueller_chain(T, basis, _scale(d, -1.0), _scale(wl, -1.0),
                                              [torch.stack(m) for m in M6n])
                    S = S + torch.where(rough_nee, T_nee[:, :, 0].transpose(0, 1),
                                        T[:, :, 0].transpose(0, 1) * nee_w)
                else:
                    S = _add_emission(S, T, nee_w)

        # ---- BSDF sampling --------------------------------------------
        # diffuse: cosine hemisphere via the concentric disk
        sx_ = 2.0 * u4 - 1.0
        sy_ = 2.0 * u5 - 1.0
        is_zero = (sx_ == 0.0) & (sy_ == 0.0)
        quad_x = torch.abs(sx_) > torch.abs(sy_)
        r_d = torch.where(quad_x, sx_, sy_)
        safe_sx = torch.where(sx_ == 0.0, 1.0, sx_)
        safe_sy = torch.where(sy_ == 0.0, 1.0, sy_)
        phi_d = torch.where(quad_x, (math.pi / 4.0) * (sy_ / safe_sx),
                            (math.pi / 2.0) - (math.pi / 4.0) * (sx_ / safe_sy))
        phi_d = torch.where(is_zero, 0.0, phi_d)
        dx_d = r_d * torch.cos(phi_d)
        dy_d = r_d * torch.sin(phi_d)
        dz_d = _safe_sqrt(1.0 - dx_d * dx_d - dy_d * dy_d)
        sign_i = torch.where(cos_i == 0.0, 1.0, torch.sign(cos_i))
        wo_diff = (dx_d * sign_i, dy_d * sign_i, dz_d * sign_i)
        pdf_diff = torch.abs(dz_d) * _INV_PI

        # smooth dielectric: Fresnel pick of reflection or refraction
        outside = cos_i >= 0.0
        eta_it = torch.where(outside, eta_rel, 1.0 / eta_rel)
        eta_ti = 1.0 / eta_it
        c2t = 1.0 - eta_ti * eta_ti * (1.0 - cos_i * cos_i)
        abs_ci = torch.abs(cos_i)
        ct = _safe_sqrt(c2t)
        rs = (abs_ci - eta_it * ct) / torch.clamp(abs_ci + eta_it * ct, min=1e-9)
        rp = (eta_it * abs_ci - ct) / torch.clamp(eta_it * abs_ci + ct, min=1e-9)
        F = 0.5 * (rs * rs + rp * rp)
        F = torch.where(c2t <= 0.0, 1.0, F)
        pick_refl = u6 <= F
        ct_signed = torch.where(cos_i >= 0.0, -ct, ct)
        wo_die = _where3(pick_refl, (-wi_l[0], -wi_l[1], wi_l[2]),
                         (-eta_ti * wi_l[0], -eta_ti * wi_l[1], ct_signed))
        w_die_s = torch.where(pick_refl, 1.0, eta_ti * eta_ti)
        eta_fac = torch.where(pick_refl, 1.0, eta_it)

        # smooth conductor: mirror reflection; Fresnel at |cos_i|, for a
        # rough conductor at the half vector
        wo_con = (-wi_l[0], -wi_l[1], wi_l[2])
        cos_f = torch.abs(cos_i)
        if C.has_rough:
            # rough conductor: a VNDF half vector from u7, u8, wo mirrored
            # about it, weight F G2 / G1 (pallas_path.py:1524-1561)
            mh, flip_rc = _vndf_half(wi_l, alpha_rc, u7, u8)
            cos_im_rc = _dot(wi_l, mh)
            mh2 = _scale(mh, 2.0 * cos_im_rc)
            wo_rc = (mh2[0] - wi_l[0], mh2[1] - wi_l[1], mh2[2] - wi_l[2])
            g1_i = _ggx_g1(wi_l[2] * flip_rc, alpha_rc, two_sided=True)
            w_g = g1_i * _ggx_g1(wo_rc[2] * flip_rc, alpha_rc, two_sided=True) / torch.clamp(
                g1_i, min=1e-12)
            valid_rc = (cos_i > 0.0) & (wo_rc[2] > 0.0)
            cos_f = torch.where(is_rough, torch.abs(cos_im_rc), cos_f)
        Fc = _fres_cond(cos_f, c_eta, c_k, is_mirror)
        Fc = (Fc[0] * spec_c[0], Fc[1] * spec_c[1], Fc[2] * spec_c[2])

        is_die = btype == float(BSDF_DIELECTRIC)
        is_con = btype == float(BSDF_CONDUCTOR)
        is_pass = (btype == float(BSDF_POLARIZER)) | (btype == float(BSDF_NULL))
        wo_spec = wo_con
        if C.has_rough:
            wo_spec = _where3(is_rough, wo_rc, wo_con)
        wo_l = _where3(is_diffuse, wo_diff, _where3(is_die, wo_die, wo_spec))
        # pass-through: straight on
        wo_l = _where3(is_pass, (-wi_l[0], -wi_l[1], -wi_l[2]), wo_l)
        pdf_s = torch.where(is_diffuse, pdf_diff, torch.where(
            is_die, torch.where(pick_refl, F, 1.0 - F), 1.0))
        w_spec = Fc
        delta_s = ~is_diffuse
        valid_s = ((is_diffuse & (cos_i > 0.0)) | (is_con & (cos_i > 0.0)) | is_die
                   | is_pass)
        if C.has_rough:
            # the rough lobe carries its VNDF pdf, so both MIS sides see it
            pdf_s = torch.where(is_rough, _ggx_g1(cos_i, alpha_rc) * _ggx_d_up(mh[2], alpha_rc)
                                / torch.clamp(4.0 * cos_i, min=1e-12), pdf_s)
            w_spec = _where3(is_rough, _scale(Fc, w_g), Fc)
            delta_s = delta_s & ~is_rough
            valid_s = valid_s | (is_rough & valid_rc)
        w_s = _where3(is_diffuse, refl,
                      _where3(is_die, (w_die_s, w_die_s, w_die_s), w_spec))
        w_s = _where3(is_pass, pass_t, w_s)
        eta_s = torch.where(is_die, eta_fac, 1.0)

        d_new = _normalize(_to_world(n, s_fr, t_fr, wo_l))
        off_sign = torch.where(_dot(n_g, d_new) >= 0.0, 1.0, -1.0)
        o_new = _add(p_hit, _scale(n_g, 1e-4 * off_sign))
        thr_new = (thr[0] * w_s[0], thr[1] * w_s[1], thr[2] * w_s[2])
        alive = hit & valid_s & (pdf_s > 0.0)
        eta_scale = eta_scale * eta_s
        thr_max = torch.maximum(thr_new[0], torch.maximum(thr_new[1], thr_new[2]))
        alive = alive & (thr_max > 0.0)

        if C.stokes:
            # the interaction's Mueller matrix per channel, M00-normalized to
            # the scalar weight w_s: only the lobe's polarization ratios
            # b/a, c/a, s/a ride on top.  Dielectric reflection takes the
            # complex form (it covers TIR), transmission the real one.
            a_dr, b_dr, c_dr, s_dr = _fres_pol(cos_i, eta_it, zeros)
            inv_adr = 1.0 / torch.clamp(a_dr, min=1e-12)
            ts_ = 2.0 * abs_ci / torch.clamp(abs_ci + eta_it * ct, min=1e-9)
            tp_ = 2.0 * abs_ci / torch.clamp(eta_it * abs_ci + ct, min=1e-9)
            Ts_, Tp_ = ts_ * ts_, tp_ * tp_
            inv_adt = 1.0 / torch.clamp(0.5 * (Ts_ + Tp_), min=1e-12)
            rb_die = torch.where(pick_refl, b_dr * inv_adr, 0.5 * (Ts_ - Tp_) * inv_adt)
            rc_die = torch.where(pick_refl, c_dr * inv_adr, ts_ * tp_ * inv_adt)
            rs_die = torch.where(pick_refl, s_dr * inv_adr, 0.0)
            specf = torch.where(is_die | is_con | is_rough, 1.0, 0.0)
            passf = torch.where(is_pass, 1.0, 0.0)  # a neutral attenuator
            M6 = [[] for _ in range(6)]
            for ch in range(3):
                a_c, b_c, c_c, s_c = _fres_pol(cos_f, torch.where(is_mirror, 1e6, c_eta[ch]),
                                               torch.where(is_mirror, 1e8, c_k[ch]))
                inv_ac = 1.0 / torch.clamp(a_c, min=1e-12)
                rb = torch.where(is_die, rb_die, b_c * inv_ac)
                rc = torch.where(is_die, rc_die, c_c * inv_ac)
                rs_ = torch.where(is_die, rs_die, s_c * inv_ac)
                w_ch = w_s[ch]
                for k, m in enumerate((w_ch, w_ch * rb * specf, w_ch * rb * specf,
                                       w_ch * (specf + passf), w_ch * (rc * specf + passf),
                                       w_ch * rs_ * specf)):
                    M6[k].append(m)
            T_new, basis_new = _mueller_chain(T, basis, _scale(d, -1.0), _scale(d_new, -1.0),
                                              [torch.stack(m) for m in M6])

        if depth >= C.rr_depth:
            rng, u_rr = _rng_next(rng)
            inv_e2 = 1.0 / torch.clamp(eta_scale * eta_scale, min=1e-12)
            q = torch.clamp(thr_max * inv_e2, max=0.95)
            survive = u_rr < q
            inv_q = 1.0 / torch.clamp(q, min=1e-12)
            thr_new = tuple(torch.where(survive, x * inv_q, 0.0) for x in thr_new)
            alive = alive & survive
            if C.stokes:
                T_new = T_new * torch.where(survive, inv_q, 0.0)

        out = dict(
            rng=rng, o=_where3(alive, o_new, o), d=_where3(alive, d_new, d),
            thr=_where3(alive, thr_new, (zeros, zeros, zeros)), L=L,
            active=alive, prev_pdf=pdf_s, prev_delta=delta_s,
            eta_scale=eta_scale, ray_count=ray_count)
        if C.env_textured:
            out.update(esc_d=esc_d, esc_thr=esc_thr)
        if C.stokes:
            # a dead lane's T is exact zeros
            out.update(T=T_new * torch.where(alive, 1.0, 0.0), S=S,
                       basis=_where3(alive, basis_new, basis))
        return out

    return step


def _film_w1d(filt, d, j):
    """Separable 1-D filter weight of a sample with in-pixel jitter j at
    the center of the pixel d steps away (x = d + 0.5 - j)."""
    x = (d + 0.5) - j
    if filt == "tent":
        return torch.clamp(1.0 - torch.abs(x), min=0.0)
    g = torch.exp(-2.0 * x * x) - _GAUSS_TAIL
    return torch.where(torch.abs(x) <= 2.0, torch.clamp(g, min=0.0), 0.0)


def splat_upd(vals, rc, jx, jy, radius):
    """One sample's update of the film planes: per filter offset (dy, dx)
    in row-major order, the weighted values (r, g, b, or the 12 Stokes
    values) and the weight w; then the ray count.  A sample with any
    non-finite value is left out of value and weight."""
    ok = torch.abs(vals[0]) < math.inf
    for v in vals[1:]:
        ok = ok & (torch.abs(v) < math.inf)
    okf = torch.where(ok, 1.0, 0.0)
    vals = [torch.where(ok, v, 0.0) for v in vals]
    if radius == 0:  # box: the sample stays in its own pixel with w = 1
        return vals + [okf, rc]
    filt = "tent" if radius == 1 else "gaussian"
    wx = [_film_w1d(filt, dd, jx) for dd in range(-radius, radius + 1)]
    wy = [_film_w1d(filt, dd, jy) for dd in range(-radius, radius + 1)]
    upd = []
    for a in range(2 * radius + 1):
        for b in range(2 * radius + 1):
            w = wy[a] * wx[b] * okf
            upd += [w * v for v in vals] + [w]
    return upd + [rc]


def _sample_vals(st):
    """The values a sample splats: L, or S row-major (I, Q, U, V) x rgb."""
    return list(st["S"].reshape(12, -1)) if "S" in st else list(st["L"])


def _trace_samples(tables: FilmTables, seed: int, n_samples: int):
    """Yield (state, jx, jy) of each of ``n_samples`` traced samples per
    pixel, in order.  Sample i of a launch seeded s draws the stream of
    seed s + i; a lane's samples come out in order whatever the loop form
    or the thread that traced them, so the plain version serves K1, K2's
    regeneration loop around it and K3's thread a sample."""
    C = _Consts(tables)
    dev = tables.tab.device
    idx = torch.arange(tables.n_pix, dtype=torch.int64, device=dev)
    tile, lane = idx // C.tile_lanes, idx % C.tile_lanes
    step = _make_bounce_step(C)
    for i in range(n_samples):
        st, (jx, jy) = _sample_state_init(C, _rng_init(seed + i, tile, lane), idx)
        for depth in range(C.max_depth):
            st = step(depth, st)
        yield st, jx, jy


def _film_plain(tables: FilmTables, seed: int, n_samples: int):
    acc = [torch.zeros(tables.n_pix, dtype=torch.float32, device=tables.tab.device)] * (
        tables.n_acc + 1)
    for st, jx, jy in _trace_samples(tables, seed, n_samples):
        upd = splat_upd(_sample_vals(st), st["ray_count"], jx, jy, tables.radius)
        acc = [a + u for a, u in zip(acc, upd)]
    return torch.stack(acc)


def film_records_plain(tables: FilmTables, seed: int, n_samples: int):
    """The plain version of K1's (either loop form) and K3's trace kernel,
    by the tables: (n_val, n_samples, H*W) sample records
    laid out [value][sample][pixel], per sample its values (r, g, b, or the
    12 Stokes values) and its ray count.  No jitter: ``film_splat_plain``
    draws it again from the sample's keys."""
    recs = torch.empty((tables.n_val, n_samples, tables.n_pix), dtype=torch.float32,
                       device=tables.tab.device)
    for i, (st, _, _) in enumerate(_trace_samples(tables, seed, n_samples)):
        recs[:, i] = torch.stack(_sample_vals(st) + [st["ray_count"]])
    return recs


def film_splat_plain(records, planes, tables: FilmTables, seed: int):
    """The plain version of ``film_splat``: the records of a launch seeded
    ``seed`` (``film_records_plain``'s layout) added, sample by sample in
    order, onto the (n_acc + 1, H*W) planes in place, each with the jitter
    its trace drew (the first two draws of the stream of seed + i) and
    ``splat_upd``'s arithmetic; returns the planes.  Onto zeros this gives
    ``film_trace_plain``'s planes bit for bit, and a chunk added onto the
    planes of the chunks before it continues their sums exactly."""
    n_val, n_samples, n_pix = records.shape
    if n_val != tables.n_val or n_pix != tables.n_pix or planes.shape != (tables.n_acc + 1,
                                                                         n_pix):
        raise ValueError("film_splat needs records (n_val, n, H*W) and planes (n_acc + 1, H*W) "
                         "of these tables")
    C = tables.hdr_list[HDR_TILE_LANES]
    idx = torch.arange(n_pix, dtype=torch.int64, device=records.device)
    tile, lane = idx // C, idx % C
    for i in range(n_samples):
        jx = jy = None
        if tables.radius:
            rng, jx = _rng_next(_rng_init(seed + i, tile, lane))
            _, jy = _rng_next(rng)
        planes += torch.stack(splat_upd(list(records[:-1, i]), records[-1, i], jx, jy,
                                        tables.radius))
    return planes


def split_film(tables: FilmTables, seed: int, n_samples: int, records, splat):
    """The planes of a film launch on the card: chunks of at most
    RECORD_CHUNK samples, each traced into records by ``records(tables,
    seed, k)`` and added onto the planes by ``splat(recs, planes, tables,
    seed)``; chunk j is seeded seed + j * RECORD_CHUNK, so sample i still
    draws the stream of seed + i."""
    chunk = RECORD_CHUNK
    planes = torch.zeros((tables.n_acc + 1, tables.n_pix), dtype=torch.float32,
                         device=tables.tab.device)
    for c0 in range(0, n_samples, chunk):
        s = _wrap_i32(seed + c0)
        splat(records(tables, s, min(chunk, n_samples - c0)), planes, tables, s)
    return planes


def film_trace_plain(tables: FilmTables, seed: int, n_samples: int):
    """The plain PyTorch version of K1 (and of K2's loop around it):
    (n_acc + 1, H*W) planes."""
    _check_kind(tables, False, "film_trace")
    return _film_plain(tables, seed, n_samples)


def stokes_film_trace_plain(tables: FilmTables, seed: int, n_samples: int):
    """The plain PyTorch version of K3 (and of tpu_rt's K2 loop around it):
    (13 * offsets + 1, H*W) planes, per filter offset the 12 weighted
    Stokes values (I, Q, U, V, each r, g, b) and the weight, then the ray
    count."""
    _check_kind(tables, True, "stokes_film_trace")
    return _film_plain(tables, seed, n_samples)


def _chunk(n_samples) -> int:
    """The samples of a per-sample launch: 1 for None (a one-sample call
    with (planes, N) output), else an int >= 1 (output (planes, n, N))."""
    k = 1 if n_samples is None else n_samples
    if not isinstance(k, int) or isinstance(k, bool) or k < 1:
        raise ValueError(f"n_samples must be None or an int >= 1, not {n_samples!r}")
    return k


def _sample_planes(planes, n_samples):
    """A per-sample call's output: each sample's (P, N) planes stacked as
    (P, n, N), or the one sample's (P, N) when ``n_samples`` is None."""
    return planes[0] if n_samples is None else torch.stack(planes, 1)


def stokes_sample_trace_plain(tables: FilmTables, seed: int, n_samples=None):
    """The plain PyTorch version of K6: one polarized sample per pixel,
    as (15, H*W) planes: S row-major (I, Q, U, V) x rgb, the ray count,
    the jitter jx, jy (pallas_path.pallas_stokes_trace's outputs).  With
    an int ``n_samples``, a chunk of that many samples, (15, n, H*W):
    sample i draws the stream of seed + i, as the one-sample call seeded
    seed + i does."""
    _check_kind(tables, True, "stokes_sample_trace")
    return _sample_planes([
        torch.cat([st["S"].reshape(12, -1), torch.stack([st["ray_count"], jx, jy])])
        for st, jx, jy in _trace_samples(tables, seed, _chunk(n_samples))], n_samples)


def _escape_planes(st):
    """The escape record's planes, esc_d then esc_thr (textured
    environments only)."""
    return list(st["esc_d"]) + list(st["esc_thr"]) if "esc_d" in st else []


def raygen_trace_plain(tables: FilmTables, seed: int, n_samples=None):
    """The plain PyTorch version of K5: one camera sample per pixel, as (6,
    H*W) planes L (r, g, b), the ray count, the jitter jx, jy, and on a
    textured environment 6 more, the escape direction and throughput
    (pallas_path.pallas_raygen_trace's outputs).  With an int
    ``n_samples``, a chunk, (P, n, H*W), sample i seeded seed + i."""
    _check_kind(tables, False, "raygen_trace")
    return _sample_planes([
        torch.stack(list(st["L"]) + [st["ray_count"], jx, jy] + _escape_planes(st))
        for st, jx, jy in _trace_samples(tables, seed, _chunk(n_samples))], n_samples)


def path_trace_plain(tables: FilmTables, o, d, seed: int, n_samples=None):
    """The plain PyTorch version of K4: the bounce loop on the rays o, d
    ([N, 3] float32 on the tables' device), one sample a lane, every lane
    active, no jitter and no far-plane clip; lane i draws the stream of
    (seed, i // tile_lanes, i % tile_lanes).  Returns (4, N) planes L
    (r, g, b) and the ray count, and on a textured environment 6 more, the
    escape direction and throughput (pallas_path.pallas_path_trace's
    outputs).  With an int ``n_samples``, a chunk, (P, n, N): sample i of
    every ray seeded seed + i."""
    _check_kind(tables, False, "path_trace")
    C = _Consts(tables)
    idx = torch.arange(o.shape[0], dtype=torch.int64, device=o.device)
    step = _make_bounce_step(C, raygen=False)
    planes = []
    for i in range(_chunk(n_samples)):
        st, _ = _sample_state_init(
            C, _rng_init(seed + i, idx // C.tile_lanes, idx % C.tile_lanes), idx, rays=(o, d))
        for depth in range(C.max_depth):
            st = step(depth, st)
        planes.append(torch.stack(list(st["L"]) + [st["ray_count"]] + _escape_planes(st)))
    return _sample_planes(planes, n_samples)


def sample_planes_split(planes):
    """K6's planes as (S [..., N, 4, 3], jitter [..., N, 2], the rays cast
    as a 0-d int64 tensor); a chunk's (15, n, N) planes give a leading
    sample dimension n."""
    lead = planes.shape[1:]
    return (planes[:12].movedim(0, -1).reshape(*lead, 4, 3), planes[13:15].movedim(0, -1),
            planes[12].to(torch.int64).sum())


def _check_kind(tables: FilmTables, stokes: bool, name: str):
    if tables.stokes != stokes:
        raise ValueError(f"{name} needs tables packed with stokes={stokes}")


# ---------------------------------------------------------------------------
# Wrappers: the plain version on the CPU, the hand-written kernel on CUDA
# ---------------------------------------------------------------------------

def _wrap_i32(x: int) -> int:
    return ((x + (1 << 31)) & _M32) - (1 << 31)


# what the launch computes (path_film.cu's launch modes): K1's records,
# K6's sample planes (K3's records their first 13), K5's sample planes or
# K4's planes on rays passed in
_MODE_FILM, _MODE_STOKES_SAMPLE, _MODE_RAYGEN_SAMPLE, _MODE_RAYS_SAMPLE = range(4)
# the most samples a launch with the sample in the grid (K6, K5, K4)
# traces (path_film.cu kMaxChunk, gridDim.y)
MAX_SAMPLE_CHUNK = 65535


def _launch(tables: FilmTables, seed: int, n_samples: int, mode: int, n_out, name: str,
            rays=None, regen=False):
    """Launch ``csrc/path_film.cu`` (built at first use) in ``mode`` on the
    tables' CUDA device, one lane a pixel, or one a ray of ``rays`` (6, N)
    for K4, and every mode but K1's lanes once for each of ``n_samples``
    samples; the header's rough-cone flag picks the kernels with the rough
    conductor's lane and cones.  ``n_out``: every mode but K1's planes, the
    output (n_out, n_samples, N); K1's records shape.  ``regen``: K1's loop
    form, K2's loop where true.  Returns the output."""
    dev = tables.tab.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev.type}")
    if tables.radius not in (0, 1, 2) or n_samples < 1:
        raise ValueError(f"{name} needs a box/tent/gaussian film and n_samples >= 1")
    per_sample = mode != _MODE_FILM
    if per_sample and n_samples > MAX_SAMPLE_CHUNK:
        raise ValueError(f"{name} traces at most {MAX_SAMPLE_CHUNK} samples a launch")
    C = tables.hdr_list[HDR_MESH_C]
    mesh = tables.mesh
    if C and (mesh is None or mesh.device != dev or mesh.dtype != torch.float32
              or not mesh.is_contiguous() or mesh.numel() != C * (32 + 21 * _mk.CLUSTER)):
        raise ValueError(f"{name} needs the {C}-cluster mesh tables on {dev}")
    n = tables.n_pix
    if rays is not None:
        if (rays.device != dev or rays.dtype != torch.float32 or rays.dim() != 2
                or rays.shape[0] != 6 or not rays.is_contiguous() or rays.shape[1] < 1):
            raise ValueError(f"{name} needs rays as a contiguous (6, N) float32 tensor on {dev}")
        n = rays.shape[1]
    from tpu_rt_torch.ops import _build

    lib = _build.load_library()
    shape = (n_out, n_samples, n) if per_sample else n_out
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.path_film_launch(
            tables.hdr.data_ptr(), tables.hdr.numel(),
            tables.tab.data_ptr(), tables.tab.numel(),
            mesh.data_ptr() if C else None, mesh.numel() if C else 0,
            None if rays is None else rays.data_ptr(),
            out.data_ptr(), n, _wrap_i32(seed), n_samples,
            tables.radius, mode, int(regen), int(tables.rough_cone), stream)
    if err != 0:
        raise RuntimeError("path_film kernel launch failed: "
                           + lib.path_film_error_string(err).decode())
    return out


def film_records(tables: FilmTables, seed: int, n_samples: int, regen=None):
    """K1's trace kernel: (n_val, n_samples, H*W) sample records,
    ``film_records_plain``'s.  ``regen``: the loop form, as in
    ``film_trace``.  Plain version on a CPU tensor; on a CUDA tensor the
    kernel, or raise.  Launches count in ``film_trace.launches``, those in
    K2's loop also in ``regen_launches``.  K3's records are the first 13
    planes of a ``stokes_sample_trace`` launch."""
    _check_kind(tables, False, "film_records")
    if tables.tab.device.type == "cpu":
        return film_records_plain(tables, seed, n_samples)
    regen = tables.regen if regen is None else bool(regen)
    out = _launch(tables, seed, n_samples, _MODE_FILM, (tables.n_val, n_samples, tables.n_pix),
                  "film_records", regen=regen)
    film_trace.launches += 1
    film_trace.regen_launches += int(regen)
    return out


def film_splat(records, planes, tables: FilmTables, seed: int):
    """film_splat: the (n_val, n, H*W) records of a launch seeded ``seed``
    added in sample order onto the (n_acc + 1, H*W) planes, in place
    (``film_splat_plain``).  Plain version on a CPU tensor; on a CUDA
    tensor ``csrc/path_film.cu``'s splat kernel or raise.
    ``film_splat.launches`` counts launches."""
    if records.device.type == "cpu":
        return film_splat_plain(records, planes, tables, seed)
    from tpu_rt_torch.ops import _build

    dev = records.device
    n_val, n, n_pix = records.shape
    for x in (records, planes):
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"film_splat needs contiguous float32 tensors on {dev}")
    if (tables.tab.device != dev or n_val != tables.n_val or n_pix != tables.n_pix
            or planes.shape != (tables.n_acc + 1, n_pix) or n < 1):
        raise ValueError("film_splat needs records (n_val, n, H*W) and planes (n_acc + 1, H*W) "
                         f"of these tables on {dev}")
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.film_splat_launch(
            records.data_ptr(), tables.tab.data_ptr(), tables.tab.numel(), planes.data_ptr(),
            n_pix, n, n_val - 1, tables.radius, _wrap_i32(seed),
            tables.hdr_list[HDR_TILE_LANES], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("film_splat kernel launch failed: "
                           + lib.path_film_error_string(err).decode())
    film_splat.launches += 1
    return planes


def film_trace(tables: FilmTables, seed: int, n_samples: int, regen=None):
    """Trace ``n_samples`` paths per pixel and accumulate the filter
    splat: returns (n_acc + 1, H*W) float32 planes on the tables' device,
    (r, g, b, w) per filter offset (dy, dx) in row-major order, then the
    ray count.  ``seed`` is an int32 (it wraps); sample i of the call
    draws the stream of seed + i.  ``regen`` picks the loop form (None:
    the tables' auto form, ``HDR_REGEN``): K2's regeneration loop or the
    per-sample depth loop, which give the same planes.

    On a CPU tensor this runs the plain version.  On a CUDA tensor it
    launches ``csrc/path_film.cu`` (built at first use) or raises: the
    trace kernel (``film_records``) and ``film_splat`` on each chunk of at
    most RECORD_CHUNK samples (``split_film``).  ``film_trace.launches``
    counts K1's trace-kernel launches, ``regen_launches`` those in K2's
    loop; ``film_splat.launches`` the splat's."""
    with span("tpu_rt_torch.film_trace"):
        _check_kind(tables, False, "film_trace")
        if tables.tab.device.type == "cpu":
            return film_trace_plain(tables, seed, n_samples)
        return split_film(tables, seed, n_samples,
                          lambda t, s, k: film_records(t, s, k, regen=regen), film_splat)


def stokes_film_trace(tables: FilmTables, seed: int, n_samples: int):
    """K3: ``film_trace`` with full Mueller transport on Stokes tables
    (``pack_tables(..., stokes=True)``): (13 * offsets + 1, H*W) planes,
    per offset the 12 weighted Stokes values and the weight, then the ray
    count.  It has no loop form.  Plain version on a CPU tensor; on a CUDA
    tensor the two kernels (as ``film_trace``), the trace one a
    ``stokes_sample_trace`` launch (one thread a (pixel, sample), counted
    in ``stokes_sample_trace.launches``) whose first 13 planes are the
    records, or raise."""
    with span("tpu_rt_torch.stokes_film_trace"):
        _check_kind(tables, True, "stokes_film_trace")
        if tables.tab.device.type == "cpu":
            return stokes_film_trace_plain(tables, seed, n_samples)
        return split_film(tables, seed, n_samples,
                          lambda t, s, k: stokes_sample_trace(t, s, k)[:t.n_val], film_splat)


def _sample_launch(tables: FilmTables, seed: int, n_samples, mode: int, n_out: int,
                   name: str, rays=None):
    """A per-sample kernel's launch on a chunk of ``n_samples`` samples
    (None: one, as (P, N) planes)."""
    out = _launch(tables, seed, _chunk(n_samples), mode, n_out, name, rays=rays)
    return out[:, 0] if n_samples is None else out


def stokes_sample_trace(tables: FilmTables, seed: int, n_samples=None):
    """K6: one polarized sample per pixel on Stokes tables, (15, H*W)
    planes (``stokes_sample_trace_plain``; ``sample_planes_split`` turns
    them into S, jitter and rays); with an int ``n_samples`` a chunk of
    that many samples in one launch, (15, n, H*W), sample i seeded seed +
    i.  Plain version on a CPU tensor; on a CUDA tensor the kernel or
    raise.  ``stokes_sample_trace.launches`` counts launches, one a chunk,
    K3's trace launches among them."""
    _check_kind(tables, True, "stokes_sample_trace")
    if tables.tab.device.type == "cpu":
        return stokes_sample_trace_plain(tables, seed, n_samples)
    out = _sample_launch(tables, seed, n_samples, _MODE_STOKES_SAMPLE, 15,
                         "stokes_sample_trace")
    stokes_sample_trace.launches += 1
    return out


def raygen_trace(tables: FilmTables, seed: int, n_samples=None):
    """K5: one camera sample per pixel with the jitter drawn in the kernel,
    as (6, H*W) planes (L, the ray count, jx, jy), 12 on a textured
    environment (then the escape direction and throughput):
    ``raygen_trace_plain``'s; with an int ``n_samples`` a chunk, (P, n,
    H*W), sample i seeded seed + i.  Plain version on a CPU tensor; on a
    CUDA tensor the kernel or raise.  ``raygen_trace.launches`` counts
    launches, one a chunk."""
    _check_kind(tables, False, "raygen_trace")
    if tables.tab.device.type == "cpu":
        return raygen_trace_plain(tables, seed, n_samples)
    out = _sample_launch(tables, seed, n_samples, _MODE_RAYGEN_SAMPLE,
                         12 if tables.env_textured else 6, "raygen_trace")
    raygen_trace.launches += 1
    return out


def path_trace(tables: FilmTables, o, d, seed: int, n_samples=None):
    """K4: the bounce loop on the rays o, d ([N, 3] float32 on the tables'
    device; N need not fill a tile), as (4, N) planes (L, the ray count),
    10 on a textured environment: ``path_trace_plain``'s; with an int
    ``n_samples`` a chunk, (P, n, N), sample i of every ray seeded seed +
    i.  The tables' camera is not used.  Plain version on a CPU tensor; on
    a CUDA tensor the kernel or raise.  ``path_trace.launches`` counts
    launches, one a chunk."""
    _check_kind(tables, False, "path_trace")
    dev = tables.tab.device
    if (o.shape != d.shape or o.dim() != 2 or o.shape[1] != 3 or o.device != dev
            or d.device != dev or o.dtype != torch.float32 or d.dtype != torch.float32):
        raise ValueError(f"path_trace needs o, d as [N, 3] float32 tensors on {dev}")
    if dev.type == "cpu":
        return path_trace_plain(tables, o, d, seed, n_samples)
    rays = torch.cat([o.T, d.T]).contiguous()
    out = _sample_launch(tables, seed, n_samples, _MODE_RAYS_SAMPLE,
                         10 if tables.env_textured else 4, "path_trace", rays=rays)
    path_trace.launches += 1
    return out


film_trace.launches = film_trace.regen_launches = film_splat.launches = 0
stokes_sample_trace.launches = raygen_trace.launches = path_trace.launches = 0


def deposit(film, planes, tables: FilmTables):
    """Add one chunk's planes into the (n_val, H, W) film, in place: each
    filter offset (dy, dx) lands on pixel p + (dy, dx)."""
    with span("tpu_rt_torch.deposit"):
        r = tables.radius
        acc = planes[:-1].view(-1, tables.n_val, tables.H, tables.W)
        if r == 0:
            film += acc[0]
            return film
        i = 0
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                _film._shift_add(film, acc[i], dy, dx)
                i += 1
        return film


def film_chunks(tables: FilmTables, trace, chunks):
    """A launch of ``trace`` (tables, seed, n_samples) for each (seed,
    n_samples) of ``chunks``, each deposited into the film.  Returns the
    (n_val, H, W) film and the ray count (0-d int64)."""
    dev = tables.tab.device
    film = torch.zeros((tables.n_val, tables.H, tables.W), dtype=torch.float32, device=dev)
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    for s, n in chunks:
        planes = trace(tables, _wrap_i32(s), n)
        deposit(film, planes, tables)
        n_rays += planes[-1].to(torch.int64).sum()
    return film, n_rays


def _render_chunks(tables: FilmTables, trace, spp, seed, spp_per_pass):
    """``film_chunks`` of ``spp_per_pass``-sample launches (the last what
    is left), sample j seeded seed * 100003 + j."""
    k = max(1, min(spp_per_pass, spp))
    seed0 = _wrap_i32(seed * 100003)
    return film_chunks(tables, trace, [(seed0 + j, min(k, spp - j)) for j in range(0, spp, k)])


def _baked(scene: Scene, baked):
    bs = baked if baked is not None else bake_scene(scene)
    if bs is None:
        raise ValueError("scene is outside the film kernel's scope")
    return bs


def render_film(scene: Scene, spp=None, seed=0, device="cuda", spp_per_pass=64,
                tile_rows=16, baked=None, regen=None):
    """Full render through the film kernel: ``spp_per_pass``-sample chunks,
    each deposited into the film, then developed.  ``regen`` (None: auto
    at max_depth >= 8) picks K2's loop.  Returns the (H, W, 3) image and
    the ray count (a 0-d int64 tensor), both on ``device``."""
    c = scene.camera
    tables = pack_tables(_baked(scene, baked), c, tile_rows, device)
    film, n_rays = _render_chunks(tables, lambda t, s, n: film_trace(t, s, n, regen=regen),
                                  c.spp if spp is None else spp, seed, spp_per_pass)
    img = _film.develop(film[:3].permute(1, 2, 0), film[3])
    return img.contiguous(), n_rays


def sample_film(tables: FilmTables, trace, split, spp, seed0, k, filter_type):
    """The film of a per-sample route: ``trace`` (tables, seed,
    n_samples) launched on chunks of at most ``k`` samples (sample j
    seeded seed0 + j), ``split`` turning a chunk's planes into (values [n,
    H*W, ...], jitter [n, H*W, 2], the rays cast), the samples with a
    non-finite value left out and the rest splatted at their jitter by
    ``sensor/film.py::splat_in_order`` with ``filter_type``, in pieces of
    at most SPLAT_CHUNK samples.  The glue runs once a chunk, and the film
    is bit-equal whatever the chunk and the piece: each element's
    arithmetic is the per-sample loop's, and the samples land on the film
    in order.  Returns (film values [H, W, n_val - 1], film weights [H,
    W], the rays cast as a 0-d int64 tensor)."""
    H, W, dev = tables.H, tables.W, tables.tab.device
    fv = torch.zeros((H, W, tables.n_val - 1), dtype=torch.float32, device=dev)
    fw = torch.zeros((H, W), dtype=torch.float32, device=dev)
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    for j in range(0, spp, k):
        n = min(k, spp - j)
        vals, jitter, rays = split(trace(tables, _wrap_i32(seed0 + j), n))
        vals, jitter = vals.reshape(n, H, W, -1), jitter.reshape(n, H, W, 2)
        for p in range(0, n, SPLAT_CHUNK):
            v = vals[p:p + SPLAT_CHUNK]
            fv, fw = _film.splat_in_order(fv, fw, jitter[p:p + SPLAT_CHUNK], v,
                                          torch.isfinite(v).all(-1), filter_type)
        n_rays += rays
    return fv, fw, n_rays


def render_sample_film(scene: Scene, spp=None, seed=0, device="cuda", spp_per_pass=64,
                       tile_rows=16, baked=None):
    """Full render through the per-sample kernel K5, the route of a scene
    with a textured environment (render_pallas :2600-2612, _get_render_fn
    :2353-2383): ``sample_film`` on K5, ``spp_per_pass`` samples a launch,
    sample j drawing the stream of seed * 100003 + j; each sample's
    radiance gets the environment seen at its path's escape, L + esc_thr *
    eval_env(esc_d) (zero throughput where the path never escaped); then
    developed.  Returns the (H, W, 3) image and the ray count (0-d int64),
    both on ``device``."""
    from tpu_rt_torch.emitter import sample as _em

    bs = _baked(scene, baked)
    c = scene.camera
    tables = pack_tables(bs, c, tile_rows, device)
    lookup = scene.to(device) if bs.env_textured else None

    def split(planes):
        p = planes.movedim(0, -1)  # (n, H*W, P)
        L = p[..., 0:3]
        if lookup is not None:
            L = L + p[..., 9:12] * _em.eval_env(lookup, p[..., 6:9])
        return L, p[..., 4:6], p[..., 3].to(torch.int64).sum()

    fv, fw, n_rays = sample_film(tables, raygen_trace, split, c.spp if spp is None else spp,
                                 _wrap_i32(seed * 100003),
                                 max(1, min(spp_per_pass, MAX_SAMPLE_CHUNK)), c.filter_type)
    return _film.develop(fv, fw), n_rays


def stokes_in_scope(bs: Optional[BakedScene]) -> bool:
    """Scenes the Stokes kernel renders (pallas_path.stokes_in_scope): baked,
    with no textured environment (the Stokes kernels write no escape
    record) and no polarizer (they would pass it as a neutral attenuator;
    its true Mueller transport stays on the wavefront,
    ``integrator/stokes.py``).  A ``null`` BSDF, rough conductors and
    cones are in scope."""
    return (bs is not None and not bs.env_textured
            and not any(bt == BSDF_POLARIZER for bt, _ in bs.bsdfs))


def render_stokes_film(scene: Scene, spp=None, seed=0, device="cuda", spp_per_pass=64,
                       tile_rows=16, baked=None):
    """Full polarized render through K3 (``render_stokes_pallas``): the
    film render of ``render_film`` with 13 planes per filter offset, then
    S = film / weight.  Returns the (H, W, 4, 3) Stokes image (I, Q, U, V
    by rgb) and the ray count (0-d int64), both on ``device``.  Every
    filter the loader makes (box, tent, gaussian) has a film footprint, so
    this route needs no splat of K6's own."""
    bs = _baked(scene, baked)
    if not stokes_in_scope(bs):
        raise ValueError("scene is outside the Stokes kernel's scope")
    c = scene.camera
    spp = c.spp if spp is None else spp
    tables = pack_tables(bs, c, tile_rows, device, stokes=True)
    film, n_rays = _render_chunks(tables, stokes_film_trace, spp, seed, spp_per_pass)
    S = _film.develop(film[:12].permute(1, 2, 0), film[12])
    return S.reshape(c.height, c.width, 4, 3).contiguous(), n_rays

