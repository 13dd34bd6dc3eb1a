"""Scene representation: dataclasses of tensors.

Counterpart of ``tpu_rt/scene/types.py``.  Every enum keeps the integer
value it has there, so tables built by either package mean the same
thing.  The JAX package keeps static fields out of the pytree; here a
dataclass simply holds tensors beside plain Python ints and flags.

Carried: world-space triangles with their vertex normals and uvs,
analytic shape transforms and parameters, the BVH's prim order, node
boxes and links, the mesh cluster tables, per-shape BSDF/emitter ids, the BSDF
table and the set of BSDF types present, the emitter tables (with the
environment's frame and sampling CDFs), the camera and the ultrasound
configuration, each shape's to_world (the polarizer's axis frame), and
the bitmap textures bound to BSDF reflectances (one padded atlas).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch

# Shape type enums (analytic primitives)
SPHERE = 0
RECTANGLE = 1
DISK = 2
CYLINDER = 3
CONE = 4
CURVE = 5

# BSDF type enums; bsdf_params[:, 16] layout as in tpu_rt/scene/types.py:
#   DIFFUSE [0:3] reflectance; DIELECTRIC [0] int_ior, [1] ext_ior,
#   [3:6] specular_reflectance, [6:9] specular_transmittance;
#   CONDUCTOR / ROUGH_CONDUCTOR [0:3] eta ([0] = -1 marks a perfect
#   mirror), [3:6] k, [6:9] specular_reflectance, [9] alpha;
#   POLARIZER [0] theta (degrees), [3:6] transmittance.
BSDF_DIFFUSE = 0
BSDF_DIELECTRIC = 1
BSDF_CONDUCTOR = 2
BSDF_ROUGH_CONDUCTOR = 3
BSDF_POLARIZER = 4
BSDF_ULTRASOUND = 5
BSDF_NULL = 6

# Reconstruction filter enums
FILTER_BOX = 0
FILTER_TENT = 1
FILTER_GAUSSIAN = 2

# Integrator kind enums
INTEGRATOR_PATH = 0
INTEGRATOR_DIRECT = 1
INTEGRATOR_STOKES = 2
INTEGRATOR_ULTRASOUND = 3
INTEGRATOR_DIRECT_PROJECTIVE = 4


class _Replace:
    def replace(self, **changes):
        """Copy with some fields changed (flax.struct's ``replace``)."""
        return dataclasses.replace(self, **changes)

    def _map(self, fn):
        changes = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, _Replace)):
                changes[f.name] = fn(v)
        return dataclasses.replace(self, **changes)

    def to(self, device):
        """Copy with every tensor, nested ones included, on ``device``."""
        return self._map(lambda v: v.to(device))

    def detach(self):
        """Copy with every tensor, nested ones included, detached from
        autograd (the values a kernel's tables are baked from)."""
        return self._map(lambda v: v.detach())


def grad_tensors(obj, prefix=()):
    """Every tensor of a scene (or of a part of one), nested ones included,
    that requires grad, as (path, tensor): a path is the tuple of field
    names that leads to it, such as ("ultrasound", "pitch").  An empty list
    when autograd is off (``torch.no_grad``)."""
    if not torch.is_grad_enabled():
        return []
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, _Replace):
            out += grad_tensors(v, prefix + (f.name,))
        elif isinstance(v, torch.Tensor) and v.requires_grad:
            out.append((prefix + (f.name,), v))
    return out


def with_tensors(obj, items):
    """Copy of ``obj`` with the tensor at each path of ``items`` (pairs of
    path and tensor) replaced."""
    top, nested = {}, {}
    for path, t in items:
        if len(path) == 1:
            top[path[0]] = t
        else:
            nested.setdefault(path[0], []).append((path[1:], t))
    for name, sub in nested.items():
        top[name] = with_tensors(getattr(obj, name), sub)
    return dataclasses.replace(obj, **top)


@dataclass(frozen=True)
class Geometry(_Replace):
    """Prim ids [0, n_tris) are triangles, [n_tris, n_tris + n_analytic)
    the analytic shapes."""

    tri_p0: torch.Tensor  # [T, 3] world space
    tri_e1: torch.Tensor  # [T, 3] p1 - p0
    tri_e2: torch.Tensor  # [T, 3] p2 - p0
    tri_n0: torch.Tensor  # [T, 3] world vertex normals; zeros where the
    tri_n1: torch.Tensor  # mesh has none (or face_normals is set)
    tri_n2: torch.Tensor
    tri_uv0: torch.Tensor  # [T, 2] vertex uvs; zeros where the mesh has none
    tri_uv1: torch.Tensor
    tri_uv2: torch.Tensor
    tri_shape: torch.Tensor  # [T] owning shape id
    an_type: torch.Tensor  # [A] SPHERE / RECTANGLE / ...
    an_to_world: torch.Tensor  # [A, 4, 4]
    an_to_object: torch.Tensor  # [A, 4, 4]
    an_shape: torch.Tensor  # [A]
    an_param: torch.Tensor  # [A, 2] per-prim parameters (curve radii), else 0
    # BVH over all prim ids (geometry/bvh.py): node boxes; internal nodes
    # link children (a, b) with count 0; leaves hold (first, _, count) over
    # prim_order
    bvh_min: torch.Tensor  # [M, 3]
    bvh_max: torch.Tensor  # [M, 3]
    bvh_a: torch.Tensor  # [M]
    bvh_b: torch.Tensor  # [M]
    bvh_count: torch.Tensor  # [M]
    prim_order: torch.Tensor  # [T + A]
    n_tris: int = 0
    n_analytic: int = 0
    analytic_types: tuple = ()  # the analytic type codes present
    # Mesh cluster tables (ops/mesh_kernel.py::build_clusters), built when
    # the scene has more than 192 triangles, else None
    cl_tris: Optional[torch.Tensor] = None  # [C, 9, 128] p0, e1, e2
    cl_bounds: Optional[torch.Tensor] = None  # [C, 32]
    cl_prim: Optional[torch.Tensor] = None  # [C * 128] global triangle ids
    cl_trisw: Optional[torch.Tensor] = None  # [C, 12, 128] Baldwin-Weber rows
    cl_tree: Optional[torch.Tensor] = None  # [2 + nodes, 8] the cull hierarchy over them


@dataclass(frozen=True)
class Emitters(_Replace):
    """NEE tables: area emitters (one per emissive shape, its triangles
    grouped by ``em_offsets``), point lights, and the environment."""

    area_radiance: torch.Tensor  # [Ea, 3]
    area_total: torch.Tensor  # [Ea] total surface area
    em_offsets: torch.Tensor  # [Ea + 1]
    em_tri_prim: torch.Tensor  # [ET] global prim id
    em_tri_cdf: torch.Tensor  # [ET] per-emitter area CDF
    point_pos: torch.Tensor  # [Ep, 3]
    point_intensity: torch.Tensor  # [Ep, 3]
    env_map: torch.Tensor  # [h, w, 3]; (1, 1, 3) for a constant environment
    env_to_world: torch.Tensor  # [4, 4]
    env_to_local: torch.Tensor  # [4, 4]
    env_cdf_rows: torch.Tensor  # [h] marginal CDF over rows (luminance * sin theta)
    env_cdf_cols: torch.Tensor  # [h, w] conditional CDF within each row
    env_scale: torch.Tensor  # [] radiance scale
    n_area: int = 0
    n_point: int = 0
    has_env: bool = False

    @property
    def n_lights(self) -> int:
        """Light units NEE selects among uniformly: area emitters, point
        lights and the environment."""
        return self.n_area + self.n_point + (1 if self.has_env else 0)


@dataclass(frozen=True)
class Camera(_Replace):
    to_world: torch.Tensor  # [4, 4]
    tan_fov_x: torch.Tensor  # [] tan(fov_x / 2)
    tan_fov_y: torch.Tensor
    near: torch.Tensor
    far: torch.Tensor
    width: int = 256
    height: int = 256
    filter_type: int = FILTER_BOX
    spp: int = 16
    pixel_format: str = "rgb"  # hdrfilm pixel_format: "rgb" or "luminance"


@dataclass(frozen=True)
class UltrasoundConfig(_Replace):
    """Transducer + acquisition configuration, with the fields and defaults
    of ``tpu_rt.scene.types.UltrasoundConfig``: the integrator's props, the
    sensor's, and the transducer emitter's.  Tensors are float32 scalars
    except ``angles`` [n_angles] (degrees) and ``sensor_to_world`` [4, 4]."""

    # Integrator props
    frequency: torch.Tensor  # default 5e6
    sound_speed: torch.Tensor  # 1540
    attenuation: torch.Tensor  # 0.5
    main_beam_angle: torch.Tensor  # 10 deg
    cutoff_angle: torch.Tensor  # 20 deg
    sampling_rate: torch.Tensor  # 50e6
    pitch: torch.Tensor  # 0.00035
    angles: torch.Tensor  # [n_angles] plane-wave steering angles, degrees

    # Sensor props
    sensor_to_world: torch.Tensor  # [4, 4]
    elements_width: torch.Tensor  # 0.003
    elements_height: torch.Tensor  # 0.01
    radius: torch.Tensor  # inf => linear array
    directivity: torch.Tensor  # 1.0

    max_depth: int = 2
    wave_cycles: int = 5
    n_elements: int = 128
    time_samples: int = 3000
    n_angles: int = 25
    num_elements_lateral: int = 128
    # Emitter props
    number_of_rays_per_element: int = 1
    opening_angle: float = 0.0
    steering_angle_min: float = -10.0
    steering_angle_max: float = 10.0
    # Hard path-length cutoff
    max_path_length: float = 0.2


@dataclass(frozen=True)
class Scene(_Replace):
    geometry: Geometry
    emitters: Emitters
    shape_bsdf: torch.Tensor  # [N] bsdf index per shape
    shape_emitter: torch.Tensor  # [N] area-emitter index or -1
    bsdf_type: torch.Tensor  # [B]
    bsdf_params: torch.Tensor  # [B, 16]
    camera: Optional[Camera] = None
    ultrasound: Optional[UltrasoundConfig] = None
    # [N, 4, 4] each shape's to_world as written (a sphere's with its
    # centre and radius): the polarizer's transmission axis is its local
    # (sin theta, cos theta, 0) through this transform; None when the
    # caller carried no such array
    shape_to_world: Optional[torch.Tensor] = None
    # bitmap textures bound to BSDF reflectances (bsdf/texture.py): one
    # padded atlas, the true sizes, and per BSDF row its texture (-1: the
    # constant in bsdf_params, which for a textured row is the texture's
    # mean); None where the scene has no texture
    tex_data: Optional[torch.Tensor] = None  # [K, Hm, Wm, 3] float32
    tex_hw: Optional[torch.Tensor] = None  # [K, 2] float32 (h, w)
    bsdf_tex: Optional[torch.Tensor] = None  # [B] int32
    # the BSDF type codes that occur in the scene: the wavefront's BSDF
    # dispatch evaluates only their lobes
    bsdf_types_present: tuple = ()
    # any bitmap texture: gates the wavefront's texture lookup, and keeps
    # the scene out of the film and direct kernels' scope
    has_textures: bool = False
    integrator: int = INTEGRATOR_PATH
    max_depth: int = -1
    rr_depth: int = 5
    hide_emitters: bool = False
    # the scene description's names, as tpu_rt keeps them: "shapes" (name
    # -> shape id), "bsdfs" (name -> BSDF row) and "shape_bsdf" (a list);
    # opt/inverse.py addresses parameters through them
    ids: Any = None
