"""Scene intersection for the wavefront tracer: closest hit, shadow test
and the surface interaction.

Counterpart of ``tpu_rt/geometry/trace.py``.  Two routes, chosen from the
scene:

* at most 192 prims: every prim at once, an (N, P) sweep and an argmin
  (``_trace_bruteforce``; of equal distances the first prim wins, as
  ``jnp.argmin`` and ``torch.argmin`` both keep the first);
* a scene with mesh cluster tables (more than 192 triangles): the
  clustered mesh-intersect kernel K7 over all clusters
  (``ops/mesh_kernel.py::mesh_intersect``), the analytic prims merged in
  with the wide sweep, the kernel's best t as their tmax
  (``_trace_mesh``, tpu_rt's ``_trace_mesh_pallas``).

tpu_rt's other two routes, for more than 192 prims without cluster
tables (``_trace_chunked`` and ``_trace_bvh``), are not ported yet: such a
scene raises ``NotImplementedError`` naming ROADMAP.md A4.  Its coherence
sort (``gi_sort_order``) was a measured dead end on the TPU and is not
ported.

Misses report t = INF (1e8, finite: see ``geometry/intersect.py``); the
search range is clamped below 0.99 * INF so a caller's tmax of +inf never
turns the sentinel into a hit.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from tpu_rt_torch.core.math import cross, normalize, transform_point, vec3
from tpu_rt_torch.geometry import intersect as isect
from tpu_rt_torch.scene.types import CONE, CURVE, CYLINDER, DISK, RECTANGLE, SPHERE

INF = isect.INF
BRUTE_FORCE_MAX_PRIMS = 192
RAY_EPS = 1e-4


@dataclass
class Hit:
    t: torch.Tensor  # [N]
    prim: torch.Tensor  # [N] global prim id, -1 on a miss
    u: torch.Tensor  # [N]
    v: torch.Tensor  # [N]

    @property
    def valid(self):
        return self.prim >= 0


@dataclass
class Interaction:
    """A surface interaction per lane (mi.SurfaceInteraction3f)."""

    valid: torch.Tensor  # [N] bool
    t: torch.Tensor  # [N]
    p: torch.Tensor  # [N, 3]
    n: torch.Tensor  # [N, 3] shading normal
    ng: torch.Tensor  # [N, 3] geometric normal
    uv: torch.Tensor  # [N, 2]
    wi: torch.Tensor  # [N, 3] world direction toward the ray origin
    shape: torch.Tensor  # [N] shape id, -1 on a miss
    prim: torch.Tensor  # [N]

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def spawn_origin(self, direction):
        """The hit point offset along the geometric normal toward
        ``direction``, by RAY_EPS times max(1, max |p|)."""
        sign = torch.sign((self.ng * direction).sum(-1, keepdim=True))
        scale = torch.clamp(torch.abs(self.p).amax(-1, keepdim=True), min=1.0)
        return self.p + self.ng * sign * RAY_EPS * scale


_INTERSECTORS = {
    SPHERE: isect.ray_sphere,
    RECTANGLE: isect.ray_rectangle,
    DISK: isect.ray_disk,
    CYLINDER: isect.ray_cylinder,
    CONE: isect.ray_cone,
}


def _analytic_sweep(geom, atype, params, oo, od, tmin, tmax):
    """The intersectors of the analytic types present, selected per prim
    by ``atype``; ``params`` broadcasts like ``atype`` with a trailing (2,)
    axis (a curve's r0, r1)."""
    present = geom.analytic_types or tuple(_INTERSECTORS)
    t = torch.full(torch.broadcast_shapes(atype.shape, oo.shape[:-1]), INF,
                   dtype=torch.float32, device=oo.device)
    u = torch.zeros_like(t)
    v = torch.zeros_like(t)
    for code in present:
        if code == CURVE:
            t_i, u_i, v_i = isect.ray_roundcone(oo, od, params[..., 0], params[..., 1],
                                                tmin, tmax)
        else:
            t_i, u_i, v_i = _INTERSECTORS[code](oo, od, tmin, tmax)
        m = atype == code
        t = torch.where(m, t_i, t)
        u = torch.where(m, u_i, u)
        v = torch.where(m, v_i, v)
    return t, u, v


def _analytic_all(geom, o, d, tmin_b, tmax_b):
    """Every analytic prim against every ray (o, d [N, 3]): (t, u, v),
    each [N, A]."""
    rot = geom.an_to_object[:, :3, :3]
    trans = geom.an_to_object[:, :3, 3]
    o_f = o.reshape(-1, 1, 1, 3)
    d_f = d.reshape(-1, 1, 1, 3)
    oo = (rot[None] * o_f).sum(-1) + trans[None]
    od = (rot[None] * d_f).sum(-1)
    return _analytic_sweep(geom, geom.an_type[None, :], geom.an_param[None], oo, od,
                           tmin_b, tmax_b)


def _per_ray(x, n, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device).expand(n).reshape(-1, 1)


def _trace_bruteforce(geom, o, d, tmin, tmax) -> Hit:
    """All prims at once: one (N, P) intersection and an argmin."""
    n = o.shape[0]
    tmin_b = _per_ray(tmin, n, o.device)
    tmax_b = torch.clamp(_per_ray(tmax, n, o.device), max=0.99 * INF)
    ts, us, vs = [], [], []
    if geom.n_tris > 0:
        t, u, v = isect.ray_triangle(o[:, None, :], d[:, None, :], geom.tri_p0[None],
                                     geom.tri_e1[None], geom.tri_e2[None], tmin_b, tmax_b)
        ts.append(t)
        us.append(u)
        vs.append(v)
    if geom.n_analytic > 0:
        t, u, v = _analytic_all(geom, o, d, tmin_b, tmax_b)
        ts.append(t)
        us.append(u)
        vs.append(v)
    t_all = torch.cat(ts, 1)
    best = torch.argmin(t_all, 1)[:, None]
    best_t = torch.gather(t_all, 1, best)[:, 0]
    hit = best_t < tmax_b[:, 0]
    return Hit(t=torch.where(hit, best_t, INF),
               prim=torch.where(hit, best[:, 0].to(torch.int32), -1),
               u=torch.gather(torch.cat(us, 1), 1, best)[:, 0],
               v=torch.gather(torch.cat(vs, 1), 1, best)[:, 0])


def mesh_clusters(geom):
    """The geometry's cluster tables as ``mesh_intersect`` takes them."""
    return {"bounds": geom.cl_bounds, "trisw": geom.cl_trisw, "prim": geom.cl_prim,
            "tree": geom.cl_tree}


def _trace_mesh(geom, o, d, tmin, tmax) -> Hit:
    """Triangles through K7; analytic prims merged in with the wide sweep
    against the kernel's best t."""
    from tpu_rt_torch.ops import mesh_kernel

    n = o.shape[0]
    tmax_b = torch.clamp(_per_ray(tmax, n, o.device)[:, 0], max=0.99 * INF)
    best_t, best_prim, best_u, best_v = mesh_kernel.mesh_intersect(
        mesh_clusters(geom), o, d, tmin=float(tmin), tmax=tmax_b)
    if geom.n_analytic > 0:
        t_a, u_a, v_a = _analytic_all(geom, o, d, _per_ray(tmin, n, o.device), best_t[:, None])
        ai = torch.argmin(t_a, 1)[:, None]
        t_c = torch.gather(t_a, 1, ai)[:, 0]
        closer = t_c < best_t
        best_prim = torch.where(closer, geom.n_tris + ai[:, 0].to(torch.int32), best_prim)
        best_t = torch.where(closer, t_c, best_t)
        best_u = torch.where(closer, torch.gather(u_a, 1, ai)[:, 0], best_u)
        best_v = torch.where(closer, torch.gather(v_a, 1, ai)[:, 0], best_v)
    hit = best_prim >= 0
    return Hit(t=torch.where(hit, best_t, INF), prim=best_prim, u=best_u, v=best_v)


def ray_intersect_hit(geom, o, d, tmin=RAY_EPS, tmax=INF) -> Hit:
    """Closest hit of rays o, d [N, 3] within (tmin, tmax), tmax a scalar
    or [N]."""
    if geom.n_tris + geom.n_analytic <= BRUTE_FORCE_MAX_PRIMS:
        return _trace_bruteforce(geom, o, d, tmin, tmax)
    if geom.cl_trisw is not None:
        return _trace_mesh(geom, o, d, tmin, tmax)
    raise NotImplementedError(
        "scenes of more than 192 prims without mesh cluster tables (tpu_rt's "
        "_trace_chunked / _trace_bvh routes) are not ported yet (ROADMAP.md A4)")


def ray_test(geom, o, d, tmin=RAY_EPS, tmax=INF):
    """Shadow query: True where something is hit in (tmin, tmax)."""
    return ray_intersect_hit(geom, o, d, tmin, tmax).valid


def compute_interaction(scene, o, d, hit: Hit) -> Interaction:
    """The surface interaction at each hit: the point, the geometric
    normal, the shading normal (interpolated vertex normals, the geometric
    one where those are ~0; the analytic shapes' own), uv and shape."""
    geom = scene.geometry
    T = geom.n_tris
    valid = hit.valid
    pid = torch.clamp(hit.prim, min=0).to(torch.int64)
    t = torch.where(valid, hit.t, INF)
    p = o + torch.where(valid, hit.t, 0.0)[..., None] * d

    if T > 0:
        tid = torch.clamp(pid, 0, T - 1)
        e1, e2 = geom.tri_e1[tid], geom.tri_e2[tid]
        ng_t = normalize(cross(e1, e2))
        w = (1.0 - hit.u - hit.v)[..., None]
        ns_t = (w * geom.tri_n0[tid] + hit.u[..., None] * geom.tri_n1[tid]
                + hit.v[..., None] * geom.tri_n2[tid])
        ns_len = torch.sqrt(torch.clamp((ns_t * ns_t).sum(-1, keepdim=True), min=1e-24))
        ns_t = torch.where(ns_len > 1e-6, ns_t / ns_len, ng_t)
        uv_t = (w * geom.tri_uv0[tid] + hit.u[..., None] * geom.tri_uv1[tid]
                + hit.v[..., None] * geom.tri_uv2[tid])
        shape_t = geom.tri_shape[tid]
    if geom.n_analytic > 0:
        aid = torch.clamp(pid - T, 0, geom.n_analytic - 1)
        m_obj = geom.an_to_object[aid]
        p_obj = transform_point(m_obj, p)
        atype = geom.an_type[aid]
        # a curve's normal points from the centre of its sphere at the
        # clamped tangency parameter s*
        par = geom.an_param[aid]
        crv_dr = par[..., 1] - par[..., 0]
        crv_s = torch.clamp((p_obj[..., 2] + par[..., 0] * crv_dr)
                            / torch.clamp(1.0 - crv_dr * crv_dr, min=1e-6), 0.0, 1.0)
        zeros = torch.zeros_like(p_obj[..., 0])
        n_obj = torch.where(
            (atype == SPHERE)[..., None], p_obj,
            torch.where(
                (atype == CYLINDER)[..., None], vec3(p_obj[..., 0], p_obj[..., 1], zeros),
                torch.where(
                    (atype == CONE)[..., None],
                    vec3(p_obj[..., 0], p_obj[..., 1], 1.0 - p_obj[..., 2]),
                    torch.where((atype == CURVE)[..., None],
                                vec3(p_obj[..., 0], p_obj[..., 1], p_obj[..., 2] - crv_s),
                                vec3(zeros, zeros, zeros + 1.0)))))
        # normals transform by the transpose of to_object
        r3 = m_obj[..., :3, :3]
        ng_a = normalize(vec3(
            r3[..., 0, 0] * n_obj[..., 0] + r3[..., 1, 0] * n_obj[..., 1]
            + r3[..., 2, 0] * n_obj[..., 2],
            r3[..., 0, 1] * n_obj[..., 0] + r3[..., 1, 1] * n_obj[..., 1]
            + r3[..., 2, 1] * n_obj[..., 2],
            r3[..., 0, 2] * n_obj[..., 0] + r3[..., 1, 2] * n_obj[..., 1]
            + r3[..., 2, 2] * n_obj[..., 2]))
        # a sphere's uv from its spherical angles; the others' from the hit
        p_obj_len = torch.sqrt(torch.clamp((p_obj * p_obj).sum(-1), min=1e-24))
        theta = torch.arccos(torch.clamp(p_obj[..., 2] / p_obj_len, -0.999999, 0.999999))
        phi = torch.atan2(p_obj[..., 1], p_obj[..., 0])
        uv_sph = torch.stack([phi / (2.0 * math.pi) + 0.5, theta / math.pi], -1)
        uv_a = torch.where((atype == SPHERE)[..., None], uv_sph,
                           torch.stack([hit.u, hit.v], -1))
        shape_a = geom.an_shape[aid]

    if T > 0 and geom.n_analytic > 0:
        is_tri = (pid < T)[..., None]
        ng = torch.where(is_tri, ng_t, ng_a)
        ns = torch.where(is_tri, ns_t, ng_a)
        uv = torch.where(is_tri, uv_t, uv_a)
        shape = torch.where(pid < T, shape_t, shape_a)
    elif T > 0:
        ng, ns, uv, shape = ng_t, ns_t, uv_t, shape_t
    else:
        ng, ns, uv, shape = ng_a, ng_a, uv_a, shape_a

    return Interaction(valid=valid, t=t, p=p, n=ns, ng=ng, uv=uv, wi=-d,
                       shape=torch.where(valid, shape, -1),
                       prim=torch.where(valid, hit.prim, -1))


def ray_intersect(scene, o, d, tmin=RAY_EPS, tmax=INF) -> Interaction:
    return compute_interaction(scene, o, d, ray_intersect_hit(scene.geometry, o, d, tmin, tmax))
