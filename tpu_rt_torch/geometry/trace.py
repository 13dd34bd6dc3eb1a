"""Scene intersection for the wavefront tracers: closest hit, shadow test
and the surface interaction.

Counterpart of ``tpu_rt/geometry/trace.py``, with its four routes, chosen
from the scene as ``tpu_rt/geometry/trace.py:501-514`` chooses them:

* at most 192 prims: every prim at once, an (N, P) sweep and an argmin
  (``_trace_bruteforce``; of equal distances the first prim wins, as
  ``jnp.argmin`` and ``torch.argmin`` both keep the first);
* a scene with mesh cluster tables (more than 192 triangles): the
  clustered mesh-intersect kernel K7 over all clusters
  (``ops/mesh_kernel.py::mesh_intersect``), the analytic prims merged in
  with the wide sweep, the kernel's best t as their tmax
  (``_trace_mesh``, tpu_rt's ``_trace_mesh_pallas``);
* at most 8 192 prims otherwise: triangles in chunks of 512 through a
  component-form Moller-Trumbore carrying the running best, then the
  analytic prims, also in chunks of 512, against that best t
  (``_trace_chunked``);
* more: the BVH (``_trace_bvh``), a stack of 48 nodes a ray, walked for
  every ray at once until every stack is empty: pop, slab test against the
  running best, a leaf's 4 prims, else push both children.

Every route takes, of equal distances, the prim its sweep meets first
(strict ``<`` against the running best).  Under autograd the brute-force
and chunked sweeps keep t differentiable, as tpu_rt's XLA sweeps do; K7
and the BVH walk return it detached (tpu_rt's mesh kernel's VJP returns
no cotangent), so there a gradient reaches the hit point through
p = o + t d alone.  tpu_rt's coherence sort
(``gi_sort_order``) was a measured dead end on the TPU and is not ported.

Misses report t = INF (1e8, finite: see ``geometry/intersect.py``); the
search range is clamped below 0.99 * INF so a caller's tmax of +inf never
turns the sentinel into a hit.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from tpu_rt_torch.core.math import cross, normalize, transform_point, transform_vector, vec3
from tpu_rt_torch.geometry import intersect as isect
from tpu_rt_torch.scene.types import CONE, CURVE, CYLINDER, DISK, RECTANGLE, SPHERE
from tpu_rt_torch.utils.memo import per_object

INF = isect.INF
BRUTE_FORCE_MAX_PRIMS = 192
CHUNKED_MAX_PRIMS = 8192
CHUNK = 512
STACK_DEPTH = 48
LEAF_SIZE = 4
STEPS_PER_CHECK = 8  # BVH steps between the host's checks for a ray still walking
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


def _analytic_all(geom, o, d, tmin_b, tmax_b, prims=slice(None)):
    """The analytic prims ``prims`` (all by default) against every ray (o,
    d [N, 3]): (t, u, v), each [N, A].  The rays go to object space as
    explicit multiply-adds (tpu_rt's sum over the row, in the same order),
    so every route computes a prim's t with the same operations."""
    m = geom.an_to_object[prims]
    o1, d1 = o[:, None, :], d[:, None, :]
    return _analytic_sweep(geom, geom.an_type[None, prims], geom.an_param[None, prims],
                           transform_point(m, o1), transform_vector(m, d1), tmin_b, tmax_b)


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


def _take(x, idx):
    """x[i, idx[i]] for x, idx [N, K]."""
    return torch.gather(x, 1, idx[:, None])[:, 0]


def _merge(best, t, u, v, ids):
    """Fold a sweep's (t, u, v) [N, K] into the running best (t, prim, u,
    v): its closest (the first of equal ones, as argmin keeps it) where
    strictly closer.  ``ids`` is the sweep's first prim id, or its prim
    ids [N, K]."""
    ci = torch.argmin(t, 1)
    t_c = _take(t, ci)
    closer = t_c < best[0]
    prim = _take(ids, ci) if torch.is_tensor(ids) else ids + ci.to(torch.int32)
    return (torch.where(closer, t_c, best[0]), torch.where(closer, prim, best[1]),
            torch.where(closer, _take(u, ci), best[2]), torch.where(closer, _take(v, ci), best[3]))


def _trace_mesh(geom, o, d, tmin, tmax) -> Hit:
    """Triangles through K7; analytic prims merged in with the wide sweep
    against the kernel's best t."""
    from tpu_rt_torch.ops import mesh_kernel

    n = o.shape[0]
    tmax_b = torch.clamp(_per_ray(tmax, n, o.device)[:, 0], max=0.99 * INF)
    best = mesh_kernel.mesh_intersect(mesh_clusters(geom), o.contiguous(), d.contiguous(),
                                      tmin=float(tmin), tmax=tmax_b)
    if geom.n_analytic > 0:
        best = _merge(best, *_analytic_all(geom, o, d, _per_ray(tmin, n, o.device),
                                           best[0][:, None]), geom.n_tris)
    best_t, best_prim, best_u, best_v = best
    hit = best_prim >= 0
    return Hit(t=torch.where(hit, best_t, INF), prim=best_prim, u=best_u, v=best_v)


def _trace_chunked(geom, o, d, tmin, tmax) -> Hit:
    """Triangles in chunks of CHUNK, a component-form Moller-Trumbore over
    (N, CHUNK) carrying the running best, then the analytic prims in
    chunks of CHUNK against the triangles' best t; a chunk's winner
    replaces the best only when strictly closer, so of equal distances the
    lowest prim id wins, as tpu_rt's one wide analytic argmin picks it."""
    n = o.shape[0]
    tmin_b = _per_ray(tmin, n, o.device)
    best_t = torch.clamp(_per_ray(tmax, n, o.device)[:, 0], max=0.99 * INF)
    zeros = torch.zeros_like(best_t)
    best = (best_t, torch.full((n,), -1, dtype=torch.int32, device=o.device), zeros, zeros)

    T = geom.n_tris
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    for base in range(0, T, CHUNK):
        p0, e1, e2 = (x[base:base + CHUNK].T for x in (geom.tri_p0, geom.tri_e1, geom.tri_e2))
        e1x, e1y, e1z = e1[0], e1[1], e1[2]
        e2x, e2y, e2z = e2[0], e2[1], e2[2]
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        inv = 1.0 / isect._clamp_abs(det, 1e-9)
        tvx, tvy, tvz = ox - p0[0], oy - p0[1], oz - p0[2]
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        v = (dx * qvx + dy * qvy + dz * qvz) * inv
        t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
        ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin_b)
              & (t < best[0][:, None]))
        best = _merge(best, torch.where(ok, t, INF), u, v, base)

    tri_t = best[0][:, None]
    for a0 in range(0, geom.n_analytic, CHUNK):
        best = _merge(best, *_analytic_all(geom, o, d, tmin_b, tri_t, slice(a0, a0 + CHUNK)),
                      T + a0)

    best_t, best_prim, best_u, best_v = best
    hit = best_prim >= 0
    return Hit(t=torch.where(hit, best_t, INF), prim=best_prim, u=best_u, v=best_v)


def _intersect_analytic(geom, aid, o, d, tmin, tmax):
    """Rays against analytic prim ``aid`` (broadcasting with the rays'
    leading axes)."""
    m = geom.an_to_object[aid]
    # the direction is not normalized: t keeps its world meaning
    return _analytic_sweep(geom, geom.an_type[aid], geom.an_param[aid],
                           transform_point(m, o), transform_vector(m, d), tmin, tmax)


def _intersect_prim(geom, pid, o, d, tmin, tmax):
    """Rays against global prim ``pid`` (int64, broadcasting): (t, u, v)."""
    T, A = geom.n_tris, geom.n_analytic
    if T == 0:
        return _intersect_analytic(geom, pid, o, d, tmin, tmax)
    tid = torch.clamp(pid, 0, T - 1)
    tri = isect.ray_triangle(o, d, geom.tri_p0[tid], geom.tri_e1[tid], geom.tri_e2[tid],
                             tmin, tmax)
    if A == 0:
        return tri
    an = _intersect_analytic(geom, torch.clamp(pid - T, 0, A - 1), o, d, tmin, tmax)
    is_tri = pid < T
    return tuple(torch.where(is_tri, x, y) for x, y in zip(tri, an))


def _bvh_tables(geom):
    """The BVH's tables as a step reads them: the node boxes side by side
    (one gather a step for both corners), the links and the prim order
    (int64)."""
    return dict(boxes=torch.cat([geom.bvh_min, geom.bvh_max], 1),
                links=torch.stack([geom.bvh_a, geom.bvh_b, geom.bvh_count], 1).to(torch.int64),
                order=geom.prim_order.to(torch.int64))


def _bvh_state(n, device):
    """A walk's state for n rays: the rays, each ray's stack (with a column
    past its end, which takes the pushes that JAX drops), stack pointer
    and running best."""
    def f(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return dict(o=f(n, 3), d=f(n, 3), inv_d=f(n, 3), tmin=f(n), best_t=f(n), best_u=f(n),
                best_v=f(n), best_prim=torch.full((n,), -1, dtype=torch.int64, device=device),
                stack=torch.zeros((n, STACK_DEPTH + 1), dtype=torch.int64, device=device),
                sp=torch.ones((n,), dtype=torch.int64, device=device))


def _bvh_start(s, o, d, tmin_b, tmax_b):
    """Every ray at the root with its best t at its tmax."""
    s["o"].copy_(o)
    s["d"].copy_(d)
    s["inv_d"].copy_(1.0 / isect._clamp_abs(d, 1e-12))
    s["tmin"].copy_(tmin_b)
    s["best_t"].copy_(tmax_b)
    s["best_prim"].fill_(-1)
    s["best_u"].zero_()
    s["best_v"].zero_()
    s["stack"].zero_()
    s["sp"].fill_(1)


def _bvh_steps(geom, tab, s, k):
    """k steps of every ray's walk, in place on the state ``s``: pop the
    top node, test its box against the running best, intersect a leaf's
    prims, push an internal node's children (b on top).  A ray whose stack
    is empty changes nothing."""
    n = s["sp"].shape[0]
    rows = torch.arange(n, device=s["sp"].device)
    slots = torch.arange(LEAF_SIZE, device=s["sp"].device)
    o, d, tmin = s["o"], s["d"], s["tmin"]
    o4, d4, tmin4 = o[:, None, :], d[:, None, :], tmin[:, None]
    stack, n_order = s["stack"], tab["order"].shape[0]
    for _ in range(k):
        sp, best_t = s["sp"], s["best_t"]
        live = sp > 0
        node = stack[rows, torch.clamp(sp - 1, 0, STACK_DEPTH - 1)]
        sp = sp - live.to(torch.int64)
        bb = tab["boxes"][node]
        box, _ = isect.ray_aabb(o, s["inv_d"], bb[:, :3], bb[:, 3:], tmin, best_t)
        box = box & live
        a, b, count = tab["links"][node].unbind(1)

        pid = tab["order"][torch.clamp(a[:, None] + slots, 0, n_order - 1)]
        t, u, v = _intersect_prim(geom, pid, o4, d4, tmin4, best_t[:, None])
        take = (box & (count > 0))[:, None] & (slots < count[:, None]) & (t < best_t[:, None])
        keys = ("best_t", "best_prim", "best_u", "best_v")
        new = _merge(tuple(s[key] for key in keys), torch.where(take, t, INF), u, v, pid)
        for key, x in zip(keys, new):
            s[key].copy_(x)

        push = box & (count <= 0)
        for child, at in ((a, sp), (b, sp + 1)):
            col = torch.clamp(at, max=STACK_DEPTH)
            stack[rows, col] = torch.where(push, child, stack[rows, col])
        s["sp"].copy_(torch.where(push, sp + 2, sp))


def _bvh_graph(geom, n, device):
    """A CUDA graph of STEPS_PER_CHECK steps of the walk of n rays on ``geom``,
    with its state and tables, kept while the geometry lives
    (``utils/memo.py::per_object``): a step is some 270 small operations,
    and launching them one by one from the host, not running them on the
    card, sets a walk's time."""
    def capture():
        tab, s = _bvh_tables(geom), _bvh_state(n, device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):  # a warm-up off the capture, as torch.cuda.graph asks
            _bvh_steps(geom, tab, s, STEPS_PER_CHECK)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            _bvh_steps(geom, tab, s, STEPS_PER_CHECK)
        return graph, s, tab

    return per_object(geom, ("bvh graph", n, str(device)), capture)


def _trace_bvh(geom, o, d, tmin, tmax, graph=True) -> Hit:
    """tpu_rt's per-ray BVH walk (``_trace_bvh_one`` under ``vmap``), for
    all rays at once, a step (``_bvh_steps``) at a time until every stack
    is empty, checked every STEPS_PER_CHECK steps; on CUDA those steps
    replay as one CUDA graph, unless ``graph=False`` (the same operations
    on the same state, so the same bits).

    A leaf's 4 prims are tested at once with the best t from before the
    leaf as their tmax, and the closest taken with the first slot winning
    ties: tpu_rt tests them one after another, each with the best so far,
    which picks the same prim, since an intersector only ever adds hits at
    or beyond a smaller tmax.  A push past the stack's 48 entries is
    dropped and a pop of it reads the last entry, as JAX's scatter and
    gather treat an index out of range.  A miss reports t = INF, where
    tpu_rt's reports its tmax.

    The walk runs on the rays detached, under ``torch.no_grad()`` (its
    state is updated in place, and a CUDA graph replays no autograd), so
    its t, u and v are detached, as K7's are: a gradient reaches the hit
    point through p = o + t d (``compute_interaction``).  jax.grad through
    tpu_rt's walk (a ``lax.while_loop``) raises where its rays depend on a
    parameter (ROADMAP.md, divergences)."""
    with torch.no_grad():
        return _trace_bvh_walk(geom, o.detach(), d.detach(), tmin,
                               tmax.detach() if torch.is_tensor(tmax) else tmax, graph)


def _trace_bvh_walk(geom, o, d, tmin, tmax, graph):
    n = o.shape[0]
    dev = o.device
    tmin_b = _per_ray(tmin, n, dev)[:, 0]
    tmax_b = torch.clamp(_per_ray(tmax, n, dev)[:, 0], max=0.99 * INF)
    if dev.type == "cuda" and graph:
        replay, s, _ = _bvh_graph(geom, n, dev)
        replay = replay.replay
    else:
        tab, s = _bvh_tables(geom), _bvh_state(n, dev)

        def replay():
            _bvh_steps(geom, tab, s, STEPS_PER_CHECK)
    _bvh_start(s, o, d, tmin_b, tmax_b)
    while True:
        replay()
        if not bool((s["sp"] > 0).any()):
            break
    hit = s["best_prim"] >= 0
    return Hit(t=torch.where(hit, s["best_t"], INF), prim=s["best_prim"].to(torch.int32),
               u=s["best_u"].clone(), v=s["best_v"].clone())


def ray_intersect_hit(geom, o, d, tmin=RAY_EPS, tmax=INF) -> Hit:
    """Closest hit of rays o, d [N, 3] within (tmin, tmax), tmax a scalar
    or [N]: brute force up to 192 prims, K7 on a scene with mesh cluster
    tables, chunks up to 8 192 prims, else the BVH."""
    P = geom.n_tris + geom.n_analytic
    if P <= BRUTE_FORCE_MAX_PRIMS:
        return _trace_bruteforce(geom, o, d, tmin, tmax)
    if geom.cl_trisw is not None:
        return _trace_mesh(geom, o, d, tmin, tmax)
    if P <= CHUNKED_MAX_PRIMS:
        return _trace_chunked(geom, o, d, tmin, tmax)
    return _trace_bvh(geom, o, d, tmin, tmax)


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
