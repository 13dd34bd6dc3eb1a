"""The wavefront path tracer: next-event estimation, MIS and Russian
roulette over a batch of rays, one PyTorch pass per bounce.

Counterpart of ``tpu_rt/integrator/path.py``, the route of every ``path``
scene outside the film kernel's bake scope and of every ``direct`` scene
outside the direct mesh kernel's (at max_depth 2).  Each bounce: the
closest hit (``geometry/trace.py``; on a mesh scene through the clustered
mesh-intersect kernel K7), on a textured scene the bitmap reflectance at
the hit's uv in place of the BSDF row's constant (``bsdf/texture.py``,
for the light sample's evaluation and BSDF sampling alike), emitters
seen by the ray with MIS against the previous BSDF sample, one light
sample with its shadow ray (also through K7), BSDF sampling, Russian
roulette.  ``shadow_geom`` / ``soft_curves`` switch on the soft curve
shadows of ``integrator/projective.py``: the shadow rays test a geometry
without the curves, and the light sample's contribution is scaled by its
smooth visibility past them.

Randomness is explicit: ``render`` seeds one ``torch.Generator`` on the
device, which draws each wave's pixel jitter [H*W, 2] and each bounce's
[N, 8] block in tpu_rt's layout ([0:4] light sample, [4] lobe, [5:7] BSDF
direction, [7] roulette).  ``path_trace`` also takes the blocks as
``uniforms`` [n_iters, N, 8], so a test can feed it tpu_rt's own threefry
draws and both tracers follow the same paths.

Not carried over: tpu_rt's tile permutation of the pixels (``_tile_perm``,
for the TPU kernel's per-block culls; K7 culls per ray), its coherence
sort (a measured dead end, off by default there), and its per-bounce
occupancy output.
"""

from __future__ import annotations

import torch

from tpu_rt_torch.bsdf import eval as bsdf
from tpu_rt_torch.bsdf import texture
from tpu_rt_torch.core.math import coordinate_system, dot, mis_power_heuristic, to_local, to_world
from tpu_rt_torch.emitter import sample as emitter
from tpu_rt_torch.geometry import trace
from tpu_rt_torch.integrator import projective
from tpu_rt_torch.sensor import camera as cam
from tpu_rt_torch.sensor import film as film_mod

_MAX_DEPTH_CAP = 32


def resolved_depth(scene, max_depth=None):
    d = scene.max_depth if max_depth is None else max_depth
    if d is None or d < 0:
        return _MAX_DEPTH_CAP
    return min(d, _MAX_DEPTH_CAP)


def n_bounces(scene, max_depth=None):
    """Bounce iterations of ``path_trace``: max_depth, or one fewer when no
    emitter can be hit (point lights only), since the last segment could
    then only add zeros through BSDF-sampled emitter hits."""
    depth_cap = resolved_depth(scene, max_depth)
    if scene.emitters.n_area == 0 and not scene.emitters.has_env:
        return max(depth_cap - 1, 1)
    return depth_cap


def path_trace(scene, o, d, gen=None, uniforms=None, max_depth=None, rr_depth=None,
               tmin0=None, tmax0=None, shadow_geom=None, soft_curves=None):
    """Trace paths for rays o, d [N, 3] on the scene's device; returns
    (L [N, 3], the rays cast as a 0-d int64 tensor: segments plus shadow
    rays).

    ``max_depth`` counts path vertices as Mitsuba does (1: emitters seen
    directly, 2: direct lighting).  ``tmin0`` / ``tmax0`` ([N] or scalar)
    are the camera's near and far planes: the near plane moves the origin
    to o + tmin0 d, and the far plane turns primary hits beyond it into
    misses; later segments keep [eps, inf).  Each bounce's [N, 8] uniforms
    come from ``uniforms[i]`` when given, else from ``gen``.

    ``shadow_geom`` (a ``Geometry``) takes the shadow rays' queries in
    place of the scene's; ``soft_curves`` (``projective.curve_segments``'
    dict with a ``width``) scales each light sample's contribution by
    ``projective.curve_soft_visibility``."""
    if tmin0 is not None:
        o = o + torch.as_tensor(tmin0, device=o.device).reshape(-1, 1) * d
        if tmax0 is not None:
            tmax0 = tmax0 - tmin0
    n = o.shape[0]
    dev = o.device
    depth_cap = resolved_depth(scene, max_depth)
    n_iters = n_bounces(scene, max_depth)
    rr_start = scene.rr_depth if rr_depth is None else rr_depth
    present = scene.bsdf_types_present or None
    n_bsdf = scene.bsdf_type.shape[0]
    em = scene.emitters
    sgeom = scene.geometry if shadow_geom is None else shadow_geom

    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    thr = torch.ones((n, 3), dtype=torch.float32, device=dev)
    eta_scale = torch.ones((n,), dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_pdf = torch.ones((n,), dtype=torch.float32, device=dev)
    prev_delta = torch.ones((n,), dtype=torch.bool, device=dev)  # depth-0 hits count fully
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)

    for depth in range(n_iters):
        # a dead lane's query is collapsed to an empty segment: it costs one
        # box test per cluster and its result is never read
        si = trace.ray_intersect(scene, o, d, tmax=torch.where(active, trace.INF, 0.0))
        if tmax0 is not None and depth == 0:
            in_clip = si.t <= tmax0
            si = si.replace(valid=si.valid & in_clip, t=torch.where(in_clip, si.t, trace.INF),
                            shape=torch.where(in_clip, si.shape, -1))
        hit = si.valid & active
        escaped = ~si.valid & active
        n_rays = n_rays + active.sum()
        seen = not (depth == 0 and scene.hide_emitters)

        # emitters this segment hit, with MIS against the last BSDF sample
        cos_l = dot(si.n, si.wi)
        le = emitter.eval_area(scene, si.shape, cos_l)
        t_safe = torch.where(si.valid, si.t, 1.0)
        pdf_light = emitter.pdf_direct_area(scene, si.shape, d, t_safe, cos_l)
        w_bsdf = torch.where(prev_delta, 1.0, mis_power_heuristic(prev_pdf, pdf_light))
        L = L + torch.where((hit & seen)[:, None], thr * le * w_bsdf[:, None], 0.0)
        if em.has_env:
            le_env = emitter.eval_env(scene, d)
            pdf_env = emitter.pdf_direct_env(scene, d)
            w_env = torch.where(prev_delta, 1.0, mis_power_heuristic(prev_pdf, pdf_env))
            L = L + torch.where((escaped & seen)[:, None], thr * le_env * w_env[:, None], 0.0)

        sfr, tfr = coordinate_system(si.n)
        wi_local = to_local(si.n, sfr, tfr, si.wi)
        b_c = torch.clamp(scene.shape_bsdf[torch.clamp(si.shape, min=0)], 0, n_bsdf - 1)
        b_type = scene.bsdf_type[b_c]
        b_params = scene.bsdf_params[b_c]
        if scene.has_textures:
            b_params = texture.apply_reflectance_textures(scene, b_c, b_params, si.uv)
        if uniforms is not None:
            s_all = uniforms[depth]
        else:
            s_all = torch.rand((n, 8), generator=gen, device=dev)

        # next-event estimation: the path to the light is one segment
        # longer, so it runs while depth + 2 <= max_depth
        if em.n_lights > 0 and depth + 2 <= depth_cap:
            ds = emitter.sample_direct(scene, si.p, s_all[:, 0], s_all[:, 1:4], hit)
            nee = hit & (ds.pdf > 0.0)
            n_rays = n_rays + nee.sum()
            wo_nee = to_local(si.n, sfr, tfr, ds.d)
            f_nee, pdf_bsdf_nee = bsdf.eval_pdf(b_type, b_params, wi_local, wo_nee, nee,
                                                present=present)
            shadow_o = si.spawn_origin(ds.d)
            occluded = trace.ray_test(sgeom, shadow_o, ds.d, tmin=trace.RAY_EPS,
                                      tmax=torch.where(nee, ds.dist * (1.0 - 1e-3), 0.0))
            w_nee = torch.where(ds.delta, 1.0, mis_power_heuristic(ds.pdf, pdf_bsdf_nee))
            contrib = thr * f_nee * ds.radiance * (w_nee / torch.clamp(ds.pdf, min=1e-20))[:, None]
            contrib = torch.where((nee & ~occluded)[:, None], contrib, 0.0)
            if soft_curves is not None:
                v_soft = projective.curve_soft_visibility(
                    soft_curves, shadow_o, ds.d, ds.dist * (1.0 - 1e-3), soft_curves["width"])
                contrib = contrib * v_soft[:, None]
            L = L + contrib

        # BSDF sampling and the next segment
        bs = bsdf.sample(b_type, b_params, wi_local, s_all[:, 4], s_all[:, 5:7], hit,
                         present=present)
        d_new = to_world(si.n, sfr, tfr, bs.wo)
        o_new = si.spawn_origin(d_new)
        thr_new = thr * bs.weight
        eta_scale = eta_scale * bs.eta
        alive = hit & (bs.pdf > 0.0) & (thr_new.amax(-1) > 0.0)

        # Russian roulette on throughput / eta^2
        if depth >= rr_start:
            inv_eta2 = 1.0 / torch.clamp(eta_scale * eta_scale, min=1e-12)
            q = torch.clamp(thr_new.amax(-1) * inv_eta2, max=0.95)
            survive = s_all[:, 7] < q
            thr_new = torch.where(survive[:, None], thr_new / torch.clamp(q, min=1e-12)[:, None],
                                  thr_new)
            alive = alive & survive

        o, d = o_new, d_new
        thr = torch.where(alive[:, None], thr_new, 0.0)
        active = alive
        prev_pdf, prev_delta = bs.pdf, bs.delta
    return L, n_rays


def render_sample_batch(scene, gen, max_depth=None):
    """One sample per pixel on the scene's device: the jitter [H*W, 2],
    then ``path_trace`` from the camera.  Returns (jitter, L [H*W, 3], rays
    cast)."""
    c = scene.camera
    H, W = c.height, c.width
    dev = scene.camera.to_world.device
    ys, xs = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev),
                            indexing="ij")
    xy = torch.stack([xs, ys], -1).reshape(-1, 2).to(torch.float32)
    jitter = torch.rand((H * W, 2), generator=gen, device=dev)
    o, d, t0, t1 = cam.sample_ray_extents(c, xy + jitter)
    L, n_rays = path_trace(scene, o, d, gen=gen, max_depth=max_depth, tmin0=t0, tmax0=t1)
    return jitter, L, n_rays


def render(scene, spp=None, seed=0, max_depth=None, device="cuda"):
    """Render ``spp`` one-sample-per-pixel waves through the wavefront
    tracer on ``device``: each wave's samples are splatted at their
    pixels (non-finite samples left out) and the film developed.  Returns
    the (H, W, 3) image and sets ``render.last_ray_count`` (0-d int64)."""
    device = torch.device(device)
    scene = scene.to(device)
    c = scene.camera
    H, W = c.height, c.width
    spp = c.spp if spp is None else spp
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    fv = torch.zeros((H, W, 3), dtype=torch.float32, device=device)
    fw = torch.zeros((H, W), dtype=torch.float32, device=device)
    n_rays = torch.zeros((), dtype=torch.int64, device=device)
    for _ in range(spp):
        jitter, L, n = render_sample_batch(scene, gen, max_depth=max_depth)
        ok = torch.isfinite(L).all(-1)
        fv, fw = film_mod.splat_aligned(fv, fw, jitter.reshape(1, H, W, 2),
                                        L.reshape(1, H, W, 3), ok.reshape(1, H, W),
                                        c.filter_type)
        n_rays = n_rays + n
    render.last_ray_count = n_rays
    return film_mod.develop(fv, fw)


render.last_ray_count = None
