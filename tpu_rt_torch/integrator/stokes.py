"""Polarized (Stokes-vector) path tracing with Mueller-matrix transport.

Counterpart of ``tpu_rt/integrator/stokes.py``: the ``stokes`` integrator
wrapping ``path`` (cbox_pol-class scenes) and the ``polarizer`` BSDF.

``render_stokes`` sends a scene inside the Stokes kernel's scope (baked by
``ops/path_kernel.py``: rough conductors, with their Mueller chain through
the NEE scattering plane, and cones included; no polarizer, no textured
environment, no explicit ``max_depth``) to
``path_kernel.render_stokes_film`` (K3, one thread a (pixel, sample)).
Everything else, above all true polarizer transport, renders through the
wavefront tracer below, one PyTorch pass a bounce over the scalar
renderer's modules (``geometry/trace.py`` with the clustered
mesh-intersect kernel K7 on a mesh, ``bsdf/eval.py``, ``emitter/``).

Transport: tracing from the camera, every lane carries T (N, 3, 4, 4), the
camera-side Mueller matrix per RGB channel.  At each vertex the
interaction's Mueller matrix M (in the s-p basis of the scattering plane)
is chained with a reference-frame rotator, T <- T R(basis -> s) M, and the
carried basis becomes the scattering plane's s axis.  Emitters are
unpolarized, so each emission adds Le * T[..., :, 0].  The output basis is
the camera's horizontal axis projected perpendicular to each primary ray.
Directions are sampled by the scalar BSDF sampler; each Mueller matrix is
normalized by its own M00 and scaled by the scalar weight, so Stokes-I is
the unpolarized estimate.  NEE here chains a copy of T through the
light's scattering plane for every lobe; the film kernel does so for the
rough conductor and takes the depolarized shortcut T[:, 0] w for a
diffuse lobe (tpu_rt keeps each route's form).

Randomness is explicit, as in ``integrator/path.py``: ``render_stokes``
seeds one ``torch.Generator`` on the device, which draws each wave's
jitter [H*W, 2] and each bounce's [N, 8] block in tpu_rt's layout ([0:4]
light sample, [4] lobe, [5:7] direction, [7] roulette); ``stokes_trace``
also takes them as ``uniforms`` [depth_cap, N, 8].
"""

from __future__ import annotations

import torch

from tpu_rt_torch.bsdf import eval as bsdf
from tpu_rt_torch.bsdf import mueller
from tpu_rt_torch.core.math import (
    coordinate_system,
    cross,
    dot,
    mis_power_heuristic,
    normalize,
    to_local,
    to_world,
    transform_vector,
)
from tpu_rt_torch.emitter import sample as emitter
from tpu_rt_torch.geometry import trace
from tpu_rt_torch.scene.types import (
    BSDF_CONDUCTOR,
    BSDF_DIELECTRIC,
    BSDF_POLARIZER,
    BSDF_ROUGH_CONDUCTOR,
    grad_tensors,
)
from tpu_rt_torch.sensor import camera as cam
from tpu_rt_torch.sensor import film as film_mod
from tpu_rt_torch.utils.profiling import span

_MAX_DEPTH_CAP = 16


def resolved_depth(scene, max_depth=None):
    """The bounces ``stokes_trace`` runs: max_depth, the scene's when None,
    16 where that is unset, never more than 16."""
    d = scene.max_depth if max_depth is None else max_depth
    if d is None or d < 0:
        d = _MAX_DEPTH_CAP
    return min(d, _MAX_DEPTH_CAP)


def _matmul(a, b):
    """Batched 4x4 Mueller product."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _interaction_mueller(b_type, b_params, wi_local, wo_local, scalar_weight, has_polarizer):
    """The sampled interaction's Mueller matrix (N, 3, 4, 4) in the s-p
    basis of the scattering plane, normalized so that M00 equals the
    scalar weight per channel.  Also returns the polarizer lanes."""
    M = mueller.depolarizer(scalar_weight)  # diffuse and the rest
    cos_i = torch.abs(wi_local[..., 2])

    # smooth dielectric: reflection, or transmission when wo crosses
    m_die = b_type == BSDF_DIELECTRIC
    eta_rel = b_params[..., 0] / torch.clamp(b_params[..., 1], min=1e-6)
    M_die = mueller.specular_reflection(cos_i[..., None], eta_rel[..., None])
    transmitted = wo_local[..., 2] * wi_local[..., 2] < 0.0
    eta_ti = torch.where(wi_local[..., 2] >= 0, 1.0 / eta_rel, eta_rel)
    M_die_t = mueller.specular_transmission(
        cos_i[..., None], torch.abs(wo_local[..., 2])[..., None],
        1.0 / torch.clamp(eta_ti, min=1e-6)[..., None])
    M_die = torch.where(transmitted[..., None, None, None], M_die_t, M_die)
    M = torch.where(m_die[..., None, None, None], M_die, M)

    # conductors, smooth and rough: Fresnel at the half vector
    m_con = (b_type == BSDF_CONDUCTOR) | (b_type == BSDF_ROUGH_CONDUCTOR)
    is_mirror = b_params[..., 0] < 0.0
    eta_c = torch.where(is_mirror[..., None], 1e6, b_params[..., 0:3])
    k_c = torch.where(is_mirror[..., None], 1e8, b_params[..., 3:6])
    h = normalize(wi_local + wo_local)
    cos_h = torch.abs((wi_local * h).sum(-1))
    M_con = mueller.specular_reflection(cos_h[..., None], eta_c, k_c)
    M = torch.where(m_con[..., None, None, None], M_con, M)

    # polarizer: the matrix of an axis along the reference basis; the
    # caller rotates it into the sheet's transmission-axis frame
    m_pol = b_type == BSDF_POLARIZER
    if has_polarizer:
        zeros = torch.zeros_like(b_params[..., 0])
        M_pol = mueller.linear_polarizer(zeros[..., None], (zeros + 1.0)[..., None])
        M = torch.where(m_pol[..., None, None, None], M_pol, M)

    m00 = torch.clamp(M[..., 0, 0], min=1e-12)
    M = M / m00[..., None, None] * scalar_weight[..., None, None]
    return M, m_pol


def _add_emission(S, T, le, mask, w_mis):
    """Unpolarized emission: S += Le * T[..., :, 0] where ``mask``."""
    contrib = T[..., :, 0].transpose(-1, -2) * le[:, None, :] * w_mis[:, None, None]
    return S + torch.where(mask[:, None, None], contrib, 0.0)


def _chain(T, basis, p_B, p_A, M):
    """T <- T R(phi) M, phi the angle from the scattering plane's s axis
    to the carried basis around p_B; the new basis is the s axis,
    perpendicular to p_A."""
    s_raw = cross(p_A, p_B)
    ln2 = (s_raw * s_raw).sum(-1, keepdim=True)
    degenerate = ln2[..., 0] < 1e-12
    s_axis = torch.where(degenerate[..., None], mueller.perpendicular_basis(p_B, basis),
                         s_raw / torch.sqrt(torch.clamp(ln2, min=1e-24)))
    R = mueller.rotator(mueller.rotation_angle(p_B, s_axis, basis))[:, None]
    T_new = _matmul(T, _matmul(R, M))
    basis_new = torch.where(degenerate[..., None], mueller.perpendicular_basis(p_A, s_axis),
                            s_axis)
    return T_new, basis_new


def _polarizer_axis_frame(scene, si, b_params, M, is_pol, basis, d):
    """A polarizer's Mueller matrix rotated from the reference basis onto
    its transmission axis: the sheet's local (sin theta, cos theta, 0)
    through its to_world, projected perpendicular to the ray."""
    if scene.shape_to_world is None:
        raise ValueError("a polarizer needs the scene's shape_to_world")
    theta = torch.deg2rad(b_params[..., 0])
    sw = scene.shape_to_world[torch.clamp(si.shape, min=0)]
    axis_local = torch.stack([torch.sin(theta), torch.cos(theta), torch.zeros_like(theta)], -1)
    axis_world = normalize(transform_vector(sw, axis_local))
    p_B = -d
    axis_perp = mueller.perpendicular_basis(p_B, axis_world)
    # the angle from the carried basis to the axis (_chain keeps the
    # carried basis for a straight-through segment)
    base_b = mueller.perpendicular_basis(p_B, basis)
    phi_ax = mueller.rotation_angle(p_B, base_b, axis_perp)
    M_rot = _matmul(mueller.rotator(-phi_ax)[:, None],
                    _matmul(M, mueller.rotator(phi_ax)[:, None]))
    return torch.where(is_pol[:, None, None, None], M_rot, M)


def stokes_trace(scene, o, d, gen=None, uniforms=None, max_depth=None, has_polarizer=None,
                 tmin0=None, tmax0=None):
    """Stokes radiance [N, 4, 3] of rays o, d [N, 3] on the scene's
    device, in the basis of the camera's x axis projected perpendicular to
    each ray, and the rays cast (0-d int64: segments plus shadow rays).

    ``tmin0`` / ``tmax0`` are the camera's near and far planes: the near
    plane moves the origin to o + tmin0 d, the far plane clips the primary
    segment only.  ``has_polarizer`` (None: read from the scene on the
    host) switches the polarizer lanes on.  Each bounce's [N, 8] uniforms
    come from ``uniforms[depth]`` when given, else from ``gen``."""
    if tmin0 is not None:
        o = o + torch.as_tensor(tmin0, device=o.device).reshape(-1, 1) * d
        if tmax0 is not None:
            tmax0 = tmax0 - tmin0
    n = o.shape[0]
    dev = o.device
    depth_cap = resolved_depth(scene, max_depth)
    if has_polarizer is None:
        has_polarizer = bool((scene.bsdf_type == BSDF_POLARIZER).any())
    present = scene.bsdf_types_present or None
    n_bsdf = scene.bsdf_type.shape[0]
    em = scene.emitters
    cam_x = (scene.camera.to_world[:3, 0] if scene.camera is not None
             else torch.tensor([1.0, 0.0, 0.0], device=dev))

    S = torch.zeros((n, 4, 3), dtype=torch.float32, device=dev)
    T = torch.eye(4, dtype=torch.float32, device=dev).expand(n, 3, 4, 4)
    basis = mueller.perpendicular_basis(-d, cam_x.to(torch.float32).expand(n, 3))
    eta_scale = torch.ones((n,), dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_pdf = torch.ones((n,), dtype=torch.float32, device=dev)
    prev_delta = torch.ones((n,), dtype=torch.bool, device=dev)
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    ones = torch.ones((n,), dtype=torch.float32, device=dev)

    for depth in range(depth_cap):
        # a dead lane's query is collapsed to an empty segment
        si = trace.ray_intersect(scene, o, d, tmax=torch.where(active, trace.INF, 0.0))
        if tmax0 is not None and depth == 0:
            in_clip = si.t <= tmax0
            si = si.replace(valid=si.valid & in_clip, t=torch.where(in_clip, si.t, trace.INF),
                            shape=torch.where(in_clip, si.shape, -1))
        hit = si.valid & active
        escaped = ~si.valid & active
        n_rays = n_rays + active.sum()
        seen = not (depth == 0 and scene.hide_emitters)

        cos_l = dot(si.n, si.wi)
        le = emitter.eval_area(scene, si.shape, cos_l)
        pdf_light = emitter.pdf_direct_area(scene, si.shape, d,
                                            torch.where(si.valid, si.t, 1.0), cos_l)
        w_b = torch.where(prev_delta, 1.0, mis_power_heuristic(prev_pdf, pdf_light))
        S = _add_emission(S, T, le, hit & seen, w_b)
        if em.has_env:
            pdf_env = emitter.pdf_direct_env(scene, d)
            w_env = torch.where(prev_delta, 1.0, mis_power_heuristic(prev_pdf, pdf_env))
            S = _add_emission(S, T, emitter.eval_env(scene, d), escaped & seen, w_env)

        sfr, tfr = coordinate_system(si.n)
        wi_local = to_local(si.n, sfr, tfr, si.wi)
        b_c = torch.clamp(scene.shape_bsdf[torch.clamp(si.shape, min=0)], 0, n_bsdf - 1)
        b_type = scene.bsdf_type[b_c]
        b_params = scene.bsdf_params[b_c]
        if uniforms is not None:
            s_all = uniforms[depth]
        else:
            s_all = torch.rand((n, 8), generator=gen, device=dev)

        # NEE (depolarizing and rough-conductor lobes): the path to the
        # light is one segment longer, so it runs while depth + 2 <= cap
        if em.n_lights > 0 and depth + 2 <= depth_cap:
            ds = emitter.sample_direct(scene, si.p, s_all[:, 0], s_all[:, 1:4], hit)
            nee = hit & (ds.pdf > 0.0)
            n_rays = n_rays + nee.sum()
            wo_nee = to_local(si.n, sfr, tfr, ds.d)
            f_nee, pdf_bsdf_nee = bsdf.eval_pdf(b_type, b_params, wi_local, wo_nee, nee,
                                                present=present)
            occluded = trace.ray_test(scene.geometry, si.spawn_origin(ds.d), ds.d,
                                      tmin=trace.RAY_EPS,
                                      tmax=torch.where(nee, ds.dist * (1.0 - 1e-3), 0.0))
            w_nee = torch.where(ds.delta, 1.0, mis_power_heuristic(ds.pdf, pdf_bsdf_nee))
            scalar_nee = f_nee * ds.radiance * (w_nee / torch.clamp(ds.pdf, min=1e-20))[:, None]
            M_nee, _ = _interaction_mueller(b_type, b_params, wi_local, wo_nee, scalar_nee,
                                            has_polarizer)
            T_nee, _ = _chain(T, basis, -d, -ds.d, M_nee)
            S = _add_emission(S, T_nee, torch.ones_like(scalar_nee), nee & ~occluded, ones)

        # BSDF sampling and the Mueller chain
        bs = bsdf.sample(b_type, b_params, wi_local, s_all[:, 4], s_all[:, 5:7], hit,
                         present=present)
        d_new = to_world(si.n, sfr, tfr, bs.wo)
        o_new = si.spawn_origin(d_new)
        M, is_pol = _interaction_mueller(b_type, b_params, wi_local, bs.wo, bs.weight,
                                         has_polarizer)
        if has_polarizer:
            M = _polarizer_axis_frame(scene, si, b_params, M, is_pol, basis, d)
        T_new, basis_new = _chain(T, basis, -d, -d_new, M)

        alive = hit & (bs.pdf > 0.0)
        thr_I = T_new[..., 0, 0].amax(-1)  # the channels' largest intensity weight
        alive = alive & (thr_I > 0.0)
        eta_scale = eta_scale * bs.eta
        if depth >= scene.rr_depth:  # roulette on the intensity over eta^2
            inv_eta2 = 1.0 / torch.clamp(eta_scale * eta_scale, min=1e-12)
            q = torch.clamp(thr_I * inv_eta2, max=0.95)
            survive = s_all[:, 7] < q
            T_new = torch.where(survive[:, None, None, None],
                                T_new / torch.clamp(q, min=1e-12)[:, None, None, None], T_new)
            alive = alive & survive

        o, d = o_new, d_new
        T = torch.where(alive[:, None, None, None], T_new, 0.0)
        basis = basis_new
        active = alive
        prev_pdf, prev_delta = bs.pdf, bs.delta
    return S, n_rays


def render_stokes(scene, spp=None, seed=0, max_depth=None, device="cuda", spp_per_pass=64,
                  tile_rows=16):
    """Full polarized render on ``device``: the (H, W, 4, 3) Stokes image
    (I, Q, U, V by rgb); sets ``render_stokes.last_ray_count`` (0-d int64).

    With ``max_depth`` None a scene in the Stokes kernel's scope, with no
    tensor that requires grad, renders through the forward-only
    ``path_kernel.render_stokes_film`` (``spp_per_pass`` and
    ``tile_rows`` go there).  Every other scene, notably a
    polarizer, renders through the wavefront: ``spp`` waves of one sample
    a pixel, each splatted at its pixels (a sample with a non-finite value
    left out) and developed."""
    from tpu_rt_torch.ops import path_kernel

    with span("tpu_rt_torch.render_stokes"):
        device = torch.device(device)
        if max_depth is None and not grad_tensors(scene):
            baked = path_kernel.bake_scene(scene)
            if path_kernel.stokes_in_scope(baked):
                S, n_rays = path_kernel.render_stokes_film(
                    scene, spp=spp, seed=seed, device=device, spp_per_pass=spp_per_pass,
                    tile_rows=tile_rows, baked=baked)
                render_stokes.last_ray_count = n_rays
                return S
        scene = scene.to(device)
        c = scene.camera
        H, W = c.height, c.width
        spp = c.spp if spp is None else spp
        has_polarizer = bool((scene.bsdf_type == BSDF_POLARIZER).any())
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        ys, xs = torch.meshgrid(torch.arange(H, device=device), torch.arange(W, device=device),
                                indexing="ij")
        xy = torch.stack([xs, ys], -1).reshape(-1, 2).to(torch.float32)
        fv = torch.zeros((H, W, 12), dtype=torch.float32, device=device)
        fw = torch.zeros((H, W), dtype=torch.float32, device=device)
        n_rays = torch.zeros((), dtype=torch.int64, device=device)
        for _ in range(spp):
            jitter = torch.rand((H * W, 2), generator=gen, device=device)
            o, d, t0, t1 = cam.sample_ray_extents(c, xy + jitter)
            S, n = stokes_trace(scene, o, d, gen=gen, max_depth=max_depth,
                                has_polarizer=has_polarizer, tmin0=t0, tmax0=t1)
            ok = torch.isfinite(S).all(-1).all(-1)
            S = torch.where(ok[:, None, None], S, 0.0).reshape(1, H, W, 12)
            fv, fw = film_mod.splat_aligned(fv, fw, jitter.reshape(1, H, W, 2), S,
                                            ok.reshape(1, H, W), c.filter_type)
            n_rays = n_rays + n
        render_stokes.last_ray_count = n_rays
        return film_mod.develop(fv, fw).reshape(H, W, 4, 3)


render_stokes.last_ray_count = None
