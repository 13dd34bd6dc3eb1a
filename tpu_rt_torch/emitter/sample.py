"""Emitter sampling for next-event estimation, the emitters' MIS pdfs, and
the miss shader.

Counterpart of ``tpu_rt/emitter/sample.py``.  A light unit (an area
emitter, a point light, the environment) is picked uniformly; an area
emitter then picks a triangle by its per-emitter area CDF and a uniform
point on it.  The environment is the lat-long map with its row / column
CDFs; the loader builds only the constant environment (one texel) until
``envmap`` lands (ROADMAP A7), and the same code serves both.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from tpu_rt_torch.core.math import cross, dot, normalize, transform_vector, vec3
from tpu_rt_torch.core.warps import square_to_uniform_triangle


@dataclass
class DirectSample:
    """A light sample toward a reference point."""

    p: torch.Tensor  # [N, 3] point on the light (a far point for the environment)
    n: torch.Tensor  # [N, 3] the light's normal
    d: torch.Tensor  # [N, 3] unit direction reference -> light
    dist: torch.Tensor  # [N] distance
    pdf: torch.Tensor  # [N] solid-angle pdf (0 marks an invalid lane)
    radiance: torch.Tensor  # [N, 3] emitted radiance toward the reference
    delta: torch.Tensor  # [N] bool: a point light (no MIS)


def _searchsorted_cdf(cdf, u):
    """First index with cdf[i] >= u, per lane."""
    return (cdf[None, :] < u[:, None]).sum(1)


def sample_direct(scene, ref_p, s_light, s_tri, active):
    """Sample a light toward the points ``ref_p`` [N, 3] with ``s_light``
    [N] (light selection) and ``s_tri`` [N, 3] ([0] triangle or texel
    selection, [1:3] position)."""
    em = scene.emitters
    n = ref_p.shape[0]
    dev = ref_p.device
    L = em.n_lights
    z3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    z1 = torch.zeros((n,), dtype=torch.float32, device=dev)
    no = torch.zeros((n,), dtype=torch.bool, device=dev)
    if L == 0:
        return DirectSample(p=z3, n=z3, d=z3, dist=z1, pdf=z1, radiance=z3, delta=no)

    light_idx = torch.clamp((s_light * L).to(torch.int64), max=L - 1)
    p, nrm, radiance, pdf_area, delta, env_mask = z3, z3, z3, z1, no, no

    if em.n_area > 0:
        is_area = light_idx < em.n_area
        e = torch.clamp(light_idx, 0, em.n_area - 1)
        lo = em.em_offsets[e].to(torch.int64)
        hi = em.em_offsets[e + 1].to(torch.int64)
        ET = em.em_tri_cdf.shape[0]
        idxs = torch.arange(ET, device=dev)[None, :]
        in_slice = (idxs >= lo[:, None]) & (idxs < hi[:, None])
        passed = in_slice & (em.em_tri_cdf[None, :] < s_tri[:, 0:1])
        ti = torch.minimum(lo + passed.sum(1), hi - 1)
        tri = em.em_tri_prim.to(torch.int64)[torch.clamp(ti, 0, ET - 1)]
        g = scene.geometry
        p0, e1, e2 = g.tri_p0[tri], g.tri_e1[tri], g.tri_e2[tri]
        bc = square_to_uniform_triangle(s_tri[:, 1:3])
        p_a = p0 + bc[:, 0:1] * e1 + bc[:, 1:2] * e2
        n_a = cross(e1, e2)
        n_a = n_a / torch.sqrt(torch.clamp((n_a * n_a).sum(-1, keepdim=True), min=1e-24))
        pdf_a = 1.0 / torch.clamp(em.area_total[e], min=1e-20)
        p = torch.where(is_area[:, None], p_a, p)
        nrm = torch.where(is_area[:, None], n_a, nrm)
        radiance = torch.where(is_area[:, None], em.area_radiance[e], radiance)
        pdf_area = torch.where(is_area, pdf_a, pdf_area)

    if em.n_point > 0:
        is_pt = (light_idx >= em.n_area) & (light_idx < em.n_area + em.n_point)
        pi = torch.clamp(light_idx - em.n_area, 0, em.n_point - 1)
        p = torch.where(is_pt[:, None], em.point_pos[pi], p)
        delta = delta | is_pt

    if em.has_env:
        env_mask = light_idx >= em.n_area + em.n_point

    to_light = p - ref_p
    dist2 = torch.clamp(dot(to_light, to_light), min=1e-20)
    dist = torch.sqrt(dist2)
    d = to_light / dist[..., None]

    # area emitters: the area pdf in solid angle, one-sided emission
    cos_l = -dot(d, nrm)
    front = cos_l > 1e-6
    pdf_sa = pdf_area * dist2 / torch.clamp(cos_l, min=1e-6)
    pdf = torch.where(pdf_area > 0.0, torch.where(front, pdf_sa, 0.0), 0.0)
    radiance = torch.where((pdf_area > 0.0)[:, None] & ~front[:, None], 0.0, radiance)

    if em.n_point > 0:
        # point lights: intensity / r^2 as radiance, pdf 1
        pi = torch.clamp(light_idx - em.n_area, 0, em.n_point - 1)
        radiance = torch.where(delta[:, None], em.point_intensity[pi] / dist2[:, None],
                               radiance)
        pdf = torch.where(delta, 1.0, pdf)

    if em.has_env:
        d_env, pdf_env, rad_env = _sample_env(em, s_tri[:, 1:3])
        d = torch.where(env_mask[:, None], d_env, d)
        pdf = torch.where(env_mask, pdf_env, pdf)
        radiance = torch.where(env_mask[:, None], rad_env, radiance)
        dist = torch.where(env_mask, 1e7, dist)
        nrm = torch.where(env_mask[:, None], -d, nrm)
        p = torch.where(env_mask[:, None], ref_p + d * 1e7, p)

    pdf = torch.where(active, pdf * (1.0 / L), 0.0)
    return DirectSample(p=p, n=nrm, d=d, dist=dist, pdf=pdf, radiance=radiance,
                        delta=delta)


def _uv_to_dir(uv):
    """Lat-long uv -> direction in the map's frame (y up; u wraps the
    azimuth from -z through +x, v is the polar angle from +y)."""
    phi = (uv[..., 0] - 0.5) * (2.0 * math.pi)
    theta = uv[..., 1] * math.pi
    st = torch.sin(theta)
    return vec3(st * torch.sin(phi), torch.cos(theta), -st * torch.cos(phi))


def _dir_to_uv(d):
    u = 0.5 + torch.atan2(d[..., 0], -d[..., 2]) / (2.0 * math.pi)
    v = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0)) / math.pi
    return torch.stack([u, v], -1)


def _pdfs(cdf):
    """Per-bin probabilities of a CDF along its last axis."""
    return cdf - torch.cat([torch.zeros_like(cdf[..., :1]), cdf[..., :-1]], -1)


def _sample_env(em, s2):
    H, W = em.env_map.shape[:2]
    row = torch.clamp(_searchsorted_cdf(em.env_cdf_rows, s2[..., 0]), max=H - 1)
    col_cdf = em.env_cdf_cols[row]
    col = torch.clamp((col_cdf < s2[..., 1:2]).sum(-1), max=W - 1)
    # continuous jitter inside the texel by rescaling the CDF remainder
    row_lo = torch.where(row > 0, em.env_cdf_rows[torch.clamp(row - 1, min=0)], 0.0)
    row_hi = em.env_cdf_rows[row]
    jv = torch.clamp((s2[..., 0] - row_lo) / torch.clamp(row_hi - row_lo, min=1e-12), 0.0, 1.0)
    col_lo = torch.where(col > 0, torch.gather(col_cdf, -1, torch.clamp(col - 1, min=0)[..., None])[..., 0],
                         0.0)
    col_hi = torch.gather(col_cdf, -1, col[..., None])[..., 0]
    ju = torch.clamp((s2[..., 1] - col_lo) / torch.clamp(col_hi - col_lo, min=1e-12), 0.0, 1.0)
    uv = torch.stack([(col + ju) / W, (row + jv) / H], -1)
    d_world = normalize(transform_vector(em.env_to_world, _uv_to_dir(uv)))
    p_texel = _pdfs(em.env_cdf_rows)[row] * torch.gather(_pdfs(col_cdf), -1, col[..., None])[..., 0]
    theta = uv[..., 1] * math.pi
    texel_sa = (2.0 * math.pi / W) * (math.pi / H) * torch.clamp(torch.sin(theta), min=1e-6)
    return d_world, p_texel / texel_sa, em.env_map[row, col] * em.env_scale


def pdf_direct_area(scene, si_shape, d, dist, cos_l):
    """Solid-angle pdf of ``sample_direct`` having chosen the emissive
    shape a BSDF-sampled ray hit (for MIS)."""
    em = scene.emitters
    if em.n_area == 0:
        return torch.zeros(si_shape.shape, dtype=torch.float32, device=si_shape.device)
    L = max(em.n_lights, 1)
    e = scene.shape_emitter[torch.clamp(si_shape, min=0)]
    valid = (si_shape >= 0) & (e >= 0)
    pdf_area = 1.0 / torch.clamp(em.area_total[torch.clamp(e, 0, em.n_area - 1)], min=1e-20)
    pdf_sa = pdf_area * dist * dist / torch.clamp(cos_l, min=1e-6)
    return torch.where(valid & (cos_l > 1e-6), pdf_sa / L, 0.0)


def _env_texel(em, d_world):
    H, W = em.env_map.shape[:2]
    uv = _dir_to_uv(normalize(transform_vector(em.env_to_local, d_world)))
    row = torch.clamp((uv[..., 1] * H).to(torch.int64), 0, H - 1)
    col = torch.clamp((uv[..., 0] * W).to(torch.int64), 0, W - 1)
    return uv, row, col


def pdf_direct_env(scene, d_world):
    """Solid-angle pdf of ``sample_direct`` for an escaped direction."""
    em = scene.emitters
    if not em.has_env:
        return torch.zeros(d_world.shape[:-1], dtype=torch.float32, device=d_world.device)
    L = max(em.n_lights, 1)
    H, W = em.env_map.shape[:2]
    uv, row, col = _env_texel(em, d_world)
    col_pdf = _pdfs(em.env_cdf_cols[row])
    p_texel = _pdfs(em.env_cdf_rows)[row] * torch.gather(col_pdf, -1, col[..., None])[..., 0]
    theta = uv[..., 1] * math.pi
    texel_sa = (2.0 * math.pi / W) * (math.pi / H) * torch.clamp(torch.sin(theta), min=1e-6)
    return p_texel / texel_sa / L


def eval_env(scene, d_world):
    """Environment radiance of escaped rays (the miss shader)."""
    em = scene.emitters
    if not em.has_env:
        return torch.zeros(d_world.shape[:-1] + (3,), dtype=torch.float32, device=d_world.device)
    _, row, col = _env_texel(em, d_world)
    return em.env_map[row, col] * em.env_scale


def eval_area(scene, si_shape, cos_l):
    """Radiance of the area emitter a ray hit (one-sided)."""
    em = scene.emitters
    if em.n_area == 0:
        return torch.zeros(si_shape.shape + (3,), dtype=torch.float32, device=si_shape.device)
    e = scene.shape_emitter[torch.clamp(si_shape, min=0)]
    valid = (si_shape >= 0) & (e >= 0) & (cos_l > 0.0)
    return torch.where(valid[..., None], em.area_radiance[torch.clamp(e, 0, em.n_area - 1)], 0.0)
