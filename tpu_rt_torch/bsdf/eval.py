"""BSDF sampling, evaluation and pdf, dispatched per lane over the BSDF
table.

Counterpart of ``tpu_rt/bsdf/eval.py`` (the scalar, unpolarized path):
every lane carries a BSDF type and its parameter row; each lobe present
in the scene is evaluated on all lanes and combined with selects.  Lobes:
diffuse (front side only), smooth dielectric, smooth conductor (a
perfect mirror where ``params[0] < 0``), rough conductor (GGX VNDF), the
polarizer's unpolarized fallback (straight through, transmittance / 2)
and null (straight through).  Directions are in the local shading frame
(+Z = shading normal); ``wi`` points away from the surface.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from tpu_rt_torch.bsdf import microfacet as mf
from tpu_rt_torch.core import warps
from tpu_rt_torch.core.math import (
    fresnel_conductor,
    fresnel_dielectric,
    reflect_local,
    refract_local,
)
from tpu_rt_torch.scene.types import (
    BSDF_CONDUCTOR,
    BSDF_DIELECTRIC,
    BSDF_DIFFUSE,
    BSDF_NULL,
    BSDF_POLARIZER,
    BSDF_ROUGH_CONDUCTOR,
)

INV_PI = 1.0 / math.pi


@dataclass
class BSDFSample:
    wo: torch.Tensor  # [N, 3] sampled outgoing direction (local)
    pdf: torch.Tensor  # [N] solid-angle pdf (1 for a delta lobe)
    weight: torch.Tensor  # [N, 3] f |cos| / pdf
    delta: torch.Tensor  # [N] bool: a Dirac lobe was sampled (no MIS)
    eta: torch.Tensor  # [N] relative IOR of the sampled interaction


def _mirror_eta_k(params):
    """Conductor eta and k, with the perfect-mirror marker params[0] < 0."""
    is_mirror = params[..., 0] < 0.0
    eta = torch.where(is_mirror[..., None], 0.0, params[..., 0:3])
    k = torch.where(is_mirror[..., None], 1e6, params[..., 3:6])
    return eta, k, is_mirror


def _sign(x):
    return torch.sign(x)[..., None]


def sample(bsdf_type, params, wi, s1, s2, active, present=None):
    """Importance-sample the BSDF on every lane: ``bsdf_type`` [N] int,
    ``params`` [N, 16], ``wi`` [N, 3], ``s1`` [N] lobe sample, ``s2``
    [N, 2], ``active`` [N] bool; ``present`` the BSDF types that occur in
    the scene (None: all), whose lobes alone are evaluated."""
    def has(t):
        return present is None or t in present

    n = wi.shape[0]
    dev = wi.device
    cos_i = wi[..., 2]
    ones = torch.ones((n,), dtype=torch.float32, device=dev)
    falses = torch.zeros((n,), dtype=torch.bool, device=dev)
    out = dict(wo=torch.zeros_like(wi), pdf=torch.zeros_like(ones),
               weight=torch.zeros((n, 3), dtype=torch.float32, device=dev),
               delta=falses, eta=ones)

    def put(mask, wo_i, pdf_i, w_i, delta_i, eta_i):
        out["wo"] = torch.where(mask[..., None], wo_i, out["wo"])
        out["pdf"] = torch.where(mask, pdf_i, out["pdf"])
        out["weight"] = torch.where(mask[..., None], w_i, out["weight"])
        out["delta"] = torch.where(mask, delta_i, out["delta"])
        out["eta"] = torch.where(mask, eta_i, out["eta"])

    if has(BSDF_DIFFUSE):
        m_diff = bsdf_type == BSDF_DIFFUSE
        wo_d = warps.square_to_cosine_hemisphere(s2)
        wo_d = wo_d * torch.sign(torch.where(cos_i == 0, 1.0, cos_i))[..., None]
        pdf_d = warps.square_to_cosine_hemisphere_pdf(wo_d * _sign(cos_i))
        valid_d = cos_i > 0.0
        put(m_diff, wo_d, torch.where(valid_d, pdf_d, 0.0),
            torch.where(valid_d[..., None], params[..., 0:3], 0.0), falses, ones)

    if has(BSDF_DIELECTRIC):
        m_die = bsdf_type == BSDF_DIELECTRIC
        eta_rel = params[..., 0] / torch.clamp(params[..., 1], min=1e-6)
        F, cos_t, eta_it, eta_ti = fresnel_dielectric(cos_i, eta_rel)
        pick_reflect = s1 <= F
        wo_x = torch.where(pick_reflect[..., None], reflect_local(wi),
                           refract_local(wi, cos_t, eta_ti))
        # refraction scales radiance by 1 / eta^2 (solid-angle compression)
        w_x = torch.where(pick_reflect[..., None], params[..., 3:6],
                          params[..., 6:9] * (eta_ti * eta_ti)[..., None])
        put(m_die, wo_x, torch.where(pick_reflect, F, 1.0 - F), w_x, ~falses,
            torch.where(pick_reflect, 1.0, eta_it))

    if has(BSDF_CONDUCTOR) or has(BSDF_ROUGH_CONDUCTOR):
        eta_c, k_c, is_mirror = _mirror_eta_k(params)
    if has(BSDF_CONDUCTOR):
        m_con = bsdf_type == BSDF_CONDUCTOR
        Fc = torch.where(is_mirror[..., None], 1.0,
                         fresnel_conductor(torch.abs(cos_i)[..., None], eta_c, k_c))
        valid_c = cos_i > 0.0
        put(m_con, reflect_local(wi), torch.where(valid_c, 1.0, 0.0),
            torch.where(valid_c[..., None], Fc * params[..., 6:9], 0.0), ~falses, ones)

    if has(BSDF_ROUGH_CONDUCTOR):
        m_rc = bsdf_type == BSDF_ROUGH_CONDUCTOR
        alpha = torch.clamp(params[..., 9], min=1e-4)
        m_h = mf.ggx_sample_vndf(wi, alpha, s2)
        wo_rc = 2.0 * (wi * m_h).sum(-1, keepdim=True) * m_h - wi
        pdf_h = mf.ggx_vndf_pdf(wi, m_h, alpha)
        pdf_rc = pdf_h / torch.clamp(4.0 * torch.abs((wi * m_h).sum(-1)), min=1e-12)
        cos_im = torch.abs((wi * m_h).sum(-1))
        F_rc = torch.where(is_mirror[..., None], 1.0,
                           fresnel_conductor(cos_im[..., None], eta_c, k_c))
        # the VNDF weight: F G2 / G1(wi)
        sg = _sign(cos_i)
        g2 = mf.ggx_smith_g(wi * sg, wo_rc * sg, alpha)
        g1 = mf.ggx_smith_g1(wi * sg, alpha)
        w_rc = F_rc * params[..., 6:9] * (g2 / torch.clamp(g1, min=1e-12))[..., None]
        valid_rc = (cos_i > 0.0) & (wo_rc[..., 2] > 0.0)
        put(m_rc, wo_rc, torch.where(valid_rc, pdf_rc, 0.0),
            torch.where(valid_rc[..., None], w_rc, 0.0), falses, ones)

    if has(BSDF_POLARIZER):
        put(bsdf_type == BSDF_POLARIZER, -wi, ones, params[..., 3:6] * 0.5, ~falses, ones)

    if has(BSDF_NULL):
        put(bsdf_type == BSDF_NULL, -wi, ones, torch.ones_like(wi), ~falses, ones)

    ok = active & (out["pdf"] > 0.0)
    return BSDFSample(wo=out["wo"], pdf=torch.where(ok, out["pdf"], 0.0),
                      weight=torch.where(ok[..., None], out["weight"], 0.0),
                      delta=out["delta"], eta=out["eta"])


def eval_pdf(bsdf_type, params, wi, wo, active, present=None):
    """f(wi, wo) |cos theta_o| [N, 3] and the sampling pdf [N], for NEE
    and MIS.  Delta lobes evaluate to zero."""
    def has(t):
        return present is None or t in present

    n = wi.shape[0]
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    value = torch.zeros((n, 3), dtype=torch.float32, device=wi.device)
    pdf = torch.zeros((n,), dtype=torch.float32, device=wi.device)

    if has(BSDF_DIFFUSE):
        m_diff = (bsdf_type == BSDF_DIFFUSE) & (cos_i > 0.0) & (cos_o > 0.0)
        f_d = params[..., 0:3] * INV_PI * torch.clamp(cos_o, min=0.0)[..., None]
        value = torch.where(m_diff[..., None], f_d, value)
        pdf = torch.where(m_diff, torch.clamp(cos_o, min=0.0) * INV_PI, pdf)

    if has(BSDF_ROUGH_CONDUCTOR):
        alpha = torch.clamp(params[..., 9], min=1e-4)
        m_rc = (bsdf_type == BSDF_ROUGH_CONDUCTOR) & (cos_i > 0.0) & (cos_o > 0.0)
        h = wi + wo
        h = h / torch.sqrt(torch.clamp((h * h).sum(-1, keepdim=True), min=1e-24))
        d = mf.ggx_d(h, alpha)
        g = mf.ggx_smith_g(wi, wo, alpha)
        eta_c, k_c, is_mirror = _mirror_eta_k(params)
        cos_ih = torch.abs((wi * h).sum(-1))
        F_rc = torch.where(is_mirror[..., None], 1.0,
                           fresnel_conductor(cos_ih[..., None], eta_c, k_c))
        f_rc = F_rc * params[..., 6:9] * (d * g / torch.clamp(4.0 * cos_i, min=1e-12))[..., None]
        pdf_rc = mf.ggx_vndf_pdf(wi, h, alpha) / torch.clamp(4.0 * cos_ih, min=1e-12)
        value = torch.where(m_rc[..., None], f_rc, value)
        pdf = torch.where(m_rc, pdf_rc, pdf)

    value = torch.where(active[..., None], value, 0.0)
    pdf = torch.where(active, pdf, 0.0)
    return value, pdf
