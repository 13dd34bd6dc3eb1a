"""Isotropic GGX microfacet distribution: D, Smith G, VNDF sampling and
its pdf, and the classic inverse-CDF theta sampler with its pdf.

Counterpart of ``tpu_rt/bsdf/microfacet.py``; the same cancellation-free
forms and clamps.  Directions are in the local shading frame (+Z = n).
"""

from __future__ import annotations

import math

import torch

from tpu_rt_torch.core.math import cross, normalize, safe_sqrt, vec3


def ggx_d(m, alpha):
    """D(m) = a^2 / (pi (a^2 cos^2 + sin^2)^2); zero below the surface."""
    cos_theta = m[..., 2]
    c2 = cos_theta * cos_theta
    s2 = torch.clamp(1.0 - c2, min=0.0)
    a2 = alpha * alpha
    denom = a2 * c2 + s2
    d = a2 / torch.clamp(math.pi * denom * denom, min=1e-18)
    return torch.where(cos_theta > 0.0, d, 0.0)


def ggx_smith_g1(v, alpha):
    """Smith masking G1(v)."""
    cos_v = v[..., 2]
    tan2 = torch.clamp(1.0 - cos_v * cos_v, min=0.0) / torch.clamp(cos_v * cos_v, min=1e-12)
    lam = 0.5 * (safe_sqrt(1.0 + alpha * alpha * tan2) - 1.0)
    g1 = 1.0 / (1.0 + lam)
    return torch.where(cos_v != 0.0, g1, 0.0)


def ggx_smith_g(wi, wo, alpha):
    """Separable Smith shadowing-masking G(wi, wo)."""
    return ggx_smith_g1(wi, alpha) * ggx_smith_g1(wo, alpha)


def _sign_nonzero(x):
    return torch.sign(torch.where(x == 0.0, 1.0, x))


def ggx_sample_vndf(wi, alpha, sample2):
    """A visible GGX normal (Heitz 2018, spherical caps) on the hemisphere
    around +Z oriented toward ``wi``."""
    flip = _sign_nonzero(wi[..., 2])[..., None]
    wi_f = wi * flip
    vh = normalize(vec3(alpha * wi_f[..., 0], alpha * wi_f[..., 1], wi_f[..., 2]))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = 1.0 / safe_sqrt(torch.clamp(lensq, min=1e-20))
    zeros = torch.zeros_like(inv_len)
    t1 = torch.where((lensq > 1e-20)[..., None],
                     vec3(-vh[..., 1] * inv_len, vh[..., 0] * inv_len, zeros),
                     vec3(zeros + 1.0, zeros, zeros))
    t2 = cross(vh, t1)
    u1, u2 = sample2[..., 0], sample2[..., 1]
    r = safe_sqrt(u1)
    phi = 2.0 * math.pi * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * safe_sqrt(1.0 - p1 * p1) + s * p2
    nh = (p1[..., None] * t1 + p2[..., None] * t2
          + safe_sqrt(1.0 - p1 * p1 - p2 * p2)[..., None] * vh)
    m = normalize(vec3(alpha * nh[..., 0], alpha * nh[..., 1],
                       torch.clamp(nh[..., 2], min=1e-6)))
    return m * flip


def ggx_vndf_pdf(wi, m, alpha):
    """pdf of ``ggx_sample_vndf`` in the half-vector measure:
    G1(wi) max(wi.m, 0) D(m) / |wi.z|."""
    flip = _sign_nonzero(wi[..., 2])[..., None]
    wi_f = wi * flip
    m_f = m * flip
    cos_im = torch.clamp((wi_f * m_f).sum(-1), min=0.0)
    pdf = (ggx_smith_g1(wi_f, alpha) * cos_im * ggx_d(m_f, alpha)
           / torch.clamp(torch.abs(wi_f[..., 2]), min=1e-12))
    return torch.clamp(pdf, min=0.0)



def ggx_sample_theta_invcdf(xi, alpha):
    """Inverse-CDF sampling of the GGX D(m) cos half-angle theta:
    cos(theta) = sqrt((1 - xi) / (1 + (alpha^2 - 1) xi)).  The classic
    sampler, kept for the chi-square test of its distribution against
    ``ggx_theta_pdf``."""
    a2 = alpha * alpha
    cos_theta = safe_sqrt((1.0 - xi) / (1.0 + (a2 - 1.0) * xi))
    return torch.arccos(torch.clamp(cos_theta, -1.0, 1.0))


def ggx_theta_pdf(theta, alpha):
    """pdf in the theta measure of D(m) cos(theta) sampling:
    D(theta) cos sin 2 pi."""
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    a2 = alpha * alpha
    denom = cos_t * cos_t * (a2 - 1.0) + 1.0
    d = a2 / torch.clamp(math.pi * denom * denom, min=1e-20)
    return d * cos_t * sin_t * 2.0 * math.pi
