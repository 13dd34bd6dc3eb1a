"""Acoustic (ultrasound) GGX rough reflection / transmission BSDF.

Counterpart of ``tpu_rt/bsdf/acoustic.py``: impedance-based pressure
reflection and transmission about a GGX microfacet normal drawn from the
visible-normal distribution.  The same formulas in the same order: Snell
with the impedance ratio (kept from the reference for parity), total
internal reflection, R = (Z2 cos_i - Z1 cos_t) / (Z2 cos_i + Z1 cos_t),
T = 1 + R, the lobe chosen with probability R^2 clipped to [0.05, 0.95]
(1 under total internal reflection) and the amplitude divided by that
probability, so the estimator is unbiased.

Parameter layout (a ``bsdf_params`` row of type BSDF_ULTRASOUND):
[0] interior impedance, [1] roughness (GGX alpha, clipped to
[1e-3, 1]), [2] exterior impedance (1.2 where it is not positive).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpu_rt_torch.bsdf.microfacet import ggx_sample_vndf
from tpu_rt_torch.core.math import safe_sqrt


@dataclass
class AcousticSample:
    wo: torch.Tensor  # [N, 3] local outgoing direction
    amplitude: torch.Tensor  # [N] pressure amplitude factor (R or T over its probability)
    reflected: torch.Tensor  # [N] bool
    valid: torch.Tensor  # [N] bool


def sample(params, wi, s1, s2, active):
    """Sample the acoustic BSDF in the local shading frame.

    ``params`` [N, 16] BSDF rows, ``wi`` [N, 3] the local direction toward
    the ray origin, ``s1`` [N] the lobe sample, ``s2`` [N, 2] the
    microfacet sample, ``active`` [N] bool (inactive lanes get amplitude
    0)."""
    z_int = params[..., 0]
    z_ext = torch.where(params[..., 2] > 0.0, params[..., 2], 1.2)
    alpha = torch.clamp(params[..., 1], 1e-3, 1.0)

    m = ggx_sample_vndf(wi, alpha, s2)

    cos_im = (wi * m).sum(-1)  # > 0 by the VNDF's construction
    entering = wi[..., 2] > 0.0
    Z1 = torch.where(entering, z_ext, z_int)
    Z2 = torch.where(entering, z_int, z_ext)

    ratio = Z1 / torch.clamp(Z2, min=1e-6)
    cos_i = torch.abs(cos_im)
    sin_t_sqr = ratio * ratio * (1.0 - cos_i * cos_i)
    tir = sin_t_sqr > 1.0
    cos_t = safe_sqrt(1.0 - sin_t_sqr)

    denom = Z2 * cos_i + Z1 * cos_t
    R = (Z2 * cos_i - Z1 * cos_t) / torch.clamp(denom, min=1e-9)
    T = 1.0 + R

    wo_r = 2.0 * cos_im[..., None] * m - wi
    # refraction about m: the direction continues through the surface
    wo_t = -ratio[..., None] * wi + (ratio * cos_i - cos_t)[..., None] * m

    prob_reflect = torch.clamp(R * R, 0.05, 0.95)
    prob_reflect = torch.where(tir, 1.0, prob_reflect)
    pick_reflect = (s1 < prob_reflect) | tir

    wo = torch.where(pick_reflect[..., None], wo_r, wo_t)
    wo = wo / torch.sqrt(torch.clamp((wo * wo).sum(-1, keepdim=True), min=1e-24))
    amp = torch.where(pick_reflect, torch.abs(R) / prob_reflect,
                      torch.abs(T) / torch.clamp(1.0 - prob_reflect, min=1e-6))
    return AcousticSample(wo=wo, amplitude=torch.where(active, amp, 0.0),
                          reflected=pick_reflect, valid=active)
