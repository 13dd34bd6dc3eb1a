"""Vector, transform, frame and Fresnel math on [..., 3] tensors.

Counterpart of the device-side half of ``tpu_rt/core/math.py``; the host
builders (translate, scale, rotate, look_at, inverse) live in
``scene/transforms.py``.  Same formulas, same guards: lengths are clamped
above 0 before the square root, and the Fresnel denominators are clamped,
so that reverse mode never meets 0 * inf (the autograd route, A9, runs
through these).  Transforms are 4x4 matrices acting on column vectors and
are applied as explicit multiply-adds, as in tpu_rt.

tpu_rt's ``small_table_lookup`` (a select chain that stood in for small
gathers on the TPU) is plain indexing here.
"""

from __future__ import annotations

import torch

EPS = 1e-7


def dot(a, b, keepdim=False):
    return (a * b).sum(-1, keepdim=keepdim)


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def length(v, keepdim=False):
    return torch.sqrt(torch.clamp(dot(v, v, keepdim=keepdim), min=1e-24))


def normalize(v):
    return v * torch.reciprocal(torch.clamp(length(v, keepdim=True), min=EPS))


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=1e-20))


def vec3(x, y, z):
    """Stack tensor components (broadcasting) into a [..., 3] vector."""
    return torch.stack(torch.broadcast_tensors(x, y, z), -1)


def transform_point(m, p):
    """Apply the 4x4 ``m`` [..., 4, 4] to points ``p`` [..., 3]."""
    r = m[..., :3, :3]
    return vec3(
        r[..., 0, 0] * p[..., 0] + r[..., 0, 1] * p[..., 1] + r[..., 0, 2] * p[..., 2]
        + m[..., 0, 3],
        r[..., 1, 0] * p[..., 0] + r[..., 1, 1] * p[..., 1] + r[..., 1, 2] * p[..., 2]
        + m[..., 1, 3],
        r[..., 2, 0] * p[..., 0] + r[..., 2, 1] * p[..., 1] + r[..., 2, 2] * p[..., 2]
        + m[..., 2, 3],
    )


def transform_vector(m, v):
    r = m[..., :3, :3]
    return vec3(
        r[..., 0, 0] * v[..., 0] + r[..., 0, 1] * v[..., 1] + r[..., 0, 2] * v[..., 2],
        r[..., 1, 0] * v[..., 0] + r[..., 1, 1] * v[..., 1] + r[..., 1, 2] * v[..., 2],
        r[..., 2, 0] * v[..., 0] + r[..., 2, 1] * v[..., 1] + r[..., 2, 2] * v[..., 2],
    )


def coordinate_system(n):
    """Duff et al.'s branchless tangent and bitangent (s, t) of unit n."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    s = vec3(1.0 + sign * n[..., 0] ** 2 * a, sign * b, -sign * n[..., 0])
    t = vec3(b, sign + n[..., 1] ** 2 * a, -n[..., 1])
    return s, t


def to_local(n, s, t, v):
    """World vector v -> the local frame where n = +Z."""
    return vec3(dot(v, s), dot(v, t), dot(v, n))


def to_world(n, s, t, v):
    return s * v[..., 0:1] + t * v[..., 1:2] + n * v[..., 2:3]


def reflect(wi, n):
    """Reflect ``wi`` (pointing away from the surface) about n."""
    return 2.0 * dot(wi, n, keepdim=True) * n - wi


def reflect_local(wi):
    """Reflect about +Z in the local frame."""
    return vec3(-wi[..., 0], -wi[..., 1], wi[..., 2])


def refract_local(wi, cos_theta_t, eta_ti):
    """Refract in the local frame: ``eta_ti`` scales the tangential part,
    ``cos_theta_t`` carries the transmitted z with its sign."""
    return vec3(-eta_ti * wi[..., 0], -eta_ti * wi[..., 1], cos_theta_t)


def fresnel_dielectric(cos_theta_i, eta):
    """Unpolarized dielectric Fresnel reflectance (Mitsuba's fresnel()):
    ``eta`` is the relative IOR.  Returns (F, cos_theta_t with the sign
    opposite to cos_theta_i, eta_it, eta_ti)."""
    outside = cos_theta_i >= 0.0
    rcp_eta = 1.0 / eta
    eta_it = torch.where(outside, eta, rcp_eta)
    eta_ti = torch.where(outside, rcp_eta, eta)
    cos_theta_t_sqr = 1.0 - eta_ti * eta_ti * (1.0 - cos_theta_i * cos_theta_i)
    abs_cos_i = torch.abs(cos_theta_i)
    cos_theta_t = safe_sqrt(cos_theta_t_sqr)
    rs = (abs_cos_i - eta_it * cos_theta_t) / torch.clamp(
        abs_cos_i + eta_it * cos_theta_t, min=1e-9)
    rp = (eta_it * abs_cos_i - cos_theta_t) / torch.clamp(
        eta_it * abs_cos_i + cos_theta_t, min=1e-9)
    F = 0.5 * (rs * rs + rp * rp)
    F = torch.where(cos_theta_t_sqr <= 0.0, 1.0, F)  # total internal reflection
    cos_theta_t_signed = torch.where(cos_theta_i >= 0.0, -cos_theta_t, cos_theta_t)
    return F, cos_theta_t_signed, eta_it, eta_ti


def fresnel_conductor(cos_theta_i, eta, k):
    """Unpolarized conductor Fresnel reflectance for the complex IOR
    eta + i k (per channel, broadcasting against cos_theta_i)."""
    c2 = cos_theta_i * cos_theta_i
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - s2
    a2b2 = safe_sqrt(t0 * t0 + 4.0 * e2 * k2)
    t1 = a2b2 + c2
    a = safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * cos_theta_i
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-12)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-12)
    return 0.5 * (rs + rp)


def mis_power_heuristic(pdf_a, pdf_b):
    """The power heuristic with beta = 2."""
    a2 = pdf_a * pdf_a
    w = a2 / torch.clamp(a2 + pdf_b * pdf_b, min=1e-20)
    return torch.where(pdf_a > 0.0, w, 0.0)


def luminance(rgb):
    return rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160 + rgb[..., 2] * 0.072169

