"""Analytic primitive intersectors over [..., 3] rays.

Counterpart of ``tpu_rt/geometry/intersect.py``.  Every analytic shape is
canonical in object space: sphere |p| = 1; rectangle z = 0, |x|, |y| <= 1;
disk z = 0, x^2 + y^2 <= 1; cylinder x^2 + y^2 = 1, 0 <= z <= 1; cone
x^2 + y^2 = (1 - z)^2, 0 <= z <= 1; round cone (a swept-sphere curve
segment) from radius r0 at z = 0 to r1 at z = 1.  Each returns (t, u, v)
with t = INF on a miss.

INF is a large but finite miss sentinel and the denominators are clamped
away from 0, so that reverse mode never multiplies an infinity by 0 (the
autograd route, A9, differentiates through these).
"""

from __future__ import annotations

import math

import torch

from tpu_rt_torch.core.math import cross, dot, safe_sqrt

INF = 1e8


def _clamp_abs(x, eps):
    """x with |x| kept >= eps, its sign kept."""
    return torch.where(torch.abs(x) < eps, torch.where(x < 0, -eps, eps), x)


def _select_root(t0, t1, valid0, valid1):
    """The nearer valid root of a quadratic, else INF."""
    return torch.where(valid0, t0, torch.where(valid1, t1, INF))


def ray_sphere(o, d, tmin, tmax):
    b = 2.0 * dot(o, d)
    a = dot(d, d)
    c = dot(o, o) - 1.0
    disc = b * b - 4.0 * a * c
    hit = disc >= 0.0
    q = -0.5 * (b + torch.sign(b) * safe_sqrt(disc))
    qa = q / torch.clamp(a, min=1e-9)
    cq = c / _clamp_abs(q, 1e-9)
    t0 = torch.minimum(qa, cq)
    t1 = torch.maximum(qa, cq)
    v0 = hit & (t0 > tmin) & (t0 < tmax)
    v1 = hit & (t1 > tmin) & (t1 < tmax)
    t = _select_root(t0, t1, v0, v1)
    return t, torch.zeros_like(t), torch.zeros_like(t)


def ray_rectangle(o, d, tmin, tmax):
    dz = d[..., 2]
    t = -o[..., 2] / _clamp_abs(dz, 1e-9)
    x = o[..., 0] + t * d[..., 0]
    y = o[..., 1] + t * d[..., 1]
    ok = ((torch.abs(dz) > 1e-20) & (t > tmin) & (t < tmax)
          & (torch.abs(x) <= 1.0) & (torch.abs(y) <= 1.0))
    return torch.where(ok, t, INF), 0.5 * (x + 1.0), 0.5 * (y + 1.0)


def ray_disk(o, d, tmin, tmax):
    dz = d[..., 2]
    t = -o[..., 2] / _clamp_abs(dz, 1e-9)
    x = o[..., 0] + t * d[..., 0]
    y = o[..., 1] + t * d[..., 1]
    r2 = x * x + y * y
    ok = (torch.abs(dz) > 1e-20) & (t > tmin) & (t < tmax) & (r2 <= 1.0)
    return (torch.where(ok, t, INF), safe_sqrt(r2),
            torch.atan2(y, x) / (2.0 * math.pi) + 0.5)


def ray_cylinder(o, d, tmin, tmax):
    ox, oy = o[..., 0], o[..., 1]
    dx, dy = d[..., 0], d[..., 1]
    a = dx * dx + dy * dy
    b = 2.0 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - 1.0
    disc = b * b - 4.0 * a * c
    hit = (disc >= 0.0) & (a > 1e-20)
    sq = safe_sqrt(disc)
    t0 = (-b - sq) / torch.clamp(2.0 * a, min=1e-9)
    t1 = (-b + sq) / torch.clamp(2.0 * a, min=1e-9)

    def z_ok(t):
        z = o[..., 2] + t * d[..., 2]
        return (z >= 0.0) & (z <= 1.0)

    v0 = hit & (t0 > tmin) & (t0 < tmax) & z_ok(t0)
    v1 = hit & (t1 > tmin) & (t1 < tmax) & z_ok(t1)
    t = _select_root(t0, t1, v0, v1)
    z = o[..., 2] + t * d[..., 2]
    phi = torch.atan2(o[..., 1] + t * d[..., 1], o[..., 0] + t * d[..., 0])
    return t, phi / (2.0 * math.pi) + 0.5, z


def ray_cone(o, d, tmin, tmax):
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    k = 1.0 - oz
    a = dx * dx + dy * dy - dz * dz
    b = 2.0 * (ox * dx + oy * dy + k * dz)
    c = ox * ox + oy * oy - k * k
    disc = b * b - 4.0 * a * c
    lin = torch.abs(a) < 1e-12
    hit = (disc >= 0.0) & ~lin
    sq = safe_sqrt(disc)
    a_safe = torch.where(lin, 1.0, a)
    r0 = (-b - sq) / (2.0 * a_safe)
    r1 = (-b + sq) / (2.0 * a_safe)
    t0 = torch.minimum(r0, r1)
    t1 = torch.maximum(r0, r1)
    # a ray parallel to the surface: the one root of c + b t = 0
    t_lin = -c / _clamp_abs(b, 1e-9)

    def z_ok(t):
        z = oz + t * dz
        return (z >= 0.0) & (z <= 1.0)

    v0 = hit & (t0 > tmin) & (t0 < tmax) & z_ok(t0)
    v1 = hit & (t1 > tmin) & (t1 < tmax) & z_ok(t1)
    vl = lin & (t_lin > tmin) & (t_lin < tmax) & z_ok(t_lin)
    t = _select_root(t0, t1, v0, v1)
    t = torch.where(vl & ~(v0 | v1), t_lin, t)
    z = oz + t * dz
    phi = torch.atan2(oy + t * dy, ox + t * dx)
    return t, phi / (2.0 * math.pi) + 0.5, z


def ray_roundcone(o, d, r0, r1, tmin, tmax):
    """The swept sphere from centre (0, 0, 0), radius r0, to (0, 0, 1),
    radius r1 (|r1 - r0| < 1): its side is the envelope cone, its ends the
    parts of the end spheres outside the tangency band.  Returns (t, u, v)
    with u the clamped tangency parameter and v the azimuth in [0, 1)."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    dr = r1 - r0
    d2c = 1.0 - dr * dr
    dd = dx * dx + dy * dy + dz * dz
    od_ = ox * dx + oy * dy + oz * dz
    oo = ox * ox + oy * oy + oz * oz
    b1 = oz + r0 * dr

    def safe_div(num, den, eps=1e-12):
        return num / _clamp_abs(den, eps)

    k2 = d2c * dd - dz * dz
    k1 = d2c * od_ - dz * b1
    k0 = d2c * (oo - r0 * r0) - b1 * b1
    disc = k1 * k1 - k2 * k0
    sq = safe_sqrt(disc)
    ta = safe_div(-k1 - sq, k2)
    tb = safe_div(-k1 + sq, k2)
    t0 = torch.minimum(ta, tb)
    t1 = torch.maximum(ta, tb)

    def side_ok(t):
        s = safe_div(b1 + t * dz, d2c)
        return ((disc >= 0.0) & (torch.abs(k2) >= 1e-12) & (s >= 0.0) & (s <= 1.0)
                & (t > tmin) & (t < tmax))

    t_side = _select_root(t0, t1, side_ok(t0), side_ok(t1))

    def cap(cz, r, outside_lo):
        b = od_ - cz * dz
        c = oo - 2.0 * cz * oz + cz * cz - r * r
        dc = b * b - dd * c
        sqc = safe_sqrt(dc)
        u0 = safe_div(-b - sqc, dd)
        u1 = safe_div(-b + sqc, dd)

        def ok(t):
            s = safe_div(b1 + t * dz, d2c)
            band = (s < 0.0) if outside_lo else (s > 1.0)
            return (dc >= 0.0) & band & (t > tmin) & (t < tmax)

        return _select_root(u0, u1, ok(u0), ok(u1))

    t = torch.minimum(t_side, torch.minimum(cap(0.0, r0, True), cap(1.0, r1, False)))
    s_hit = torch.clamp(safe_div(b1 + t * dz, d2c), 0.0, 1.0)
    phi = torch.atan2(oy + t * dy, ox + t * dx)
    u = torch.where(t < INF, s_hit, 0.0)
    v = torch.where(t < INF, phi / (2.0 * math.pi) + 0.5, 0.0)
    return t, u, v


def ray_triangle(o, d, p0, e1, e2, tmin, tmax):
    """Moller-Trumbore, all arguments broadcasting over [..., 3]; (u, v)
    are the barycentrics of e1 and e2."""
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    inv_det = 1.0 / _clamp_abs(det, 1e-9)
    tvec = o - p0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    ok = ((torch.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > tmin) & (t < tmax))
    return torch.where(ok, t, INF), u, v


def ray_aabb(o, inv_d, bb_min, bb_max, tmin, tmax):
    """Slab test; returns (hit, t_near)."""
    t0 = (bb_min - o) * inv_d
    t1 = (bb_max - o) * inv_d
    t_near = torch.maximum(torch.minimum(t0, t1).amax(-1), torch.as_tensor(tmin))
    t_far = torch.minimum(torch.maximum(t0, t1).amin(-1), torch.as_tensor(tmax))
    return t_near <= t_far, t_near
