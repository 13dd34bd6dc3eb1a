"""Transducer array geometry and plane-wave ray generation.

Counterpart of ``tpu_rt/sensor/transducer.py`` (``element_geometry``,
``plane_wave_rays``): linear or convex element arrays, plane-wave steering
with per-element transmit delays, mapped to world space by the sensor's
``to_world``.  The arithmetic keeps the JAX package's order, so both
packages give the same rays to within float32 rounding of sin / cos.
"""

from __future__ import annotations

import math

import torch

from tpu_rt_torch.scene.types import UltrasoundConfig

_EPS = 1e-7  # tpu_rt.core.math.EPS


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def normalize(v):
    """v / |v| along the last axis, as ``tpu_rt.core.math.normalize``."""
    length = torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=1e-24))
    return v * torch.reciprocal(torch.clamp(length, min=_EPS))


def transform_point(m, p):
    """Apply the 4x4 ``m`` to points ``p`` (..., 3)."""
    return torch.stack([m[i, 0] * p[..., 0] + m[i, 1] * p[..., 1]
                        + m[i, 2] * p[..., 2] + m[i, 3] for i in range(3)], -1)


def transform_vector(m, v):
    return torch.stack([m[i, 0] * v[..., 0] + m[i, 1] * v[..., 1]
                        + m[i, 2] * v[..., 2] for i in range(3)], -1)


def element_geometry(n_elements, pitch, radius, opening_angle_deg=0.0):
    """Element center positions and normals in transducer-local space.

    A linear array when ``radius`` is inf or 0, a convex arc otherwise
    (spread over ``opening_angle_deg`` when it is positive, else
    theta = (i - N/2) * pitch / R).  Returns (positions [N, 3],
    normals [N, 3]) as float32 tensors."""
    pitch = _f32(pitch)
    radius = _f32(radius, pitch.device)
    i = torch.arange(n_elements, dtype=torch.float32, device=pitch.device)
    zeros = torch.zeros_like(i)
    if bool(torch.isinf(radius)) or float(radius) == 0.0:
        x_lin = pitch * (i - (n_elements - 1) * 0.5)
        pos = torch.stack([x_lin, zeros, zeros], -1)
        nrm = torch.stack([zeros, zeros, zeros + 1.0], -1)
        return pos, nrm
    if opening_angle_deg and opening_angle_deg > 0.0:
        span = _f32(opening_angle_deg, pitch.device) * math.radians(1.0)
        thetas = torch.linspace(float(-span / 2), float(span / 2), n_elements,
                                dtype=torch.float32, device=pitch.device)
    else:
        thetas = (i - n_elements / 2.0) * pitch / radius
    pos = torch.stack([radius * torch.sin(thetas), zeros,
                       radius * (1.0 - torch.cos(thetas))], -1)
    nrm = normalize(torch.stack([torch.sin(thetas), zeros, torch.cos(thetas)], -1))
    return pos, nrm


def plane_wave_rays(us: UltrasoundConfig):
    """Primary rays of the (angle x element) acquisition grid, angle-major:
    element positions from the integrator's pitch and element count,
    direction (sin a, 0, cos a), transmit delay (x sin a + z cos a) / c, all
    mapped by the sensor's ``to_world``; rays start at the element
    centers.  Returns a dict of o [A*E, 3], d [A*E, 3], tx_delay [A*E],
    angle_idx, elem_idx, trans_normal [3], x_elem [E] and elem_pos [E, 3]."""
    A, E = us.n_angles, us.n_elements
    angles_rad = us.angles * math.radians(1.0)
    pos_local, _ = element_geometry(E, us.pitch, us.radius, us.opening_angle)

    ang = torch.repeat_interleave(angles_rad, E)
    pe = pos_local.repeat(A, 1)
    angle_idx = torch.repeat_interleave(torch.arange(A), E)
    elem_idx = torch.arange(E).repeat(A)

    sin_a, cos_a = torch.sin(ang), torch.cos(ang)
    d_local = torch.stack([sin_a, torch.zeros_like(ang), cos_a], -1)

    m = us.sensor_to_world
    o = transform_point(m, pe)
    d = normalize(transform_vector(m, d_local))
    tx_delay = (pe[:, 0] * sin_a + pe[:, 2] * cos_a) / us.sound_speed
    trans_n = normalize(transform_vector(m, _f32([0.0, 0.0, 1.0])))
    return dict(o=o, d=d, tx_delay=tx_delay, angle_idx=angle_idx,
                elem_idx=elem_idx, trans_normal=trans_n,
                x_elem=pos_local[:, 0], elem_pos=pos_local)
