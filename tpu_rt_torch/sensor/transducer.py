"""Transducer array geometry and ray generation (emitter / sensor pair).

Counterpart of ``tpu_rt/sensor/transducer.py``: linear or convex element
arrays, plane-wave steering with per-element transmit delays and optional
in-element jitter (``plane_wave_rays``), and the transducer emitter's and
sensor's own ray samplers (``emitter_sample_ray``, ``sensor_sample_ray``),
all mapped to world space by the sensor's ``to_world``.  The arithmetic
keeps the JAX package's order, so both packages give the same rays to
within float32 rounding of sin / cos.  Where tpu_rt draws from a JAX key,
the samplers here draw from a ``torch.Generator``, or take the uniforms
themselves (``uniforms=``), so a test can feed them tpu_rt's draws.
"""

from __future__ import annotations

import math

import torch

from tpu_rt_torch.core.warps import square_to_uniform_hemisphere
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
    if bool(torch.isinf(radius)) or float(radius.detach()) == 0.0:
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


def _aperture_point(us, center, j):
    """``center`` [n, 3] moved by the jitter ``j`` [n, 2] inside the
    element's width x height."""
    dx = (j[:, 0] - 0.5) * us.elements_width
    dy = (j[:, 1] - 0.5) * us.elements_height
    return center + torch.stack([dx, dy, torch.zeros_like(dx)], -1)


def plane_wave_rays(us: UltrasoundConfig, jitter=None):
    """Primary rays of the (angle x element) acquisition grid, angle-major:
    element positions from the integrator's pitch and element count,
    direction (sin a, 0, cos a), transmit delay (x sin a + z cos a) / c, all
    mapped by the sensor's ``to_world``.  Rays start at the element
    centers, or, given ``jitter`` [A*E, 2] uniforms, at a point of the
    element's width x height aperture (the delay keeps the center).
    Returns a dict of o [A*E, 3], d [A*E, 3], tx_delay [A*E], angle_idx,
    elem_idx, trans_normal [3], x_elem [E] and elem_pos [E, 3]."""
    A, E = us.n_angles, us.n_elements
    angles_rad = us.angles * math.radians(1.0)
    pos_local, _ = element_geometry(E, us.pitch, us.radius, us.opening_angle)

    ang = torch.repeat_interleave(angles_rad, E)
    pe = pos_local.repeat(A, 1)
    angle_idx = torch.repeat_interleave(torch.arange(A), E)
    elem_idx = torch.arange(E).repeat(A)

    sin_a, cos_a = torch.sin(ang), torch.cos(ang)
    d_local = torch.stack([sin_a, torch.zeros_like(ang), cos_a], -1)

    o_local = pe if jitter is None else _aperture_point(us, pe, jitter)
    m = us.sensor_to_world
    o = transform_point(m, o_local)
    d = normalize(transform_vector(m, d_local))
    tx_delay = (pe[:, 0] * sin_a + pe[:, 2] * cos_a) / us.sound_speed
    trans_n = normalize(transform_vector(m, _f32([0.0, 0.0, 1.0])))
    return dict(o=o, d=d, tx_delay=tx_delay, angle_idx=angle_idx,
                elem_idx=elem_idx, trans_normal=trans_n,
                x_elem=pos_local[:, 0], elem_pos=pos_local)


def emitter_sample_ray(us: UltrasoundConfig, n, gen=None, uniforms=None):
    """The transducer emitter's ray sampler (tpu_rt's ``emitter_sample_ray``,
    the reference's CustomEmitter.sample_ray): a random element, a point of
    its aperture, a steering angle psi uniform in [steering_angle_min,
    steering_angle_max], the delay -x sin(psi) / c and the weight
    max(0, d . n_elem) / (elements x rays per element).

    Draws ``uniforms`` = (element [n] int, aperture [n, 2], psi [n]) from
    ``gen`` unless they are given.  Returns (o [n, 3], d [n, 3],
    delay [n], weight [n])."""
    E = us.n_elements
    pos, nrm = element_geometry(E, us.pitch, us.radius, us.opening_angle)
    dev = pos.device
    if uniforms is None:
        uniforms = (torch.randint(0, E, (n,), generator=gen, device=dev),
                    torch.rand((n, 2), generator=gen, device=dev),
                    torch.rand((n,), generator=gen, device=dev))
    idx, j, u_psi = uniforms
    idx = idx.to(device=dev, dtype=torch.int64)
    p = _aperture_point(us, pos[idx], j)
    normal = nrm[idx]

    psi_min = _f32(us.steering_angle_min, dev) * math.radians(1.0)
    psi_max = _f32(us.steering_angle_max, dev) * math.radians(1.0)
    psi = psi_min + u_psi * (psi_max - psi_min)
    sin_psi = torch.sin(psi)
    d = torch.stack([sin_psi, torch.zeros_like(psi), torch.cos(psi)], -1)
    delay = -(p[:, 0] * sin_psi) / us.sound_speed
    n_total = E * max(us.number_of_rays_per_element, 1)
    weight = torch.clamp((d * normal).sum(-1), min=0.0) / n_total

    m = us.sensor_to_world
    return transform_point(m, p), normalize(transform_vector(m, d)), delay, weight


def sensor_sample_ray(us: UltrasoundConfig, n, time=0.0, gen=None, uniforms=None):
    """The ultrasound sensor's ray sampler (tpu_rt's ``sensor_sample_ray``):
    the element picked by a position sample among ``num_elements_lateral``,
    a point of its aperture, a uniform hemisphere direction, and the weight
    cos(2 pi f time) |d_local.z| directivity.

    Draws ``uniforms`` = (element [n], aperture [n, 2], direction [n, 2])
    from ``gen`` unless they are given.  Returns (o [n, 3], d [n, 3],
    weight [n])."""
    E = us.num_elements_lateral
    pos, _ = element_geometry(E, us.pitch, us.radius, us.opening_angle)
    dev = pos.device
    if uniforms is None:
        uniforms = tuple(torch.rand(shape, generator=gen, device=dev)
                         for shape in ((n,), (n, 2), (n, 2)))
    u, j, u_dir = uniforms
    idx = torch.clamp((u * E).to(torch.int64), max=E - 1)
    p = _aperture_point(us, pos[idx], j)
    d_local = square_to_uniform_hemisphere(u_dir)
    weight = (torch.cos(2.0 * math.pi * us.frequency * time) * torch.abs(d_local[:, 2])
              * us.directivity)
    m = us.sensor_to_world
    return transform_point(m, p), normalize(transform_vector(m, d_local)), weight
