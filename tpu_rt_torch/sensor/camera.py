"""Perspective camera rays.

Counterpart of ``tpu_rt/sensor/camera.py``: Mitsuba's look_at convention,
film u left to right along +X_camera, film v top to bottom along
-Y_camera.  ``sample_ray_extents`` also gives the near / far clip planes
as ray extents (the wavefront tracer applies them to the primary
segment); ``sample_ray`` drops them (the direct mesh kernel ignores near
and far, as tpu_rt's does).
"""

from __future__ import annotations

import torch

from tpu_rt_torch.scene.types import Camera

_EPS = 1e-7  # tpu_rt/core/math.py EPS, the floor of normalize's length


def sample_ray(cam: Camera, film_xy):
    """World-space camera rays through continuous film positions
    ``film_xy`` [..., 2] in pixels ([0, W) x [0, H), (0, 0) top left).
    Returns (o, d), each [..., 3] on ``film_xy``'s device."""
    o, d, _, _ = sample_ray_extents(cam, film_xy)
    return o, d


def sample_ray_extents(cam: Camera, film_xy):
    """Camera rays plus Mitsuba's clip-plane extents: near and far are
    measured along the camera's z axis, so along the normalised direction
    they sit at near * |d_cam| and far * |d_cam|.  Returns (o, d [..., 3],
    tmin, tmax [...])."""
    dev = film_xy.device
    m = cam.to_world.to(dev)
    u = film_xy[..., 0] / cam.width
    v = film_xy[..., 1] / cam.height
    dx = (2.0 * u - 1.0) * cam.tan_fov_x.to(dev)
    dy = (1.0 - 2.0 * v) * cam.tan_fov_y.to(dev)
    d = torch.stack([m[0, 0] * dx + m[0, 1] * dy + m[0, 2],
                     m[1, 0] * dx + m[1, 1] * dy + m[1, 2],
                     m[2, 0] * dx + m[2, 1] * dy + m[2, 2]], dim=-1)
    length = torch.sqrt(torch.clamp((d * d).sum(-1, keepdim=True), min=1e-24))
    d = d * torch.reciprocal(torch.clamp(length, min=_EPS))
    o = m[:3, 3].expand(d.shape)
    inv_z = torch.sqrt(dx * dx + dy * dy + 1.0)  # |d_cam| = 1 / d_z
    return o, d, cam.near.to(dev) * inv_z, cam.far.to(dev) * inv_z
