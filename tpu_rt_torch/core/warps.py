"""Warps of [0, 1)^2 samples to disks, hemispheres, spheres, triangles and
cones, with their pdfs.

Counterpart of ``tpu_rt/core/warps.py`` (Mitsuba's ``mi.warp``).
"""

from __future__ import annotations

import math

import torch

from tpu_rt_torch.core.math import safe_sqrt, vec3

INV_PI = 1.0 / math.pi
INV_TWO_PI = 1.0 / (2.0 * math.pi)
INV_FOUR_PI = 1.0 / (4.0 * math.pi)


def square_to_uniform_disk_concentric(sample):
    """Shirley's concentric mapping of the unit square to the unit disk."""
    x = 2.0 * sample[..., 0] - 1.0
    y = 2.0 * sample[..., 1] - 1.0
    is_zero = (x == 0.0) & (y == 0.0)
    quadrant_x = torch.abs(x) > torch.abs(y)
    r = torch.where(quadrant_x, x, y)
    phi = torch.where(
        quadrant_x,
        (math.pi / 4.0) * (y / torch.where(x == 0.0, 1.0, x)),
        (math.pi / 2.0) - (math.pi / 4.0) * (x / torch.where(y == 0.0, 1.0, y)),
    )
    phi = torch.where(is_zero, 0.0, phi)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], -1)


def square_to_uniform_hemisphere(sample):
    z = sample[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * sample[..., 1]
    return vec3(r * torch.cos(phi), r * torch.sin(phi), z)


def square_to_uniform_hemisphere_pdf():
    return INV_TWO_PI


def square_to_cosine_hemisphere(sample):
    """Cosine-weighted direction on the +Z hemisphere."""
    d = square_to_uniform_disk_concentric(sample)
    z = safe_sqrt(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2)
    return vec3(d[..., 0], d[..., 1], z)


def square_to_cosine_hemisphere_pdf(wo):
    return torch.clamp(wo[..., 2], min=0.0) * INV_PI


def square_to_uniform_sphere(sample):
    z = 1.0 - 2.0 * sample[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * sample[..., 1]
    return vec3(r * torch.cos(phi), r * torch.sin(phi), z)


def square_to_uniform_sphere_pdf():
    return INV_FOUR_PI


def square_to_uniform_triangle(sample):
    """Barycentric (u, v), uniform over a triangle."""
    t = safe_sqrt(1.0 - sample[..., 0])
    return torch.stack([1.0 - t, t * sample[..., 1]], -1)


def square_to_uniform_cone(sample, cos_cutoff):
    """Uniform direction in the cone around +Z with cos >= cos_cutoff."""
    z = 1.0 + sample[..., 0] * (cos_cutoff - 1.0)
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * sample[..., 1]
    return vec3(r * torch.cos(phi), r * torch.sin(phi), z)


def square_to_uniform_cone_pdf(cos_cutoff):
    return INV_TWO_PI / (1.0 - cos_cutoff)
