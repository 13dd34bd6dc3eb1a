"""Uniform cubic B-spline curves for the ``bsplinecurve`` shape.

Counterpart of ``tpu_rt/scene/curves.py``, the same float64 numpy code.
A control-point file holds rows of ``x y z radius``.  ``flatten_bspline``
samples the spline into linear spans for the exact swept-sphere prims;
``tessellate_bspline_tube`` sweeps circles along it into a tube mesh.
"""

from __future__ import annotations

import numpy as np


def load_curve_points(path):
    pts = np.loadtxt(path, dtype=np.float64).reshape(-1, 4)
    return pts


def _bspline_eval(cp, t):
    """Evaluate a uniform cubic B-spline with control points cp [N, D] at
    parameters t in [0, 1] mapped over the valid knot span."""
    n = cp.shape[0]
    n_seg = n - 3
    u = t * n_seg
    seg = np.minimum(u.astype(np.int64), n_seg - 1)
    x = (u - seg)[:, None]
    c0 = cp[seg]
    c1 = cp[seg + 1]
    c2 = cp[seg + 2]
    c3 = cp[seg + 3]
    b0 = (1 - x) ** 3 / 6.0
    b1 = (3 * x**3 - 6 * x**2 + 4) / 6.0
    b2 = (-3 * x**3 + 3 * x**2 + 3 * x + 1) / 6.0
    b3 = x**3 / 6.0
    return b0 * c0 + b1 * c1 + b2 * c2 + b3 * c3


def flatten_bspline(path, samples_per_span=4):
    """Sample the cubic B-spline (positions + radii) densely enough that the
    chord error is far below the tube radius; the exact swept-sphere
    intersector (geometry/intersect.ray_roundcone) then intersects each
    linear segment in closed form.  Returns (P, 4) rows of x y z r."""
    cp = load_curve_points(path)
    n_span = max(cp.shape[0] - 3, 1)
    t = np.linspace(0.0, 1.0, n_span * samples_per_span + 1)
    pts = _bspline_eval(cp, t)
    pts[:, 3] = np.maximum(pts[:, 3], 1e-6)
    return pts


def tessellate_bspline_tube(path, samples_per_segment=8, sides=8):
    """Sweep circles along the spline, producing (vertices, faces, normals)."""
    cp = load_curve_points(path)
    n_seg = max(cp.shape[0] - 3, 1)
    t = np.linspace(0.0, 1.0, n_seg * samples_per_segment + 1)
    pts = _bspline_eval(cp, t)
    centers, radii = pts[:, :3], np.maximum(pts[:, 3], 1e-6)

    # Tangents and a rotation-minimizing-ish frame.
    tang = np.gradient(centers, axis=0)
    tang /= np.maximum(np.linalg.norm(tang, axis=-1, keepdims=True), 1e-12)
    normal = np.zeros_like(tang)
    ref = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(tang[0], ref)) > 0.9:
        ref = np.array([0.0, 1.0, 0.0])
    normal[0] = np.cross(tang[0], ref)
    normal[0] /= max(np.linalg.norm(normal[0]), 1e-12)
    for i in range(1, len(tang)):
        n = normal[i - 1] - tang[i] * np.dot(normal[i - 1], tang[i])
        ln = np.linalg.norm(n)
        normal[i] = n / ln if ln > 1e-9 else normal[i - 1]
    binorm = np.cross(tang, normal)

    phis = np.linspace(0, 2 * np.pi, sides, endpoint=False)
    ring = (
        np.cos(phis)[None, :, None] * normal[:, None, :]
        + np.sin(phis)[None, :, None] * binorm[:, None, :]
    )
    verts = centers[:, None, :] + radii[:, None, None] * ring
    vnorm = ring
    V = verts.reshape(-1, 3).astype(np.float32)
    N = vnorm.reshape(-1, 3).astype(np.float32)

    faces = []
    rings = verts.shape[0]
    for i in range(rings - 1):
        for j in range(sides):
            a = i * sides + j
            b = i * sides + (j + 1) % sides
            c = (i + 1) * sides + j
            d = (i + 1) * sides + (j + 1) % sides
            faces.append((a, b, d))
            faces.append((a, d, c))
    return V, np.asarray(faces, np.int32), N
