"""Soft-shadow gradients for curve occluders (``direct_projective``).

Counterpart of ``tpu_rt/integrator/projective.py``.  Moving an occluder
changes a render only through where its shadow's edge falls, and the hard
visibility test has zero derivative almost everywhere; Mitsuba's
``direct_projective`` integrator estimates that boundary term.  This
module, as tpu_rt does, softens the curve's visibility instead:

* the scene's curve prims are swept-sphere spans (``scene/build.py``: the
  world axis a -> a + to_world[:, 2], world radii an_param * |axis|), so
  the clearance between a shadow segment and a span is closed form: the
  closest distance of the two segments less the span's radius there;
* a light sample's visibility past the curves becomes
  ``sigmoid(clearance / width)``, smooth in the spans' ends and radii, so
  autograd gives the silhouette derivative; as width -> 0 the image tends
  to the hard render;
* every other prim keeps the hard shadow test, against a copy of the
  geometry whose curve prims are moved out of the way
  (``geometry_without_curves``).

The [rays x spans] clearance is a PyTorch broadcast, as tpu_rt leaves it
to XLA; the rest of ``render_soft`` is the wavefront's ``path_trace``,
whose mesh queries run through the clustered mesh-intersect kernel K7.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_rt_torch.scene.types import CURVE


def curve_segments(geom):
    """The world-space swept-sphere spans of the CURVE prims, as a dict of
    tensors on the geometry's device: ``a`` / ``b`` [C, 3] the axis ends,
    ``r0`` / ``r1`` [C] the world radii.  Perturb them (with
    ``requires_grad``) and pass them to ``render_soft``."""
    mask = geom.an_type.cpu().numpy() == CURVE
    if not mask.any():
        raise ValueError("scene has no bsplinecurve prims")
    tw = geom.an_to_world.detach().cpu().numpy()[mask]
    par = geom.an_param.detach().cpu().numpy()[mask]
    a = tw[:, :3, 3]
    axis = tw[:, :3, 2]
    h = np.linalg.norm(axis, axis=-1)
    dev = geom.an_to_world.device
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in (("a", a), ("b", a + axis), ("r0", par[:, 0] * h),
                         ("r1", par[:, 1] * h))}


def geometry_without_curves(geom):
    """A copy of ``geom`` whose CURVE prims never occlude: moved 1e7 away
    through ``an_to_object`` (every shape unchanged; the BVH keeps the old
    bounds).  A phantom hit near t = 1e7 lies beyond every shadow query's
    finite tmax."""
    mask = geom.an_type == CURVE
    if not bool(mask.any()):
        return geom
    to_obj = geom.an_to_object.clone()
    to_obj[mask, :3, 3] += 1e7
    return geom.replace(an_to_object=to_obj)


def _dot(x, y):
    return (x * y).sum(-1)


def segment_clearance(p, q, curves):
    """The signed clearance of each shadow segment [p, q] ([N, 3]) from
    the curve: the least, over the spans, of the closest distance between
    the segment and the span's axis less the span's radius there (negative
    inside).  The closest points are Ericson's two-pass clamped solve
    (Real-Time Collision Detection 5.1.9), its denominators held off zero
    so that the backward pass stays finite.  Returns [N]."""
    a, b = curves["a"], curves["b"]  # [C, 3]
    r0, r1 = curves["r0"], curves["r1"]  # [C]
    d1 = (q - p)[:, None, :]  # [N, 1, 3]
    d2 = (b - a)[None, :, :]  # [1, C, 3]
    r = p[:, None, :] - a[None, :, :]  # [N, C, 3]
    A = torch.clamp(_dot(d1, d1), min=1e-12)
    E = torch.clamp(_dot(d2, d2), min=1e-12)
    B = _dot(d1, d2)
    C = _dot(d1, r)
    F = _dot(d2, r)
    den = A * E - B * B
    s = torch.clamp((B * F - C * E) / torch.clamp(den, min=1e-12), 0.0, 1.0)
    t = torch.clamp((B * s + F) / E, 0.0, 1.0)
    s = torch.clamp((B * t - C) / A, 0.0, 1.0)
    diff = (p[:, None, :] + s[..., None] * d1) - (a[None, :, :] + t[..., None] * d2)
    dist = torch.sqrt(torch.clamp(_dot(diff, diff), min=1e-18))
    clear = dist - (r0[None, :] + t * (r1 - r0)[None, :])
    # amin shares the gradient among equal minima, as jnp.min does
    return torch.amin(clear, 1)


def curve_soft_visibility(curves, o, d, dist, width):
    """The smooth visibility in [0, 1] of the shadow segment
    o -> o + dist d past the curve: sigmoid(clearance / width)."""
    return torch.sigmoid(segment_clearance(o, o + dist[..., None] * d, curves) / width)


def render_soft(scene, curves, spp=8, seed=0, width=0.01, max_depth=2, shadow_geom=None,
                device="cuda", draws=None):
    """A differentiable render with soft curve shadows, (H, W, 3) on
    ``device``.

    ``curves`` is ``curve_segments``' dict, perturbed as the caller likes:
    gradients reach its ``a``, ``b``, ``r0`` and ``r1`` through the light
    samples' visibility.  ``shadow_geom`` defaults to
    ``geometry_without_curves(scene.geometry)``.  Box filter, one sample a
    pixel a pass at the pixel's jittered position (shadow_art's box
    rfilter), the passes averaged.  Each pass draws its jitter [H*W, 2]
    and then its bounces' uniforms from a ``torch.Generator`` seeded by
    ``seed``, unless ``draws`` = (jitter [spp, H*W, 2], uniforms [spp,
    n_bounces, H*W, 8]) gives them.  The curve's own silhouette stays
    hard: take a loss over where its shadow falls."""
    from tpu_rt_torch.integrator import _check_device
    from tpu_rt_torch.integrator.path import path_trace
    from tpu_rt_torch.sensor import camera as cam

    device = _check_device(device)
    scene = scene.to(device)
    if shadow_geom is None:
        shadow_geom = geometry_without_curves(scene.geometry)
    shadow_geom = shadow_geom.to(device)
    soft = {k: v.to(device) for k, v in curves.items()}
    soft["width"] = width
    c = scene.camera
    H, W = c.height, c.width
    ys, xs = torch.meshgrid(torch.arange(H, device=device), torch.arange(W, device=device),
                            indexing="ij")
    xy = torch.stack([xs, ys], -1).reshape(-1, 2).to(torch.float32)
    gen = None
    if draws is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    acc = torch.zeros((H * W, 3), dtype=torch.float32, device=device)
    for i in range(spp):
        if draws is None:
            jitter, uniforms = torch.rand((H * W, 2), generator=gen, device=device), None
        else:
            jitter, uniforms = draws[0][i].to(device), draws[1][i].to(device)
        o, d, t0, t1 = cam.sample_ray_extents(c, xy + jitter)
        L, _ = path_trace(scene, o, d, gen=gen, uniforms=uniforms, max_depth=max_depth,
                          tmin0=t0, tmax0=t1, shadow_geom=shadow_geom, soft_curves=soft)
        acc = acc + L
    return (acc / spp).reshape(H, W, 3)
