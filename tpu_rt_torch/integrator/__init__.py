"""Integrator dispatch (Mitsuba's integrator plugin factory).

Counterpart of ``tpu_rt/integrator/__init__.py``.  A ``path`` scene inside
the film kernel's scope, which is tpu_rt's (triangles, spheres, rectangles
and cones; every BSDF but the acoustic one, rough conductors included; no
bitmap texture), renders through ``ops/path_kernel.py``: through the
film kernel K1 (a mesh scene of more than 64 prims through its
clustered-mesh mode; polarizer and ``null`` BSDFs through its
pass-through lane, as tpu_rt's ``render_pallas`` does), or, under a
textured environment, through the per-sample kernel K5 of
``render_sample_film`` (the environment looked up at each path's escape
after the kernel, the samples splatted and developed); a ``direct``
(or ``direct_projective``, whose image is the direct one) scene of meshes
lit by point lights renders through the direct mesh kernel of
``ops/mesh_kernel.py``.  Every other ``path`` scene (disks, cylinders,
curves, a mesh the clustered mode cannot take), and every other
``direct`` scene at max_depth 2, renders through the wavefront path
tracer of ``integrator/path.py`` (whose mesh queries run through the
clustered mesh-intersect kernel): a scene with a bitmap texture among
them, as the kernels have no texture lookup, and a ``direct_projective``
scene of curves (``integrator/projective.py`` holds its soft-shadow
gradient, ``render_soft``).  An ultrasound scene returns the B-mode
image of ``us.pipeline.us_render``, whose acquisition runs through the
ultrasound kernel when the scene is in its scope and ``use_kernel`` is
left True, else through the acoustic wavefront (tpu_rt's ``render``
takes its XLA wavefront for every scene: the two routes estimate the
same integrals with different random streams).
A ``stokes`` scene returns the (H, W, 4, 3) Stokes image of
``integrator/stokes.py::render_stokes``: through the Stokes film kernel
K3 when the scene is in its scope, else through the Stokes wavefront
(polarizers among them), as ``tpu_rt/integrator/stokes.py:163-172`` does.

The film kernels (K1-K6) and the direct mesh kernel are forward only, as
tpu_rt's ``render_pallas`` is: a scene with a tensor that requires grad
(autograd on) renders through the wavefronts, which autograd
differentiates (tpu_rt's route off the TPU), so no gradient is dropped.
An ultrasound scene is differentiable on both of its routes
(``us/pipeline.py``).
"""

from __future__ import annotations

import torch

from tpu_rt_torch.core.math import luminance
from tpu_rt_torch.scene.types import (
    INTEGRATOR_DIRECT,
    INTEGRATOR_DIRECT_PROJECTIVE,
    INTEGRATOR_PATH,
    INTEGRATOR_STOKES,
    INTEGRATOR_ULTRASOUND,
    Scene,
    grad_tensors,
)
from tpu_rt_torch.utils.profiling import span


def _check_device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render(device='cuda') needs a CUDA device; "
                           "pass device='cpu' to run the plain version")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"render runs on cuda or cpu, not {device.type}")
    return device


def render(scene: Scene, spp=None, seed=0, device="cuda", spp_per_pass=64,
           tile_rows=16, **us_kwargs):
    """Render a scene with its integrator (``mi.render`` equivalent).

    A path or direct scene gives an (H, W, 3) float32 tensor on ``device``
    and sets ``render.last_ray_count`` (a 0-d int64 tensor on ``device``:
    path segments or primaries, plus shadow rays).  For a path scene in
    the film kernel's scope ``seed`` keys the kernel's counter RNG and
    ``tile_rows`` only keys that RNG (tile = pixel // (tile_rows * 128)),
    so ``tile_rows=16`` reproduces the JAX package's TPU render and
    ``tile_rows=8`` its interpret-mode render; a scene with a textured
    environment takes the per-sample kernel K5 with the same seeding.  The
    direct mesh kernel and the wavefront tracer draw their randomness from
    a ``torch.Generator`` seeded by ``seed`` (``tile_rows`` is not used),
    so they match the JAX package's renders statistically.  The kernels
    (film, K5, direct mesh) take ``spp_per_pass`` samples per launch; the
    wavefront traces one sample per pixel per wave.  An hdrfilm with ``pixel_format="luminance"``
    gives (H, W, 1).

    A Stokes scene gives the (H, W, 4, 3) Stokes image (I, Q, U, V by
    rgb) of ``render_stokes``, its in-scope form through the Stokes film
    kernel with the same seeding as the film kernel.

    An ultrasound scene gives the B-mode display image [Nz, Nx] of
    ``us_render(scene, seed, device=device, **us_kwargs)`` (e.g.
    ``rays_per_pair``, ``x_bounds``, ``z_bounds``, ``use_kernel``)."""
    with span("tpu_rt_torch.render"):
        from tpu_rt_torch.ops import path_kernel

        device = _check_device(device)
        if scene.integrator == INTEGRATOR_ULTRASOUND:
            from tpu_rt_torch.us.pipeline import us_render

            return us_render(scene, seed=seed, device=device, **us_kwargs)[0]
        if us_kwargs:
            raise TypeError(f"render got unexpected arguments {sorted(us_kwargs)}")
        if grad_tensors(scene) and scene.integrator != INTEGRATOR_STOKES:
            # the film and direct kernels are forward only: a scene whose
            # tensors require grad renders through the differentiable wavefront
            max_depth = 2 if scene.integrator in (INTEGRATOR_DIRECT,
                                                  INTEGRATOR_DIRECT_PROJECTIVE) else None
            return _render_wavefront(scene, spp, seed, device, max_depth=max_depth)
        if scene.integrator == INTEGRATOR_STOKES:
            from tpu_rt_torch.integrator.stokes import render_stokes

            img = render_stokes(scene, spp=spp, seed=seed, device=device,
                                spp_per_pass=spp_per_pass, tile_rows=tile_rows)
            render.last_ray_count = render_stokes.last_ray_count
            return img
        if scene.integrator == INTEGRATOR_DIRECT_PROJECTIVE:
            # its primal image is the direct integrator's
            scene = scene.replace(integrator=INTEGRATOR_DIRECT)
        if scene.integrator == INTEGRATOR_DIRECT:
            from tpu_rt_torch.ops import mesh_kernel

            baked = mesh_kernel.bake_direct_scene(scene)
            if baked is None:
                return _render_wavefront(scene, spp, seed, device, max_depth=2)
            img = mesh_kernel.mesh_direct_render(scene, spp=spp, seed=seed, device=device,
                                                 spp_per_pass=spp_per_pass, baked=baked)
            render.last_ray_count = mesh_kernel.mesh_direct_render.last_ray_count
            return _develop_format(scene, img)
        if scene.integrator != INTEGRATOR_PATH:
            raise ValueError(f"unknown integrator {scene.integrator}")
        baked = path_kernel.bake_scene(scene)
        if baked is None:
            return _render_wavefront(scene, spp, seed, device)
        if baked.env_textured:
            img, n_rays = path_kernel.render_sample_film(
                scene, spp=spp, seed=seed, device=device, spp_per_pass=spp_per_pass,
                tile_rows=tile_rows, baked=baked)
        else:
            img, n_rays = path_kernel.render_film(
                scene, spp=spp, seed=seed, device=device, spp_per_pass=spp_per_pass,
                tile_rows=tile_rows, baked=baked)
        render.last_ray_count = n_rays
        return _develop_format(scene, img)


def _render_wavefront(scene: Scene, spp, seed, device, max_depth=None):
    """A scene outside the kernels' scope, through the wavefront tracer."""
    from tpu_rt_torch.integrator import path as wavefront

    img = wavefront.render(scene, spp=spp, seed=seed, max_depth=max_depth, device=device)
    render.last_ray_count = wavefront.render.last_ray_count
    return _develop_format(scene, img)


def _develop_format(scene: Scene, img):
    """The hdrfilm's pixel format: "luminance" collapses rgb to one
    ITU-R BT.709 luminance channel."""
    if scene.camera.pixel_format == "luminance":
        img = luminance(img)[..., None]
    return img


render.last_ray_count = None
