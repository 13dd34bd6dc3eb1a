"""Integrator dispatch (Mitsuba's integrator plugin factory).

Counterpart of ``tpu_rt/integrator/__init__.py``.  A ``path`` scene inside
the film kernel's scope renders through ``ops/path_kernel.py`` (a mesh
scene of more than 64 prims through its clustered-mesh mode); a ``direct``
(or ``direct_projective``, whose image is the direct one) scene of meshes
lit by point lights renders through the direct mesh kernel of
``ops/mesh_kernel.py``; an
ultrasound scene returns the B-mode image of ``us.pipeline.us_render``,
whose acquisition runs through the ultrasound kernel (tpu_rt's ``render``
sends it through its XLA tracer instead: both estimate the same integrals
with different random streams).  Every other scene raises
``NotImplementedError`` naming the ROADMAP.md item that will port its
route.
"""

from __future__ import annotations

import torch

from tpu_rt_torch.scene.types import (
    INTEGRATOR_DIRECT,
    INTEGRATOR_DIRECT_PROJECTIVE,
    INTEGRATOR_PATH,
    INTEGRATOR_STOKES,
    INTEGRATOR_ULTRASOUND,
    Scene,
)

_LATER = {
    INTEGRATOR_STOKES: "A6 (polarized transport)",
}


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
    path segments or primaries, plus shadow rays).  For a path scene
    ``seed`` keys the film kernel's counter RNG and ``tile_rows`` only keys
    that RNG (tile = pixel // (tile_rows * 128)), so ``tile_rows=16``
    reproduces the JAX package's TPU render and ``tile_rows=8`` its
    interpret-mode render.  A direct scene draws its jitter from a
    ``torch.Generator`` seeded by ``seed`` (``tile_rows`` is not used), so
    it matches the JAX package's render statistically.  Both take
    ``spp_per_pass`` samples per kernel launch.  An hdrfilm with
    ``pixel_format="luminance"`` gives (H, W, 1).

    An ultrasound scene gives the B-mode display image [Nz, Nx] of
    ``us_render(scene, seed, device=device, **us_kwargs)`` (e.g.
    ``rays_per_pair``, ``x_bounds``, ``z_bounds``)."""
    from tpu_rt_torch.ops import path_kernel

    device = _check_device(device)
    if scene.integrator == INTEGRATOR_ULTRASOUND:
        from tpu_rt_torch.us.pipeline import us_render

        return us_render(scene, seed=seed, device=device, **us_kwargs)[0]
    if us_kwargs:
        raise TypeError(f"render got unexpected arguments {sorted(us_kwargs)}")
    if scene.integrator == INTEGRATOR_DIRECT_PROJECTIVE:
        # its primal image is the direct integrator's
        scene = scene.replace(integrator=INTEGRATOR_DIRECT)
    if scene.integrator == INTEGRATOR_DIRECT:
        from tpu_rt_torch.ops import mesh_kernel

        baked = mesh_kernel.bake_direct_scene(scene)
        if baked is None:
            raise NotImplementedError(
                "direct scenes other than meshes lit by point lights (at most "
                "64 clusters, diffuse, no analytic shape) are not ported yet "
                "(ROADMAP.md A4: wavefront path tracer)")
        img = mesh_kernel.mesh_direct_render(scene, spp=spp, seed=seed, device=device,
                                             spp_per_pass=spp_per_pass, baked=baked)
        render.last_ray_count = mesh_kernel.mesh_direct_render.last_ray_count
        return _develop_format(scene, img)
    if scene.integrator != INTEGRATOR_PATH:
        raise NotImplementedError(
            f"integrator {scene.integrator} is not ported to tpu_rt_torch yet "
            f"(ROADMAP.md {_LATER.get(scene.integrator, 'A4')})")
    baked = path_kernel.bake_scene(scene)
    if baked is None:
        raise NotImplementedError(
            "scene is outside the film kernel's bake scope (ROADMAP.md A10 "
            "and the items it lists: cone, rough conductor, pass-through, "
            "textured environment, textures, meshes of more than one BSDF or "
            "64 clusters)")
    img, n_rays = path_kernel.render_film(
        scene, spp=spp, seed=seed, device=device, spp_per_pass=spp_per_pass,
        tile_rows=tile_rows, baked=baked)
    render.last_ray_count = n_rays
    return _develop_format(scene, img)


def _develop_format(scene: Scene, img):
    """The hdrfilm's pixel format: "luminance" collapses rgb to one
    ITU-R BT.709 luminance channel."""
    if scene.camera.pixel_format == "luminance":
        img = (img[..., 0] * 0.212671 + img[..., 1] * 0.715160
               + img[..., 2] * 0.072169)[..., None]
    return img


render.last_ray_count = None
