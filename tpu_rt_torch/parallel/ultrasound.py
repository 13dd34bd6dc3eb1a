"""Multi-process ultrasound acquisition and beamforming: each rank traces
its slice of the samples a pair, one all-reduce averages the RF; the DAS
splits the image's lateral axis.

Counterpart of ``tpu_rt/parallel/ultrasound.py``, over the ranks of a
``torch.distributed`` process group where tpu_rt shards over a device
mesh (``parallel/render.py`` holds the collectives).  Both acquisition
routes give every rank ceil(rays_per_pair / n) samples a pair under its
own seed, seed + r * 7919, and average the ranks' RF buffers, each
already divided by its local samples a pair; with one rank and the same
seed each equals its single-process function.  The scene's tensors that
require grad enter through ``pbroadcast``, so the acquisition is
differentiable on every rank (the wavefront under autograd; the kernel
route through ``us_kernel.simulate_acquisition_fastgrad``).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from tpu_rt_torch.integrator import ultrasound as wavefront
from tpu_rt_torch.ops import us_kernel
from tpu_rt_torch.parallel.render import (
    RANK_SEED_STRIDE,
    group_shape,
    pbroadcast,
    psum,
    replicated,
)
from tpu_rt_torch.scene.types import Scene, grad_tensors
from tpu_rt_torch.us.beamform import das_beamform, das_beamform_matmul


def simulate_acquisition_sharded(scene: Scene, seed=0, rays_per_pair=8, group=None,
                                 device="cuda", uniforms=None):
    """The acoustic wavefront (``integrator/ultrasound.py``) sharded over
    samples a pair: rank r runs ceil(rays_per_pair / n) rays a pair with
    its generator seeded seed + r * 7919 (or fed ``uniforms[r]``, that
    function's ``uniforms=`` for rank r), and the RF is psum(ch) / n.
    Returns (channel_buf [A, E, T], tx_delays [A, E]) on ``device``, the
    same on every rank."""
    group, n, rank = group_shape(group)
    ch, tx = wavefront.simulate_acquisition(
        replicated(scene, group), seed=seed + rank * RANK_SEED_STRIDE,
        rays_per_pair=-(-rays_per_pair // n), device=device,
        uniforms=None if uniforms is None else uniforms[rank])
    return psum(ch, group) / n, tx


def simulate_acquisition_pallas_sharded(scene: Scene, seed=0, rays_per_pair=8, group=None,
                                        device="cuda"):
    """The acquisition through K10 (its deposit mode on CUDA) sharded as
    ``simulate_acquisition_sharded``: rank r traces ceil(rays_per_pair /
    n) rays a pair keyed seed + r * 7919 (int32), and the RF is psum(ch) /
    n.  A scene with tensors that require grad takes
    ``simulate_acquisition_fastgrad`` on every rank (K10's primal, the
    wavefront's gradient), as ``us_render`` does.  Raises ValueError
    outside K10's scope (``bake_us_scene`` is None).  Returns
    (channel_buf [A, E, T], tx_delays [A, E]) on ``device``."""
    if us_kernel.bake_us_scene(scene) is None:
        raise ValueError("scene not supported by the ultrasound kernel")
    group, n, rank = group_shape(group)
    acquire = (us_kernel.simulate_acquisition_fastgrad if grad_tensors(scene)
               else us_kernel.simulate_acquisition)
    ch, tx = acquire(replicated(scene, group),
                     seed=us_kernel._wrap_i32(seed + rank * RANK_SEED_STRIDE),
                     rays_per_pair=-(-rays_per_pair // n), device=device)
    return psum(ch, group) / n, tx


class _GatherTiles(torch.autograd.Function):
    """Every rank's [m, ...] tile, concatenated in rank order on every
    rank; the backward hands each rank its own tile's cotangent (the
    tiles' transpose: the replicated inputs' ``pbroadcast`` sums them)."""

    @staticmethod
    def forward(ctx, tile, group, n, rank):
        ctx.rank, ctx.m = rank, tile.shape[0]
        tile = tile.contiguous()
        parts = [torch.empty_like(tile) for _ in range(n)]
        dist.all_gather(parts, tile, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.m:(ctx.rank + 1) * ctx.m], None, None, None


def das_window(x_grid, z_grid, fs, c, tx=8, tz=8):
    """The matmul form's RF window for (tx, tz) pixel tiles, sized on the
    host from the full grid's pitch (tpu_rt/parallel/ultrasound.py:146-156):
    at least 256 samples, a multiple of 128."""
    xs, zs = torch.as_tensor(x_grid).cpu(), torch.as_tensor(z_grid).cpu()
    dx = float(xs[1] - xs[0]) if xs.shape[0] > 1 else 0.0
    dz = float(zs[1] - zs[0]) if zs.shape[0] > 1 else 0.0
    spread = (2.0 * tz * abs(dz) + 2.0 * tx * abs(dx)) / float(c) * float(fs)
    return max(256, ((int(math.ceil(spread)) + 8 + 127) // 128) * 128)


def das_beamform_sharded(channel_data, angles_deg, elem_x, fs, c, x_grid, z_grid,
                         t_offset=0.0, elem_z=None, group=None, method="gather"):
    """Delay-and-sum with the image's lateral axis split over the ranks
    (tpu_rt's ``das_beamform_sharded``): the x grid is padded with its
    last value to a multiple of n, rank r beamforms its contiguous tile
    with ``method`` ``"gather"`` (``us/beamform.py::das_beamform``: the
    DAS kernel on CUDA, its plain version on the CPU; the port's default,
    the form its ``us_render`` takes) or ``"matmul"``
    (``das_beamform_matmul`` with the window ``das_window`` sizes from the
    full grid, 8 x 8 tiles), and ``all_gather`` hands every rank the whole
    image (tpu_rt returns a sharded array; a rank here needs all of it).
    Each pixel's sum runs as in the single-process function.  On the
    channel data's device; differentiable in it and in the geometry.
    Returns the image [Nx, Nz]."""
    group, n, rank = group_shape(group)
    if method not in ("gather", "matmul"):
        raise ValueError(f"unknown DAS method {method!r}")
    dev = channel_data.device
    xg = torch.as_tensor(x_grid, dtype=torch.float32, device=dev).reshape(-1)
    zg = torch.as_tensor(z_grid, dtype=torch.float32, device=dev).reshape(-1)
    Nx = xg.shape[0]
    pad = (-Nx) % n
    if pad:
        xg = torch.cat([xg, xg[-1:].expand(pad)])
    m = xg.shape[0] // n
    tile = xg[rank * m:(rank + 1) * m]
    # the replicated inputs that require grad: each rank's tile adds its part
    rf, ang, ex, fs_, c_, ez = (
        pbroadcast(t, group) if isinstance(t, torch.Tensor) and t.requires_grad else t
        for t in (channel_data, angles_deg, elem_x, fs, c, elem_z))
    if method == "matmul":
        img = das_beamform_matmul(rf, ang, ex, fs_, c_, tile, zg, t_offset=t_offset, elem_z=ez,
                                  window=das_window(x_grid, z_grid, fs, c))
    else:
        img = das_beamform(rf, ang, ex, fs_, c_, tile, zg, t_offset=t_offset, elem_z=ez)
    return _GatherTiles.apply(img, group, n, rank)[:Nx]

