"""Multi-process data-parallel rendering: each rank traces its slice, one
all-reduce sums the films.

Counterpart of ``tpu_rt/parallel/render.py``.  tpu_rt maps (pixel x spp)
work onto a 1-D device mesh with ``shard_map`` and ``psum``; here every
rank of a ``torch.distributed`` process group is one device of that mesh:

* ``render_pass_sharded`` / ``render_sharded``: the wavefront, sharded
  over pixels (rank r traces its contiguous tile of H*W, padded, with a
  validity mask), each rank splatting into a local film that is summed;
* ``render_pallas_sharded``: K1 (K2's loop where the tables pick it),
  sharded over samples, one launch of spp / n samples a rank;
* ``render_stokes_pallas_sharded``: K3 (box / tent) or K6 (any other
  filter), sharded over samples.

The collectives are the pair JAX transposes into each other: ``psum``
(all-reduce forward, identity backward: the cotangent of a replicated
output is already replicated) and ``pbroadcast`` (identity forward,
all-reduce backward: the transpose of using a replicated parameter on
every rank).  A sharded function passes every scene tensor that requires
grad through ``pbroadcast``, as ``shard_map`` transposes a replicated
input, so every rank's gradient is the gradient of the whole render.
(``torch.distributed.nn.functional.all_reduce`` all-reduces its cotangent
and leaves each rank's parameter with its own shard's gradient: n times
the sum over ranks, split unevenly.)

The wavefront's random streams are the port's own (a ``torch.Generator``
a rank), as in every wavefront of the port; the kernel routes seed their
counter RNG as tpu_rt's do.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpu_rt_torch.integrator.path import path_trace
from tpu_rt_torch.ops import path_kernel as pk
from tpu_rt_torch.scene.types import FILTER_BOX, FILTER_TENT, Scene, grad_tensors, with_tensors
from tpu_rt_torch.sensor import camera as cam
from tpu_rt_torch.sensor import film as film_mod

_wrap_i32 = pk._wrap_i32
# the per-rank seed stride of tpu_rt's sharded routes
RANK_SEED_STRIDE = 7919


def default_group():
    """The default process group (the counterpart of ``default_mesh``).
    Raises ValueError when ``torch.distributed`` is not initialized: one
    process is a group of one that its caller initializes."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("the sharded routes need torch.distributed initialized "
                         "(init_process_group); a single process is a world of 1")
    return dist.group.WORLD


def group_shape(group=None):
    """(the group, its size, this process's rank in it)."""
    group = default_group() if group is None else group
    return group, dist.get_world_size(group), dist.get_rank(group)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PBroadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def psum(x, group=None):
    """The sum of ``x`` over the ranks of ``group`` (a new tensor on every
    rank): all-reduce forward, identity backward, as ``jax.lax.psum``."""
    return _PSum.apply(x, default_group() if group is None else group)


def pbroadcast(x, group=None):
    """``x`` itself (a view), whose gradient is all-reduced over the ranks
    of ``group``: wrap a parameter replicated on every rank, so that each
    rank's gradient is the sum of every rank's use of it."""
    return _PBroadcast.apply(x, default_group() if group is None else group)


def replicated(scene: Scene, group):
    """``scene`` with every tensor that requires grad passed through
    ``pbroadcast`` (``scene`` itself when none does)."""
    live = grad_tensors(scene)
    if not live:
        return scene
    return with_tensors(scene, [(path, pbroadcast(t, group)) for path, t in live])


def film_seed(seed, rank, stride=RANK_SEED_STRIDE):
    """tpu_rt's film-kernel seed of a rank, in int32 arithmetic:
    int32(seed) * 100003 + rank * stride."""
    return _wrap_i32(_wrap_i32(seed) * 100003 + rank * stride)


def sample_seed(seed, rank, k):
    """The first of rank ``rank``'s k contiguous per-sample seeds of
    int32(seed * 100003) + [0, spp)."""
    return _wrap_i32(_wrap_i32(seed * 100003) + rank * k)


def tile_pixels(H, W, n, rank, device):
    """Rank ``rank``'s contiguous tile of the H*W pixels padded to a
    multiple of ``n``: (integer pixel xy [m, 2] float32, valid [m]);
    padded lanes sit at pixel (0, 0) and are not valid."""
    total = H * W
    m = -(-total // n)
    idx = torch.arange(rank * m, (rank + 1) * m, device=device)
    valid = idx < total
    idx = torch.where(valid, idx, 0)
    xy = torch.stack([idx % W, idx // W], -1).to(torch.float32)
    return xy, valid


def trace_tile(scene: Scene, seed, n, rank, max_depth=None):
    """One sample a pixel of rank ``rank``'s tile, unreduced: the jitter,
    the camera rays and ``path_trace`` drawn from a generator on the
    scene's device seeded ``seed + rank * 7919``, splatted into a local
    film.  Returns (film_vals [H, W, 3], film_wts [H, W], rays cast)."""
    c = scene.camera
    H, W = c.height, c.width
    dev = c.to_world.device
    xy, valid = tile_pixels(H, W, n, rank, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed((seed + rank * RANK_SEED_STRIDE) & 0xFFFFFFFF)
    film_xy = xy + torch.rand(xy.shape, generator=gen, device=dev)
    o, d, t0, t1 = cam.sample_ray_extents(c, film_xy)
    L, n_rays = path_trace(scene, o, d, gen=gen, max_depth=max_depth, tmin0=t0, tmax0=t1)
    ok = valid & torch.isfinite(L).all(-1)
    L = torch.where(ok[:, None], L, 0.0)
    fv = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    fw = torch.zeros((H, W), dtype=torch.float32, device=dev)
    fv, fw = film_mod.splat(fv, fw, film_xy, L, ok, c.filter_type)
    return fv, fw, n_rays


def render_pass_sharded(scene: Scene, seed=0, group=None, max_depth=None, device="cuda"):
    """One sample a pixel over all pixels, sharded over the ranks of
    ``group``: each rank traces its tile (``trace_tile``, its generator
    seeded ``seed + rank * 7919``) and the films and ray counts are
    summed.  Differentiable in the scene's tensors that require grad
    (``pbroadcast``).  Returns (film_vals [H, W, 3], film_wts [H, W], rays
    cast, 0-d int64), the same on every rank, on ``device``."""
    group, n, rank = group_shape(group)
    sc = replicated(scene.to(torch.device(device)), group)
    fv, fw, n_rays = trace_tile(sc, seed, n, rank, max_depth=max_depth)
    return psum(fv, group), psum(fw, group), psum(n_rays, group)


def render_pallas_sharded(scene: Scene, spp=None, seed=0, group=None, tile_rows=16,
                          device="cuda"):
    """A render through the film kernel K1 (K2's loop where the tables'
    auto form picks it) sharded over samples (tpu_rt's
    ``render_pallas_sharded``): rank r makes one ``film_trace`` of spp / n
    samples a pixel seeded int32(seed) * 100003 + r * 7919, deposits its
    planes into its film, and the four planes and the ray count are
    summed.  Raises ValueError outside K1's scope, on a textured
    environment, on a filter other than box / tent (tpu_rt's in-kernel
    film), and when spp is not a multiple of the ranks.  Returns the
    (H, W, 3) image on ``device``, the same on every rank, and sets
    ``render_pallas_sharded.last_ray_count`` (0-d int64, all ranks)."""
    bs = pk.bake_scene(scene)
    if bs is None:
        raise ValueError("scene is outside the film kernel's scope")
    c = scene.camera
    if bs.env_textured or c.filter_type not in (FILTER_BOX, FILTER_TENT):
        raise ValueError("the sharded film-kernel render needs the in-kernel film "
                         "(box or tent filter, no textured environment)")
    group, n, rank = group_shape(group)
    spp = c.spp if spp is None else spp
    if spp % n:
        raise ValueError(f"spp {spp} must divide over {n} ranks")
    tables = pk.pack_tables(bs, c, tile_rows, torch.device(device))
    film, n_rays = pk.film_chunks(tables, pk.film_trace, [(film_seed(seed, rank), spp // n)])
    film = psum(film, group)
    render_pallas_sharded.last_ray_count = psum(n_rays, group)
    return film_mod.develop(film[:3].permute(1, 2, 0), film[3]).contiguous()


render_pallas_sharded.last_ray_count = None


def render_stokes_pallas_sharded(scene: Scene, spp=None, seed=0, group=None, tile_rows=16,
                                 device="cuda"):
    """A polarized render through the Stokes kernels sharded over samples
    (tpu_rt's ``render_stokes_pallas_sharded``); spp must be a multiple of
    the ranks, k = spp / n.

    Box / tent: K3 (one thread a (pixel, sample)), rank r one
    launch of k samples seeded int32(seed) * 100003 + r * k, its 13
    planes deposited and summed: the image is ``render_stokes_film(spp,
    spp_per_pass=k)``'s up to the order of the adds.  Any other filter:
    rank r traces its k contiguous seeds of seed * 100003 + [0, spp)
    through K6 in one launch, splats them in order
    (``path_kernel.sample_film``) and the 12 + 1
    planes are summed.  Raises ValueError outside the Stokes kernels'
    scope.  Returns the (H, W, 4, 3) Stokes image on ``device`` and sets
    ``render_stokes_pallas_sharded.last_ray_count`` (0-d int64)."""
    bs = pk.bake_scene(scene)
    if not pk.stokes_in_scope(bs):
        raise ValueError("scene is outside the Stokes kernel's scope")
    c = scene.camera
    H, W = c.height, c.width
    group, n, rank = group_shape(group)
    spp = c.spp if spp is None else spp
    if spp % n:
        raise ValueError(f"spp {spp} must divide over {n} ranks")
    k = spp // n
    tables = pk.pack_tables(bs, c, tile_rows, torch.device(device), stokes=True)
    if c.filter_type in (FILTER_BOX, FILTER_TENT):
        film, n_rays = pk.film_chunks(tables, pk.stokes_film_trace,
                                      [(film_seed(seed, rank, k), k)])
        film, n_rays = psum(film, group), psum(n_rays, group)
        S = film_mod.develop(film[:12].permute(1, 2, 0), film[12])
    else:
        fv, fw, n_rays = pk.sample_film(tables, pk.stokes_sample_trace, pk.sample_planes_split,
                                        k, sample_seed(seed, rank, k), k, c.filter_type)
        fv, fw, n_rays = psum(fv, group), psum(fw, group), psum(n_rays, group)
        S = film_mod.develop(fv, fw)
    render_stokes_pallas_sharded.last_ray_count = n_rays
    return S.reshape(H, W, 4, 3).contiguous()


render_stokes_pallas_sharded.last_ray_count = None


def render_sharded(scene: Scene, spp=None, seed=0, group=None, max_depth=None, device="cuda"):
    """A whole render through the wavefront sharded over pixels: ``spp``
    passes of ``render_pass_sharded``, pass i seeded int32(seed * 100003
    + i), their films summed and developed.  Matches the single-process
    wavefront render statistically (other sample assignment).  Returns the
    (H, W, 3) image on ``device`` and sets
    ``render_sharded.last_ray_count`` (0-d int64)."""
    c = scene.camera
    spp = c.spp if spp is None else spp
    fv = fw = n_rays = 0
    for i in range(spp):
        pv, pw, nr = render_pass_sharded(scene, seed=_wrap_i32(seed * 100003 + i), group=group,
                                         max_depth=max_depth, device=device)
        fv, fw, n_rays = fv + pv, fw + pw, n_rays + nr
    render_sharded.last_ray_count = n_rays
    return film_mod.develop(fv, fw)


render_sharded.last_ray_count = None
