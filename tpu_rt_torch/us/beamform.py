"""Plane-wave delay-and-sum beamforming, envelope detection, B-mode.

Counterpart of ``tpu_rt/us/beamform.py``: the same functions, names and
maths, in PyTorch on the device of the RF data.  None of these is a
kernel of the JAX package (no Pallas).  ``das_beamform`` (the gather form)
is a wrapper: on a CPU tensor it runs ``das_beamform_plain``, on a CUDA
tensor it launches the hand-written kernels of ``ops/csrc/us_das.cu``
(``das_pack``, which lays each trace out as pairs of taps, then a block a
tile of pixels, which reads each tap from its windows of the packed traces
staged in shared memory: the same taps, the sums in another order) or
raises; ``das_beamform.launches`` and ``das_pack.launches`` count their
launches, ``das_beamform.split_launches`` those whose plan (``das_plan``)
takes a stage's windows in pieces.
It is differentiable as tpu_rt's (jax.grad) is, in the RF and in the
geometry: on the CPU torch's autograd differentiates the plain version;
on CUDA its backward is the adjoint kernel of the same file
(``das_adjoint``, ``das_adjoint_plain`` its plain version), never the
plain version.  ``das_beamform_matmul``
stays the port of tpu_rt's MXU form, in PyTorch.

Geometry/time conventions match the acquisition: with per-element transmit
delays t = x sin(a) / c, the plane wave reaches pixel (x, z) at
t_tx = (x sin a + z cos a) / c; the echo returns to element (x_e, z_e)
after t_rx = sqrt((x - x_e)^2 + (z - z_e)^2) / c.

Precision: the window-fetch and hat-weight contractions of
``das_beamform_matmul`` run in full float32, as the JAX package pins them
to ``Precision.HIGHEST``: ``_fp32_matmul`` sets
``torch.backends.cuda.matmul.allow_tf32 = False`` around them (TF32 would
round the RF trace itself to 10 mantissa bits).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from tpu_rt_torch.utils.memo import per_object
from tpu_rt_torch.utils.profiling import span


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@contextlib.contextmanager
def _fp32_matmul():
    """Full-float32 matrix products inside the block (TF32 off)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def grid_scan(x_min, x_max, z_min, z_max, step_lateral, step_axial):
    """Pixel grid of ultraspy's GridScan: float32 (x [Nx], z [Nz])."""
    x = np.arange(x_min, x_max + step_lateral, step_lateral, dtype=np.float32)
    z = np.arange(z_min, z_max + step_axial, step_axial, dtype=np.float32)
    if x.size == 0:
        x = np.asarray([x_min], np.float32)
    if z.size == 0:
        z = np.asarray([z_min], np.float32)
    return torch.from_numpy(x), torch.from_numpy(z)


def _setup(channel_data, angles_deg, elem_x, elem_z, fs, c):
    """Float32 tensors on the RF data's device; fs and c as 0-d tensors."""
    dev = channel_data.device
    elem_x = _f32(elem_x, dev)
    elem_z = torch.zeros_like(elem_x) if elem_z is None else _f32(elem_z, dev)
    angles = _f32(angles_deg, dev) * math.radians(1.0)
    return elem_x, elem_z, angles, _f32(fs), _f32(c)


def _das_sum(rf, ex, ez, sin_a, cos_a, inv_c, fs, x_grid, z_grid, t_offset):
    """The gather form's arithmetic on float tensors: rf [A, E, T], element
    positions [E], the angles' sines and cosines [A], 1 / c and fs; returns
    [Nx, Nz].  Differentiable in every tensor but the grids (the floor and
    the masks are constants, as for jax.grad)."""
    A, E, T = rf.shape
    X, Z = torch.meshgrid(x_grid, z_grid, indexing="ij")
    px, pz = X.reshape(-1), Z.reshape(-1)
    chunk = min(16, E)
    out = torch.zeros_like(px)
    for a in range(A):
        t_tx = (px * sin_a[a] + pz * cos_a[a]) * inv_c
        acc_a = torch.zeros_like(px)
        for e0 in range(0, E, chunk):
            exc, ezc = ex[e0:e0 + chunk], ez[e0:e0 + chunk]
            t_rx = torch.sqrt((px[:, None] - exc[None, :]) ** 2
                              + (pz[:, None] - ezc[None, :]) ** 2) * inv_c
            t_f = (t_tx[:, None] + t_rx - t_offset) * fs  # [P, C]
            i0f = torch.floor(t_f)
            w = t_f - i0f
            i0 = i0f.to(torch.int64)
            rows = rf[a, e0:e0 + chunk]  # [C, T]
            v0 = torch.gather(rows, 1, torch.clamp(i0, 0, T - 1).T).T
            v1 = torch.gather(rows, 1, torch.clamp(i0 + 1, 0, T - 1).T).T
            v0 = torch.where((i0 >= 0) & (i0 < T), v0, 0.0)
            v1 = torch.where((i0 + 1 >= 0) & (i0 + 1 < T), v1, 0.0)
            acc_a = acc_a + (v0 * (1.0 - w) + v1 * w).sum(dim=1)
        out = out + acc_a
    return out.reshape(X.shape)


def das_beamform_plain(channel_data, angles_deg, elem_x, fs, c, x_grid, z_grid,
                 t_offset=0.0, elem_z=None):
    """Delay-and-sum beamforming of plane-wave RF data (the gather form).

    Args:
      channel_data: [A, E, T] RF samples.
      angles_deg: [A] steering angles (degrees).
      elem_x: [E] element lateral positions (m).
      fs: sampling rate (Hz).  c: sound speed (m/s).
      x_grid: [Nx], z_grid: [Nz] image grid (m).
      t_offset: acquisition start time t0.
      elem_z: [E] element axial positions (m), nonzero for convex arrays;
        None means a linear row at z = 0.
    Returns the beamformed image [Nx, Nz] (lateral x axial).  Elements are
    summed in chunks of 16, as the JAX package does.  The plain version of
    ``csrc/us_das.cu``, which ``das_beamform`` runs on a CPU tensor; torch's
    autograd differentiates it in the RF and the geometry (the element
    positions, the angles, c and fs)."""
    channel_data = _f32(channel_data)
    dev = channel_data.device
    elem_x, elem_z, angles, fs, c = _setup(channel_data, angles_deg, elem_x, elem_z, fs, c)
    return _das_sum(channel_data, elem_x, elem_z, torch.sin(angles), torch.cos(angles),
                    1.0 / c, fs, _f32(x_grid, dev), _f32(z_grid, dev), t_offset)


def das_pack_plain(rf):
    """The packing pass's plain version: rf [A, E, T] -> [A, E, T + 3, 2],
    entry j the pair (pad[j], pad[j + 1]) of the trace padded with two
    zeros before it and two after.  Entry i0 + 2 holds the two taps of an
    index i0 in [-2, T], zeros where ``das_beamform_plain`` masks them."""
    z = rf.new_zeros(rf.shape[:-1] + (2,))
    pad = torch.cat([z, rf, z], dim=-1)
    return torch.stack([pad[..., :-1], pad[..., 1:]], dim=-1)


def das_pack(rf):
    """The DAS kernel's input: ``das_pack_plain``'s function.  On a CPU
    tensor this runs ``das_pack_plain``; on a CUDA tensor (float32 [A, E,
    T], contiguous) it launches ``csrc/us_das.cu``'s packing kernel into a
    tensor from ``torch.empty`` with 16 bytes to spare past its end, or
    raises.  ``das_pack.launches`` counts its launches: one a forward DAS
    call."""
    dev = rf.device
    if dev.type == "cpu":
        return das_pack_plain(rf)
    if dev.type != "cuda":
        raise ValueError(f"das_pack runs on cpu or cuda, not {dev.type}")
    if rf.dtype != torch.float32 or rf.dim() != 3 or not rf.is_contiguous():
        raise ValueError("das_pack needs contiguous float32 RF data [A, E, T]")
    from tpu_rt_torch.ops import _build

    A, E, T = rf.shape
    # 16 bytes past the end: the DAS kernel's copies are widened to 16-byte bounds
    n = A * E * (T + 3) * 2
    out = torch.empty(n + 4, dtype=torch.float32, device=dev)[:n].view(A, E, T + 3, 2)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.us_das_pack_launch(rf.data_ptr(), A * E, T, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("us_das packing kernel launch failed: "
                           + lib.us_das_error_string(err).decode())
    das_pack.launches += 1
    return out


das_pack.launches = 0


# us_das.cu's forward: consumer warps a block, pixels a thread, a warp's
# pixels along z and x, angles a pass, elements a stage, the ring's stages
# and bytes, each at most
DAS_WARPS, DAS_PIX, DAS_WARP_Z, DAS_WARP_X = 8, 2, 4, 8
DAS_MAX_ANGLES, DAS_MAX_STAGE_ELEMS, DAS_STAGES, DAS_RING_BYTES = 8, 2, 4, 64 * 1024


class DasPlan(NamedTuple):
    """The DAS kernel's launch: a block's pixel tile (``tile_wz`` warp tiles
    along z: ``tile_z`` x ``tile_x`` pixels; ``n_tiles`` of them cover the
    grid), the elements a stage of its ring holds (``stage_elems``), the
    entries of rf2 a slot holds (``capacity``), and whether a stage's
    windows may exceed a slot (``split``: the kernel then takes them in
    pieces)."""
    tile_wz: int
    tile_z: int
    tile_x: int
    n_tiles: int
    stage_elems: int
    capacity: int
    split: bool


def _host_grid(g):
    """A grid's values as float64 on the host, with the largest extent of
    its tiles of each size as they are asked for ({tile size: extent}).  A
    CUDA tensor's are kept while it lives unchanged
    (``utils/memo.py::per_object`` at its ``_version``), so a frame's
    planning waits on nothing but the first."""
    if not isinstance(g, torch.Tensor) or g.device.type == "cpu":
        return np.asarray(torch.as_tensor(g).detach(), np.float64).reshape(-1), {}
    return per_object(g, "host grid",
                      lambda: (g.detach().to("cpu", torch.float64).numpy().reshape(-1), {}),
                      version=g._version)


def _extent(grid, size):
    """The largest max - min of the grid's tiles of ``size`` values (the
    kernel's tiles start at multiples of it); inf if a value is not finite."""
    values, extents = grid
    if size not in extents:
        starts = np.arange(0, values.shape[0], size)
        ext = np.maximum.reduceat(values, starts) - np.minimum.reduceat(values, starts)
        extents[size] = float(ext.max()) if np.isfinite(values).all() else math.inf
    return extents[size]


def das_plans(n_a, n_t, x_grid, z_grid, fs, inv_c):
    """Each pixel tile the DAS kernel lays out (``DasPlan``s) for ``n_a``
    angles of ``n_t`` samples on these grids, with its stage capacity.

    A stage holds, for each of its elements and each angle of a pass, the
    window of rf2's entries (``das_pack``) that a tile's taps read from
    that element's trace.  Over a tile of extents W_x, W_z the delay x sin
    a + z cos a + r spans at most W_x + W_z + hypot(W_x, W_z) (r from one
    element changes by at most the box's diagonal), |fs / c| samples a
    metre; the floors of a span d take ceil(d) + 1 entries (+ 1 for
    rounding), the 16-byte bounds of the copy 2 more.  A stage holds
    ``DAS_MAX_STAGE_ELEMS`` elements where two slots of it fit the ring (a
    wait and a release of the ring a stage, spread over more taps), else
    one.  The kernel's ring holds as many slots as fit, up to
    ``DAS_STAGES``; where two of one element do not fit, ``split``, and a
    slot is a ``DAS_STAGES``-th of the ring."""
    xs, zs = _host_grid(x_grid), _host_grid(z_grid)
    k_a = min(n_a, DAS_MAX_ANGLES)
    n_wt = DAS_WARPS * DAS_PIX  # warp tiles a block
    per_m = abs(float(fs) * float(inv_c))  # samples a metre of delay
    plans = []
    for tile_wz in (w for w in range(1, n_wt + 1) if n_wt % w == 0):
        tile_z, tile_x = DAS_WARP_Z * tile_wz, DAS_WARP_X * (n_wt // tile_wz)
        wx, wz = _extent(xs, tile_x), _extent(zs, tile_z)
        span = (wx + wz + math.hypot(wx, wz)) * per_m
        entries = math.ceil(span) + 4 if span < n_t else n_t + 5  # a whole row at most
        per_elem = k_a * (entries + entries % 2)
        n_tiles = -(-xs[0].shape[0] // tile_x) * -(-zs[0].shape[0] // tile_z)
        two_fit = 2 * 8 * DAS_MAX_STAGE_ELEMS * per_elem <= DAS_RING_BYTES
        elems = DAS_MAX_STAGE_ELEMS if two_fit else 1
        cap = elems * per_elem
        split = 2 * 8 * cap > DAS_RING_BYTES
        if split:
            cap = DAS_RING_BYTES // (8 * DAS_STAGES) // 2 * 2
        plans.append(DasPlan(tile_wz, tile_z, tile_x, n_tiles, elems, cap, split))
    return plans


def das_plan(n_a, n_t, x_grid, z_grid, fs, inv_c):
    """The DAS kernel's launch for these shapes: of ``das_plans``, those
    that split no stage if any does; of them, those within 2% of the fewest
    tiles (each pixel a block computes, a ragged tile's repeats too, costs
    the same); of them, the most elements a stage, then the shortest
    windows (the bytes each stage copies), then the fewest tiles."""
    plans = das_plans(n_a, n_t, x_grid, z_grid, fs, inv_c)
    plans = [p for p in plans if p.split == min(q.split for q in plans)]
    fewest = min(p.n_tiles for p in plans)
    return min((p for p in plans if p.n_tiles <= 1.02 * fewest),
               key=lambda p: (-p.stage_elems, p.capacity // p.stage_elems, p.n_tiles))


def _das_launch(rf, ex, ez, sin_a, cos_a, inv_c, fs, xg, zg, t_offset, plan=None):
    """``csrc/us_das.cu`` on CUDA tensors (``inv_c``, ``fs`` 0-d on any
    device): the packing kernel, then the DAS kernel with ``plan`` (from
    ``das_plan`` on xg and zg unless given); the image [Nx, Nz]."""
    from tpu_rt_torch.ops import _build

    dev = rf.device
    A, E, T = rf.shape
    if plan is None:
        plan = das_plan(A, T, xg, zg, fs, inv_c)
    rf2 = das_pack(rf)  # held by name until the DAS kernel is queued
    out = torch.empty((xg.shape[0], zg.shape[0]), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.us_das_launch(
            rf2.data_ptr(), A, E, T, xg.data_ptr(), xg.shape[0], zg.data_ptr(), zg.shape[0],
            ex.data_ptr(), ez.data_ptr(), sin_a.data_ptr(), cos_a.data_ptr(), float(inv_c),
            float(t_offset), float(fs), plan.tile_wz, plan.stage_elems, plan.capacity,
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("us_das kernel launch failed: "
                           + lib.us_das_error_string(err).decode())
    das_beamform.launches += 1
    das_beamform.split_launches += plan.split
    return out


class _DAS(torch.autograd.Function):
    """The DAS kernel with the adjoint kernel as its backward."""

    @staticmethod
    def forward(ctx, rf, ex, ez, sin_a, cos_a, inv_c, fs, xg, zg, t_offset, plan):
        ctx.save_for_backward(rf, ex, ez, sin_a, cos_a, inv_c, fs, xg, zg)
        ctx.t_offset = t_offset
        return _das_launch(rf, ex, ez, sin_a, cos_a, inv_c, fs, xg, zg, t_offset, plan)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad
        grads = das_adjoint(*ctx.saved_tensors, g, t_offset=ctx.t_offset,
                            geometry=any(need[1:7]))
        return tuple(x if n else None for x, n in zip(grads, need[:7])) + (None,) * 4


def das_beamform(channel_data, angles_deg, elem_x, fs, c, x_grid, z_grid,
                 t_offset=0.0, elem_z=None):
    """Delay-and-sum beamforming of plane-wave RF data: the function of
    ``das_beamform_plain`` (its arguments and result [Nx, Nz]).

    On a CPU tensor this runs ``das_beamform_plain``, which autograd
    differentiates.  On a CUDA tensor it launches ``csrc/us_das.cu`` (built
    at first use: ``das_pack``'s kernel, then the DAS kernel with the launch
    ``das_plan`` makes from the grids' host values, which are kept for a
    CUDA grid while it lives unchanged) or raises: each tap is the plain
    version's arithmetic, the sums over angles and elements are taken in
    another order.  Its
    backward is the adjoint kernel of the same file (``das_adjoint``), in
    the RF and in the geometry (``elem_x``, ``elem_z``, the angles through
    their sines and cosines, ``c`` through 1 / c, and ``fs``), never the
    plain version.  ``das_beamform.launches`` counts forward launches,
    ``das_beamform.split_launches`` those whose plan splits a stage."""
    with span("tpu_rt_torch.das_beamform"):
        channel_data = _f32(channel_data)
        dev = channel_data.device
        if dev.type == "cpu":
            return das_beamform_plain(channel_data, angles_deg, elem_x, fs, c, x_grid, z_grid,
                                      t_offset=t_offset, elem_z=elem_z)
        if dev.type != "cuda":
            raise ValueError(f"das_beamform runs on cpu or cuda, not {dev.type}")
        if channel_data.dim() != 3:
            raise ValueError("das_beamform needs RF data [A, E, T]")
        elem_x, elem_z, angles, fs, c = _setup(channel_data, angles_deg, elem_x, elem_z, fs, c)
        A, E, T = channel_data.shape
        if angles.shape != (A,) or elem_x.shape != (E,) or elem_z.shape != (E,):
            raise ValueError(f"das_beamform needs {A} angles and {E} element positions")
        # every buffer the kernels read is held by a name (here, then in the
        # autograd context) until it has been queued: a temporary's memory
        # could be reused before the launch
        rf = channel_data.contiguous()
        xg = _f32(x_grid, dev).reshape(-1).contiguous()
        zg = _f32(z_grid, dev).reshape(-1).contiguous()
        ex, ez = elem_x.contiguous(), elem_z.contiguous()
        sin_a, cos_a = torch.sin(angles), torch.cos(angles)
        inv_c = 1.0 / c  # as das_beamform_plain computes it
        # planned from the caller's grids, whose host values are kept
        plan = das_plan(A, T, x_grid, z_grid, fs, inv_c)
        return _DAS.apply(rf, ex, ez, sin_a, cos_a, inv_c, fs, xg, zg, float(t_offset), plan)


das_beamform.launches = 0
das_beamform.split_launches = 0


def das_adjoint_plain(rf, ex, ez, sin_a, cos_a, inv_c, fs, x_grid, z_grid, g, t_offset=0.0,
                      geometry=True):
    """The adjoint's plain version: torch autograd of the gather form's
    arithmetic (``_das_sum``) at these inputs, applied to the cotangent
    ``g`` [Nx, Nz].  Returns (d rf [A, E, T], d elem_x [E], d elem_z [E],
    d sin [A], d cos [A], d (1 / c), d fs), each on its input's device
    (the geometric ones None unless ``geometry``)."""
    ins = [x.detach() for x in (rf, ex, ez, sin_a, cos_a, inv_c, fs)]
    with torch.enable_grad():
        for x in ins[:7 if geometry else 1]:
            x.requires_grad_()
        out = _das_sum(*ins, x_grid, z_grid, t_offset)
        wrt = ins[:7 if geometry else 1]
        grads = torch.autograd.grad(out, wrt, g, allow_unused=True)
    grads = [torch.zeros_like(x) if d is None else d for x, d in zip(wrt, grads)]
    return tuple(grads) + (None,) * (7 - len(grads))


def das_adjoint(rf, ex, ez, sin_a, cos_a, inv_c, fs, x_grid, z_grid, g, t_offset=0.0,
                geometry=True):
    """The DAS's adjoint: the cotangent ``g`` [Nx, Nz] of the image taken
    back to the RF [A, E, T] and, with ``geometry``, to the element
    positions, the angles' sines and cosines, 1 / c and fs (the tuple of
    ``das_adjoint_plain``).

    On a CPU tensor this runs ``das_adjoint_plain``.  On a CUDA tensor it
    launches the adjoint kernel of ``csrc/us_das.cu`` or raises: a block a
    (pixel tile, element) adds its taps' weights into the tile's windows of
    samples in shared memory, then each window into d rf with one atomic a
    sample; the geometric terms are summed over blocks, so in a
    run-dependent order.  The grids must be finite (a tile's window is
    bounded from its extent).
    ``das_adjoint.launches`` counts kernel launches."""
    dev = rf.device
    if dev.type == "cpu":
        return das_adjoint_plain(rf, ex, ez, sin_a, cos_a, inv_c, fs, x_grid, z_grid, g,
                                 t_offset=t_offset, geometry=geometry)
    if dev.type != "cuda":
        raise ValueError(f"das_adjoint runs on cpu or cuda, not {dev.type}")
    from tpu_rt_torch.ops import _build

    A, E, T = rf.shape
    nx, nz = x_grid.shape[0], z_grid.shape[0]
    for name, x, shape in (("rf", rf, (A, E, T)), ("elem_x", ex, (E,)), ("elem_z", ez, (E,)),
                           ("sin_a", sin_a, (A,)), ("cos_a", cos_a, (A,)),
                           ("x_grid", x_grid, (nx,)), ("z_grid", z_grid, (nz,)),
                           ("g", g, (nx, nz))):
        if x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"das_adjoint needs {name} as float32 of shape {shape} on {dev}")
    # held by name until queued, as in das_beamform
    rf, ex, ez = rf.contiguous(), ex.contiguous(), ez.contiguous()
    sin_a, cos_a, g = sin_a.contiguous(), cos_a.contiguous(), g.contiguous()
    x_grid, z_grid = x_grid.contiguous(), z_grid.contiguous()
    drf = torch.zeros_like(rf)
    dgeo = torch.zeros((2 * E + 2 * A + 2,), dtype=torch.float32, device=dev) if geometry else None
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.us_das_adjoint_launch(
            rf.data_ptr(), A, E, T, x_grid.data_ptr(), nx, z_grid.data_ptr(), nz, ex.data_ptr(),
            ez.data_ptr(), sin_a.data_ptr(), cos_a.data_ptr(), float(inv_c), float(t_offset),
            float(fs), g.data_ptr(), drf.data_ptr(), None if dgeo is None else dgeo.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError("us_das adjoint kernel launch failed: "
                           + lib.us_das_error_string(err).decode())
    das_adjoint.launches += 1
    if dgeo is None:
        return (drf,) + (None,) * 6
    d_ex, d_ez, d_sin, d_cos = dgeo[:2 * E + 2 * A].split((E, E, A, A))
    return (drf, d_ex, d_ez, d_sin, d_cos, dgeo[-2].to(torch.as_tensor(inv_c).device),
            dgeo[-1].to(torch.as_tensor(fs).device))


das_adjoint.launches = 0


def pulse_kernel(fs, f0, wave_cycles=5):
    """Gaussian-enveloped sinusoid excitation pulse of ``wave_cycles``
    cycles at f0; the Gaussian std makes the envelope decay to about 1% at
    the ends.  Odd length, float32."""
    duration = wave_cycles / f0
    n = max(int(round(duration * fs)) | 1, 3)
    t = (np.arange(n) - n // 2) / fs
    sigma = duration / 6.0
    kernel = np.sin(2 * np.pi * f0 * t) * np.exp(-0.5 * (t / sigma) ** 2)
    return torch.as_tensor(kernel, dtype=torch.float32)


def apply_pulse(channel_data, fs, f0, wave_cycles=5):
    """Convolve impulse RF data [A, E, T] with the excitation pulse along
    the time axis (FFT-based, 'same' alignment)."""
    T = channel_data.shape[-1]
    k = pulse_kernel(fs, f0, wave_cycles).to(channel_data.device)
    n = int(k.shape[0])
    nfft = 1 << (T + n - 2).bit_length()
    y = torch.fft.irfft(torch.fft.rfft(channel_data, nfft, dim=-1)
                        * torch.fft.rfft(k, nfft), nfft, dim=-1)
    start = n // 2
    return y[..., start:start + T].to(channel_data.dtype)


def das_beamform_matmul(channel_data, angles_deg, elem_x, fs, c, x_grid,
                        z_grid, t_offset=0.0, elem_z=None, window=None):
    """DAS with the time gathers turned into dense contractions over
    per-block RF windows, as ``tpu_rt``'s MXU form.

    Pixels are tiled into 8 x 8 blocks; within a block the delay spread
    is bounded, so each (angle, element, block) reads one contiguous RF
    window.  Window starts are quantized to Q = 64-sample chunks and every
    block's window for one (angle, element) is fetched by one one-hot
    product [n_blk, n_chunks] @ [n_chunks, window] against a
    strided-overlap view of the RF trace; the 2-tap linear interpolation
    becomes a hat-weight matrix (block, window) contracted with the window.
    Both products run in full float32.  The window auto-sizes from the grid
    pitch to cover the block's delay spread (at least 128 samples), unless
    ``window`` gives it (a caller that tiles a larger grid sizes it from
    that grid, as ``parallel/ultrasound.py::das_beamform_sharded`` does);
    out-of-range pixels add 0."""
    channel_data = _f32(channel_data)
    dev = channel_data.device
    elem_x, elem_z, angles, fs, c = _setup(channel_data, angles_deg, elem_x, elem_z, fs, c)
    A, E, T = channel_data.shape
    xs, zs = _f32(x_grid).cpu().numpy(), _f32(z_grid).cpu().numpy()
    Nx, Nz = xs.shape[0], zs.shape[0]
    TX = TZ = 8

    if window is None:
        # window from the grid pitch, in float32 as the JAX package computes it
        dx = float(xs[1] - xs[0]) if Nx > 1 else 0.0
        dz = float(zs[1] - zs[0]) if Nz > 1 else 0.0
        spread = (np.float32(2.0 * TZ * abs(dz) + 2.0 * TX * abs(dx))
                  / c.detach().cpu().numpy() * fs.detach().cpu().numpy())
        needed = int(np.ceil(spread)) + 8
        window = max(128, ((needed + 127) // 128) * 128)
    # Q must divide the window; one extra chunk covers the quantized start
    Q = 64
    window = ((window + Q + Q - 1) // Q) * Q
    n_chunks = (max(T - 1, 0) // Q) + 1
    L = (n_chunks - 1) * Q + window
    rf_all = torch.cat([channel_data, channel_data.new_zeros((A, E, L - T))], dim=2)

    # far-point padding: pad pixels never drive a block's window start
    pad_x, pad_z = (-Nx) % TX, (-Nz) % TZ
    xg = torch.cat([_f32(xs, dev), torch.full((pad_x,), 1e9, device=dev)])
    zg = torch.cat([_f32(zs, dev), torch.full((pad_z,), 1e9, device=dev)])
    X, Z = torch.meshgrid(xg, zg, indexing="ij")
    nbx, nbz = (Nx + pad_x) // TX, (Nz + pad_z) // TZ

    def tile(a):
        return a.reshape(nbx, TX, nbz, TZ).permute(0, 2, 1, 3).reshape(-1, TX * TZ)

    pxb, pzb = tile(X), tile(Z)
    inv_c = 1.0 / c
    iota_w = torch.arange(window, dtype=torch.float32, device=dev)
    chunk_ids = torch.arange(n_chunks, device=dev)
    out = torch.zeros_like(pxb)
    with _fp32_matmul():
        for a in range(A):
            t_tx = (pxb * torch.sin(angles[a]) + pzb * torch.cos(angles[a])) * inv_c
            acc_a = torch.zeros_like(pxb)
            for e in range(E):
                t_rx = torch.sqrt((pxb - elem_x[e]) ** 2 + (pzb - elem_z[e]) ** 2) * inv_c
                t_f = (t_tx + t_rx - t_offset) * fs  # [n_blk, block]
                s = torch.clamp(torch.floor(t_f.min(dim=1).values).to(torch.int64), 0, T - 1)
                sq = s // Q  # quantized chunk row, start sq * Q <= s
                rel = t_f - (sq * Q)[:, None].to(torch.float32)
                in_rng = (t_f >= 0.0) & (t_f <= T - 1) & (rel <= window - 1)
                rel = torch.where(in_rng, rel, -2.0)  # hat support is [-1, 1]
                rows = rf_all[a, e].unfold(0, window, Q)  # rows[r, j] = rf[r*Q + j]
                onehot = (sq[:, None] == chunk_ids[None, :]).to(torch.float32)
                wins = onehot @ rows  # exact selection of each block's window
                w = rel[:, :, None] - iota_w  # hat weights max(0, 1 - |rel - k|)
                w = w.abs_().neg_().add_(1.0).clamp_(min=0.0)
                acc_a = acc_a + torch.bmm(w, wins[:, :, None])[..., 0]
            out = out + acc_a
    out = out.reshape(nbx, nbz, TX, TZ).permute(0, 2, 1, 3).reshape(Nx + pad_x, Nz + pad_z)
    return out[:Nx, :Nz]


@functools.lru_cache(maxsize=16)
def _analytic_filter(n, device):
    """The analytic signal's frequency weights for length n, on ``device``
    (made and copied once a length and device)."""
    h = np.zeros(n, np.float32)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[1:(n + 1) // 2] = 2.0
    return torch.from_numpy(h).to(device)


def hilbert_envelope(img, axis=-1):
    """Envelope via the analytic signal (Hilbert transform along ``axis``),
    ultraspy's compute_envelope."""
    with span("tpu_rt_torch.hilbert_envelope"):
        n = img.shape[axis]
        shape = [1] * img.dim()
        shape[axis] = n
        Xf = torch.fft.fft(img, dim=axis)
        analytic = torch.fft.ifft(Xf * _analytic_filter(n, img.device).reshape(shape), dim=axis)
        return torch.abs(analytic)


def log_compress(envelope, dynamic_range=60.0):
    """20 log10 compression to [0, 1] over ``dynamic_range`` dB."""
    with span("tpu_rt_torch.log_compress"):
        db = 20.0 * torch.log10(envelope + 1e-12)
        max_db = db.max()
        min_db = max_db - dynamic_range
        return (torch.clamp(db, min_db, max_db) - min_db) / dynamic_range


def bmode_pipeline(channel_data, angles_deg, elem_x, fs, c, x_grid, z_grid,
                   dynamic_range=60.0, method="matmul", elem_z=None):
    """RF data -> beamform -> axial envelope -> log compression.  Returns
    the display image [Nz, Nx] (depth down).  ``method``: 'matmul' (the
    windowed-contraction DAS, default, as in tpu_rt) or 'gather' (the
    reference form, ``das_beamform``: the kernel on the card)."""
    das = das_beamform_matmul if method == "matmul" else das_beamform
    bf = das(channel_data, angles_deg, elem_x, fs, c, x_grid, z_grid, elem_z=elem_z)
    env = hilbert_envelope(bf, axis=1)  # axial (z) axis
    return log_compress(env, dynamic_range).T
