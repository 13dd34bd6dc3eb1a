"""Ultrasound acquisition kernel: host side, plain PyTorch version, wrapper.

Counterpart of ``tpu_rt/ops/pallas_us.py`` (``bake_us_scene``,
``_build_us_kernel``, ``simulate_acquisition_pallas``).

* ``bake_us_scene`` extracts the kernel's constants; scenes outside its
  scope give ``None`` (no ultrasound configuration, no prims or more than
  64, a BSDF other than ``ultrasound_bsdf``, a prim the sweep lacks: it
  takes triangles, spheres of a uniform scale, rectangles and cones, so
  the reference's Cone_Box / Cone_FLoating scenes are in scope).
* ``pack_us_tables`` turns the baked scene into an int32 header and one
  float32 table: a block of acquisition constants, then the film kernel's
  prim records (``path_kernel.pack_prims``), then one record per acoustic
  BSDF.  Constants that the JAX kernel folds from Python floats
  (``attenuation * f_mhz``, ``1 / c``, ``2 pi f``, ``cos(cutoff)``, the
  ramp slope, the element-layout constants) are folded here in float64 and
  rounded once, so both packages use the same float32 values.
* ``us_trace`` is the records wrapper: on a CPU tensor it runs
  ``us_trace_plain``, on a CUDA tensor it launches the hand-written kernel
  ``csrc/us_acq.cu`` in its records mode or raises.  Both return
  per-bounce (pressure, time-sample index, receive element) records,
  [3 * max_depth, N]; the card gates hold the kernel to them.
* ``deposit_rf`` bins the records into the RF channel buffer with a
  two-tap linear-interpolation ``index_add_``, as the JAX package leaves
  that scatter to XLA.
* ``us_trace_rf`` is the acquisition's wrapper: on a CPU tensor it runs
  ``us_trace_rf_plain`` (``deposit_rf`` of ``us_trace_plain``), on a CUDA
  tensor it launches the kernel in its deposit mode, which adds each
  bounce's two taps into the RF buffer itself (atomics, so in a
  run-dependent order), or raises.  It takes one ray per (angle, element)
  pair; the kernel makes the pair's ``rays_per_pair`` lanes.
* ``simulate_acquisition`` runs the whole acquisition: plane-wave rays,
  ``rays_per_pair`` consecutive lanes per (angle, element) pair, the
  kernel with its deposit.  The packed tables and the pair rays depend on
  the scene alone, so they are built and copied to the device once a
  scene (``utils/memo.py::per_object``), not once a frame, from its
  values detached.
* ``simulate_acquisition_fastgrad`` is the differentiable acquisition:
  the kernel's primal, and as its backward the acoustic wavefront
  (``integrator/ultrasound.py``) replayed under autograd, as tpu_rt's
  custom VJP pairs them.  K10 itself is forward only.

The plain version reuses the film kernel's helpers (``_sweep``, the
SplitMix32 ``_rng_init`` / ``_rng_next``, ``_frame``, the VNDF half vector
``_vndf_half``), so it draws the JAX
kernel's random streams bit for bit, keyed on (seed, lane // tile_lanes,
lane % tile_lanes) with tile_lanes = tile_rows * 128.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from tpu_rt_torch.ops.path_kernel import (
    BakedPrim,
    _add,
    _dot,
    _f32,
    _frame,
    _normalize,
    _prim_attr_f,
    _rng_init,
    _rng_next,
    _safe_sqrt,
    _scale,
    _sweep,
    _to_local,
    _to_world,
    _vndf_half,
    _where3,
    _wrap_i32,
    bake_prims,
    pack_prims,
)
from tpu_rt_torch.scene.types import BSDF_ULTRASOUND, Scene, grad_tensors, with_tensors
from tpu_rt_torch.sensor.transducer import plane_wave_rays
from tpu_rt_torch.utils.memo import per_object
from tpu_rt_torch.utils.profiling import span

_MAX_PRIMS = 64
_BIG = 1e8


@dataclass
class BakedUSScene:
    prims: List[BakedPrim]
    # per-bsdf acoustic params (z_int, alpha, z_ext), float32 values, with
    # the clamps the JAX package applies when it builds its bsdf table
    bsdfs: List[Tuple[float, float, float]]
    layout: str  # 'linear' | 'convex'
    n_elements: int
    pitch: float
    radius: float
    opening_angle: float
    sensor_rows: tuple  # 3 rows of sensor_to_world (4 floats each)
    trans_n: tuple  # world transducer normal
    frequency: float
    sound_speed: float
    attenuation: float
    sampling_rate: float
    main_beam_angle: float  # radians
    cutoff_angle: float  # radians
    max_path_length: float
    max_depth: int
    num_rays: float  # n_pairs = A * E, the TX weight divisor


def bake_us_scene(scene: Scene) -> Optional[BakedUSScene]:
    """The kernel's constants, or None when the scene is out of scope.
    It reads the scene's values detached: scope is a property of the
    scene's structure, not of its gradients."""
    if scene.ultrasound is None:
        return None
    scene = scene.detach()
    us = scene.ultrasound
    g = scene.geometry
    if g.n_tris + g.n_analytic == 0 or g.n_tris + g.n_analytic > _MAX_PRIMS:
        return None
    if not set(scene.bsdf_type.tolist()) <= {BSDF_ULTRASOUND}:
        return None
    prims = bake_prims(scene, with_emitters=False)
    if prims is None:
        return None
    prm = scene.bsdf_params.numpy()
    bsdfs = [(float(p[0]), float(np.clip(p[1], np.float32(1e-3), np.float32(1.0))),
              float(p[2]) if p[2] > 0.0 else _f32(1.2)) for p in prm]

    m = us.sensor_to_world.numpy()
    radius = float(us.radius)
    layout = "linear" if (math.isinf(radius) or radius == 0.0) else "convex"
    trans_n = m[:3, :3] @ np.array([0.0, 0.0, 1.0])
    trans_n = trans_n / max(np.linalg.norm(trans_n), 1e-20)
    return BakedUSScene(
        prims=prims,
        bsdfs=bsdfs,
        layout=layout,
        n_elements=us.n_elements,
        pitch=float(us.pitch),
        radius=radius if layout == "convex" else 1.0,
        opening_angle=float(us.opening_angle),
        sensor_rows=tuple(tuple(m[i].tolist()) for i in range(3)),
        trans_n=tuple(trans_n.tolist()),
        frequency=float(us.frequency),
        sound_speed=float(us.sound_speed),
        attenuation=float(us.attenuation),
        sampling_rate=float(us.sampling_rate),
        main_beam_angle=float(np.deg2rad(us.main_beam_angle.numpy())),
        cutoff_angle=float(np.deg2rad(us.cutoff_angle.numpy())),
        max_path_length=float(us.max_path_length),
        max_depth=int(us.max_depth),
        num_rays=float(us.n_angles * us.n_elements),
    )


# ---------------------------------------------------------------------------
# Table packing (layout shared with csrc/us_acq.cu)
# ---------------------------------------------------------------------------

# int32 header
UH_N_PRIMS, UH_N_BSDFS, UH_MAX_DEPTH, UH_N_ELEM = 0, 1, 2, 3
UH_LAYOUT, UH_TILE_LANES, UH_OFF_PRIM, UH_OFF_BSDF = 4, 5, 6, 7
UH_LEN = 8
# element layouts: linear row, convex arc over the opening angle, convex
# arc at pitch / radius
LAYOUT_LINEAR, LAYOUT_CONVEX_OPEN, LAYOUT_CONVEX_PITCH = 0, 1, 2

# float32 table: the acquisition constants, then prim and bsdf records
UG_ROWS = 0  # m0[0], m0[2], m0[3], m1[0], m1[2], m1[3], m2[0], m2[2], m2[3]
UG_TN = 9  # world transducer normal
UG_PITCH, UG_RADIUS, UG_C_LIN, UG_THETA0, UG_DTHETA = 12, 13, 14, 15, 16
UG_E_HALF, UG_P_OVER_R, UG_E, UG_E_M1 = 17, 18, 19, 20
UG_ATT, UG_DB, UG_INV_C, UG_TWO_PI_F, UG_COS_CUT = 21, 22, 23, 24, 25
UG_INV_RAMP, UG_MAIN, UG_CUT, UG_NUM_RAYS, UG_FS, UG_MAX_PATH = 26, 27, 28, 29, 30, 31
UG_LEN = 32
US_BSDF_STRIDE = 4  # z_int, alpha, z_ext, pad


@dataclass
class USTables:
    """A baked ultrasound scene packed for the acquisition kernel, on one
    device."""

    hdr: torch.Tensor  # int32 [UH_LEN]
    tab: torch.Tensor  # float32 [n]
    hdr_list: list  # host copies, read by the plain version
    tab_list: list
    max_depth: int


def pack_us_tables(bs: BakedUSScene, tile_rows: int, device) -> USTables:
    """Pack a baked ultrasound scene for the kernel on ``device``.
    ``tile_rows`` keys the RNG: tile = lane // (tile_rows * 128)."""
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    E = bs.n_elements
    g = [0.0] * UG_LEN
    m0, m1, m2 = bs.sensor_rows
    g[UG_ROWS:UG_ROWS + 9] = [_f32(r[k]) for r in (m0, m1, m2) for k in (0, 2, 3)]
    g[UG_TN:UG_TN + 3] = [_f32(x) for x in bs.trans_n]
    layout = LAYOUT_LINEAR
    if bs.layout == "convex":
        layout = (LAYOUT_CONVEX_OPEN if bs.opening_angle and bs.opening_angle > 0.0
                  else LAYOUT_CONVEX_PITCH)
    span = math.radians(bs.opening_angle)
    g[UG_PITCH], g[UG_RADIUS] = _f32(bs.pitch), _f32(bs.radius)
    g[UG_C_LIN] = _f32((E - 1) * 0.5)
    g[UG_THETA0], g[UG_DTHETA] = _f32(-span / 2), _f32(span / max(E - 1, 1))
    g[UG_E_HALF], g[UG_P_OVER_R] = _f32(E / 2.0), _f32(bs.pitch / bs.radius)
    g[UG_E], g[UG_E_M1] = _f32(E), _f32(E - 1.0)
    f_mhz = bs.frequency * 1e-6
    g[UG_ATT] = _f32(-bs.attenuation * f_mhz)
    g[UG_DB] = _f32(8.686)
    g[UG_INV_C] = _f32(1.0 / bs.sound_speed)
    g[UG_TWO_PI_F] = _f32(2.0 * math.pi * bs.frequency)
    g[UG_COS_CUT] = _f32(math.cos(bs.cutoff_angle))
    g[UG_INV_RAMP] = _f32(1.0 / max(bs.cutoff_angle - bs.main_beam_angle, 1e-9))
    g[UG_MAIN], g[UG_CUT] = _f32(bs.main_beam_angle), _f32(bs.cutoff_angle)
    g[UG_NUM_RAYS], g[UG_FS] = _f32(bs.num_rays), _f32(bs.sampling_rate)
    g[UG_MAX_PATH] = _f32(bs.max_path_length)

    prim_tab = pack_prims(bs.prims)
    bsdf_tab = []
    for z_int, alpha, z_ext in bs.bsdfs:
        bsdf_tab += [_f32(z_int), _f32(alpha), _f32(z_ext), 0.0]
    tab = g + prim_tab + bsdf_tab
    hdr = [0] * UH_LEN
    hdr[UH_N_PRIMS], hdr[UH_N_BSDFS] = len(bs.prims), len(bs.bsdfs)
    hdr[UH_MAX_DEPTH], hdr[UH_N_ELEM], hdr[UH_LAYOUT] = bs.max_depth, E, layout
    hdr[UH_TILE_LANES] = tile_rows * 128
    hdr[UH_OFF_PRIM], hdr[UH_OFF_BSDF] = UG_LEN, UG_LEN + len(prim_tab)
    return USTables(
        hdr=torch.tensor(hdr, dtype=torch.int32, device=device),
        tab=torch.tensor(tab, dtype=torch.float32, device=device),
        hdr_list=hdr, tab_list=tab, max_depth=bs.max_depth)


# ---------------------------------------------------------------------------
# Plain PyTorch version of the kernel: flat (N,) tensors, one per component
# ---------------------------------------------------------------------------

_SHADOW_SHRINK = 1.0 - 1e-3


class _USConsts:
    """The packed tables read back as Python floats (exact float32 values),
    so the plain version uses the kernel's constants."""

    def __init__(self, tables: USTables):
        h, t = tables.hdr_list, tables.tab_list
        self.max_depth = h[UH_MAX_DEPTH]
        self.layout = h[UH_LAYOUT]
        self.tile_lanes = h[UH_TILE_LANES]
        self.g = t[:UG_LEN]
        lo, mid = h[UH_OFF_PRIM], h[UH_OFF_BSDF]
        self.prims = [t[o:o + 20] for o in range(lo, mid, 20)]
        self.bsdfs = [t[o:o + US_BSDF_STRIDE] for o in range(mid, len(t), US_BSDF_STRIDE)]


def _div(x, c):
    """x / c for a Python float c as a true division (on CUDA, torch
    divides by a scalar as a multiply by its reciprocal)."""
    return x / torch.full_like(x, c)


def _acos(x):
    """Abramowitz-Stegun 4.4.45 arccos, the JAX kernel's (max error about
    2e-4 rad), for x in [-1, 1]."""
    xa = torch.abs(x)
    p = 1.5707288 + xa * (-0.2121144 + xa * (0.0742610 + xa * (-0.0187293)))
    r = _safe_sqrt(1.0 - xa) * p
    return torch.where(x >= 0.0, r, math.pi - r)


def _elem_world(C: _USConsts, r):
    """World position of receive element index r (a float tensor), in the
    closed form of the array's layout."""
    g = C.g
    if C.layout == LAYOUT_LINEAR:
        x = g[UG_PITCH] * (r - g[UG_C_LIN])
        z = torch.zeros_like(x)
    else:
        if C.layout == LAYOUT_CONVEX_OPEN:
            theta = g[UG_THETA0] + r * g[UG_DTHETA]
        else:
            theta = (r - g[UG_E_HALF]) * g[UG_P_OVER_R]
        x = g[UG_RADIUS] * torch.sin(theta)
        z = g[UG_RADIUS] * (1.0 - torch.cos(theta))
    m = g[UG_ROWS:UG_ROWS + 9]
    return tuple(m[3 * i] * x + m[3 * i + 1] * z + m[3 * i + 2] for i in range(3))


def us_trace_plain(tables: USTables, rays, seed: int, sweeps=None):
    """The plain PyTorch version of the kernel.  ``rays`` is [7, N]
    float32: origin xyz, direction xyz, transmit delay.  Returns the
    [3 * max_depth, N] records: per bounce the pressure (0 where the echo
    is occluded or the lane dead), the time-sample index and the receive
    element.  A dict ``sweeps`` gets the prim sweeps the kernel makes on
    these lanes added to its "closest" (one a bounce a live lane starts)
    and "any" (one a bounce that hits) counts, and each bounce's [N] mask
    of the echoes that reach their element appended to its "visible"
    list (the bounces whose taps the deposit mode adds)."""
    C = _USConsts(tables)
    g = C.g
    n_lanes = rays.shape[1]
    idx = torch.arange(n_lanes, dtype=torch.int64, device=rays.device)
    rng = _rng_init(seed, idx // C.tile_lanes, idx % C.tile_lanes)
    o, d, tx_delay = (rays[0], rays[1], rays[2]), (rays[3], rays[4], rays[5]), rays[6]
    tn = g[UG_TN:UG_TN + 3]
    zeros = torch.zeros_like(tx_delay)
    amp = atten = zeros + 1.0
    tof = geo_len = zeros
    active = zeros == 0.0
    records = []
    for _depth in range(C.max_depth):
        t, prim_f, n = _sweep(C, o, d, 1e-4, _BIG)
        hit = (prim_f >= 0.0) & active
        if sweeps is not None:
            sweeps["closest"] = sweeps.get("closest", 0) + int(active.sum())
            sweeps["any"] = sweeps.get("any", 0) + int(hit.sum())
        dist = torch.where(hit, t, 0.0)
        p_hit = _add(o, _scale(d, dist))
        wi = _scale(d, -1.0)
        draws = []
        for _ in range(5):
            rng, u = _rng_next(rng)
            draws.append(u)
        u_recv, s1, s2a, s2b, u_rr = draws

        # echo towards a random receive element, with an any-hit occlusion test
        recv_f = torch.clamp(torch.floor(u_recv * g[UG_E]), max=g[UG_E_M1])
        target = _elem_world(C, recv_f)
        to_recv = (target[0] - p_hit[0], target[1] - p_hit[1], target[2] - p_hit[2])
        dist_recv = _safe_sqrt(_dot(to_recv, to_recv))
        sec_dir = _scale(to_recv, 1.0 / dist_recv)
        off_sign = torch.where(_dot(n, sec_dir) >= 0.0, 1.0, -1.0)
        occ = _sweep(C, _add(p_hit, _scale(n, 1e-4 * off_sign)), sec_dir,
                     1e-4, dist_recv * _SHADOW_SHRINK, any_hit=True)
        visible = hit & ~occ
        if sweeps is not None:
            sweeps.setdefault("visible", []).append(visible)

        atten = atten * torch.where(hit, torch.exp(_div(g[UG_ATT] * dist, g[UG_DB])), 1.0)
        tof = tof + dist * g[UG_INV_C]
        total_time = tx_delay + tof + dist_recv * g[UG_INV_C]
        phase = g[UG_TWO_PI_F] * total_time

        # ---- acoustic GGX BSDF: per-lane params of the hit prim's bsdf ----
        z_int, alpha, z_ext = zeros, zeros + 1e-3, zeros + 1.2
        bsdf_id = _prim_attr_f(C, prim_f, 1, -1.0)
        for bi, rec in enumerate(C.bsdfs):
            m = bsdf_id == float(bi)
            z_int = torch.where(m, rec[0], z_int)
            alpha = torch.where(m, rec[1], alpha)
            z_ext = torch.where(m, rec[2], z_ext)

        s_fr, t_fr = _frame(n)
        wi_l = _to_local(n, s_fr, t_fr, wi)
        cos_wi = wi_l[2]

        # VNDF sample (Heitz spherical cap; two-sided via flip)
        mh, _ = _vndf_half(wi_l, alpha, s2a, s2b)

        # impedance Fresnel: reflect or refract
        cos_im = _dot(wi_l, mh)
        entering = cos_wi > 0.0
        Z1 = torch.where(entering, z_ext, z_int)
        Z2 = torch.where(entering, z_int, z_ext)
        ratio = Z1 / torch.clamp(Z2, min=1e-6)
        cos_i = torch.abs(cos_im)
        sin_t_sqr = ratio * ratio * (1.0 - cos_i * cos_i)
        tir = sin_t_sqr > 1.0
        cos_t = _safe_sqrt(1.0 - sin_t_sqr)
        denom = Z2 * cos_i + Z1 * cos_t
        R = (Z2 * cos_i - Z1 * cos_t) / torch.clamp(denom, min=1e-9)
        T = 1.0 + R
        mh2 = _scale(mh, 2.0 * cos_im)
        wo_r = (mh2[0] - wi_l[0], mh2[1] - wi_l[1], mh2[2] - wi_l[2])
        wo_t = _add(_scale(wi_l, -ratio), _scale(mh, ratio * cos_i - cos_t))
        prob_r = torch.clamp(R * R, 0.05, 0.95)
        prob_r = torch.where(tir, 1.0, prob_r)
        pick_r = (s1 < prob_r) | tir
        wo_l = _normalize(_where3(pick_r, wo_r, wo_t))
        bs_amp = torch.where(pick_r, torch.abs(R) / prob_r,
                             torch.abs(T) / torch.clamp(1.0 - prob_r, min=1e-6))
        cos_theta = torch.abs(cos_wi)
        amp = amp * torch.where(hit, bs_amp * cos_theta, 1.0)

        # receive directivity ramp, then the record
        cos_a = -(sec_dir[0] * tn[0] + sec_dir[1] * tn[1] + sec_dir[2] * tn[2])
        a_ang = torch.abs(_acos(torch.clamp(cos_a, -0.999999, 0.999999)))
        ramp = (g[UG_CUT] - a_ang) * g[UG_INV_RAMP]
        fd_dir = torch.where(a_ang <= g[UG_MAIN], 1.0,
                             torch.where(a_ang <= g[UG_CUT], ramp, 0.0))
        fd = _div(fd_dir * cos_theta, g[UG_NUM_RAYS])
        pressure = atten * amp * fd * torch.sin(phase)
        records += [torch.where(visible, pressure, 0.0), total_time * g[UG_FS], recv_f]

        # bounce + Russian roulette
        d_new = _normalize(_to_world(n, s_fr, t_fr, wo_l))
        off2 = torch.where(_dot(n, d_new) >= 0.0, 1.0, -1.0)
        o_new = _add(p_hit, _scale(n, 1e-4 * off2))
        geo_len = geo_len + dist
        rr_prob = torch.clamp(torch.abs(atten * amp), 0.05, 1.0)
        survive = u_rr < rr_prob
        atten = torch.where(survive, atten / rr_prob, 0.0)
        within = (d_new[0] * tn[0] + d_new[1] * tn[1] + d_new[2] * tn[2]) >= g[UG_COS_CUT]
        alive = hit & survive & within & (geo_len < g[UG_MAX_PATH])
        o = _where3(alive, o_new, o)
        d = _where3(alive, d_new, d)
        active = alive
    return torch.stack(records)


# ---------------------------------------------------------------------------
# Wrapper: the plain version on the CPU, the hand-written kernel on CUDA
# ---------------------------------------------------------------------------

MODE_RECORDS, MODE_DEPOSIT = 0, 1  # csrc/us_acq.cu's launch modes


def _launch(tables: USTables, rays, rays_per_pair, out, seed, mode, time_samples):
    from tpu_rt_torch.ops import _build

    lib = _build.load_library()
    dev = tables.tab.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.us_acq_launch(
            tables.hdr.data_ptr(), tables.hdr.numel(), tables.tab.data_ptr(), tables.tab.numel(),
            rays.data_ptr(), rays.shape[1], rays_per_pair, out.data_ptr(), _wrap_i32(seed),
            mode, time_samples, stream)
    if err != 0:
        raise RuntimeError("us_acq kernel launch failed: "
                           + lib.us_acq_error_string(err).decode())


def _check_rays(tables: USTables, rays, name):
    dev = tables.tab.device
    if rays.device != dev or rays.dtype != torch.float32 or rays.dim() != 2 \
            or rays.shape[0] != 7:
        raise ValueError(f"{name} needs float32 rays [7, N] on the tables' device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {dev.type}")
    return dev


def us_trace(tables: USTables, rays, seed: int):
    """Trace every lane's acquisition bounces: returns the
    [3 * max_depth, N] float32 records on the tables' device (see
    ``us_trace_plain``).  ``seed`` is an int32 (it wraps).

    On a CPU tensor this runs the plain version.  On a CUDA tensor it
    launches ``csrc/us_acq.cu`` in its records mode (built at first use) or
    raises.  ``us_trace.launches`` counts kernel launches."""
    dev = _check_rays(tables, rays, "us_trace")
    if dev.type == "cpu":
        return us_trace_plain(tables, rays, seed)
    rays = rays.contiguous()
    out = torch.zeros((3 * tables.max_depth, rays.shape[1]), dtype=torch.float32, device=dev)
    _launch(tables, rays, 1, out, seed, MODE_RECORDS, 0)
    us_trace.launches += 1
    return out


us_trace.launches = 0


def deposit_rf(records, angle_idx, n_angles, n_elements, time_samples):
    """Bin the records into the RF channel buffer [A, E, T]: each bounce's
    pressure lands on its lane's (angle, receive element) trace at the
    fractional time-sample index, split over the two neighbouring samples
    by linear interpolation.  ``angle_idx`` is each lane's angle (int)."""
    A, E, T = n_angles, n_elements, time_samples
    channel = torch.zeros(A * E * T, dtype=torch.float32, device=records.device)
    angle_idx = angle_idx.to(device=records.device, dtype=torch.int64)
    for depth in range(records.shape[0] // 3):
        press = records[3 * depth]
        t_f = torch.clamp(records[3 * depth + 1], -2.0, float(T) + 2.0)
        recv = torch.clamp(records[3 * depth + 2].to(torch.int64), 0, E - 1)
        t0 = torch.floor(t_f)
        w1 = t_f - t0
        t0i = t0.to(torch.int64)
        base = (angle_idx * E + recv) * T
        for tap, w in ((t0i, 1.0 - w1), (t0i + 1, w1)):
            inside = (tap >= 0) & (tap < T)
            channel.index_add_(0, torch.clamp(base + tap, 0, A * E * T - 1),
                               torch.where(inside, press * w, 0.0))
    return channel.view(A, E, T)


def us_trace_rf_plain(tables: USTables, rays, seed: int, n_angles, time_samples,
                      rays_per_pair=1):
    """The deposit mode's plain version: ``deposit_rf`` of the records of
    the pairs' lanes (``rays`` [7, A * E], one ray a pair, angle-major;
    lanes pair-major)."""
    E = tables.hdr_list[UH_N_ELEM]
    lanes = torch.repeat_interleave(rays, rays_per_pair, dim=1)
    angle_idx = torch.arange(lanes.shape[1], device=rays.device) // (rays_per_pair * E)
    return deposit_rf(us_trace_plain(tables, lanes, seed), angle_idx, n_angles, E,
                      time_samples)


def us_trace_rf(tables: USTables, rays, seed: int, n_angles, time_samples, rays_per_pair=1):
    """Trace the acquisition and deposit it: returns the RF [A, E, T]
    float32 on the tables' device, the taps summed over every lane (not
    yet divided by ``rays_per_pair``).  ``rays`` is [7, A * E], one ray a
    (angle, element) pair, angle-major; each pair gets ``rays_per_pair``
    consecutive lanes.

    On a CPU tensor this runs ``us_trace_rf_plain``.  On a CUDA tensor it
    launches ``csrc/us_acq.cu`` in its deposit mode or raises; its atomics
    add in a run-dependent order, as ``index_add_`` does on the card.
    ``us_trace_rf.launches`` counts kernel launches."""
    dev = _check_rays(tables, rays, "us_trace_rf")
    E = tables.hdr_list[UH_N_ELEM]
    if rays.shape[1] != n_angles * E or rays_per_pair < 1 or time_samples < 1:
        raise ValueError(f"us_trace_rf needs one ray per (angle, element) pair, "
                         f"{n_angles} x {E}, and rays_per_pair, time_samples >= 1")
    if dev.type == "cpu":
        return us_trace_rf_plain(tables, rays, seed, n_angles, time_samples, rays_per_pair)
    rays = rays.contiguous()
    out = torch.zeros((n_angles, E, time_samples), dtype=torch.float32, device=dev)
    _launch(tables, rays, rays_per_pair, out, seed, MODE_DEPOSIT, time_samples)
    us_trace_rf.launches += 1
    return out


us_trace_rf.launches = 0


def simulate_acquisition(scene: Scene, seed=0, rays_per_pair=1, device="cuda",
                         tile_rows=8):
    """The acquisition through the kernel.  Returns (channel_buf [A, E, T],
    tx_delays [A, E]) on ``device``.  Lanes are pair-major: the
    ``rays_per_pair`` rays of each (angle, element) pair are consecutive.
    ``seed`` keys the kernel's RNG as tpu_rt's ``simulate_acquisition_pallas``
    does; ``tile_rows=8`` is what its ``us_render`` uses.  Raises
    ValueError when the scene is outside the kernel's scope."""
    with span("tpu_rt_torch.simulate_acquisition"):
        def inputs():
            bs = bake_us_scene(scene)
            if bs is None:
                raise ValueError("scene not supported by the ultrasound kernel")
            base = plane_wave_rays(scene.ultrasound.detach())
            rays = torch.cat([base["o"].T, base["d"].T, base["tx_delay"][None]]).to(device)
            return pack_us_tables(bs, tile_rows, device), rays

        tables, rays = per_object(scene, ("acquisition", tile_rows, str(device)), inputs)
        us = scene.ultrasound
        A, E, T = us.n_angles, us.n_elements, us.time_samples
        channel = us_trace_rf(tables, rays, seed, A, T, rays_per_pair)
        return channel.div_(float(rays_per_pair)), rays[6].reshape(A, E).clone()


class _FastGrad(torch.autograd.Function):
    """K10's acquisition as the primal, the acoustic wavefront's gradient."""

    @staticmethod
    def forward(ctx, scene, paths, seed, rays_per_pair, device, tile_rows, *inputs):
        ctx.scene, ctx.paths, ctx.seed = scene, paths, seed
        ctx.rays_per_pair, ctx.device = rays_per_pair, device
        ctx.save_for_backward(*inputs)
        return simulate_acquisition(scene, seed=seed, rays_per_pair=rays_per_pair,
                                    device=device, tile_rows=tile_rows)

    @staticmethod
    def backward(ctx, g_ch, g_tx):
        from tpu_rt_torch.integrator import ultrasound as wavefront

        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        replay = with_tensors(ctx.scene, list(zip(ctx.paths, leaves)))
        with torch.enable_grad():
            ch, tx = wavefront.simulate_acquisition(replay, seed=ctx.seed,
                                                    rays_per_pair=ctx.rays_per_pair,
                                                    device=ctx.device)
            outs, cots = [], []
            for out, cot in ((ch, g_ch), (tx, g_tx)):
                if cot is not None and out.requires_grad:
                    outs.append(out)
                    cots.append(cot)
            grads = (torch.autograd.grad(outs, leaves, cots, allow_unused=True) if outs
                     else [None] * len(leaves))
        return (None,) * 6 + tuple(grads)


def simulate_acquisition_fastgrad(scene: Scene, seed=0, rays_per_pair=1, device="cuda",
                                  tile_rows=8):
    """The acquisition with the kernel's primal and the acoustic
    wavefront's gradient (tpu_rt's ``simulate_acquisition_fastgrad``,
    ``tpu_rt/ops/pallas_us.py:495-545``).  Returns (channel_buf [A, E, T],
    tx_delays [A, E]) on ``device``.

    Forward: ``simulate_acquisition`` (K10 with its RF deposit on CUDA,
    the plain version on the CPU), on the scene's values detached.
    Backward: the scene rebuilt with its tensors that require grad as new
    leaves, ``integrator/ultrasound.py::simulate_acquisition`` replayed at
    the same ``seed`` and ``rays_per_pair`` under autograd, and the
    cotangents taken back through it.  The inputs are every floating
    tensor of the scene that requires grad (the BSDF table, the
    ultrasound configuration's tensors, the geometry's if the caller made
    them require grad), so no gradient is dropped.

    The kernel and the wavefront draw different random streams, so the
    gradient is an independent unbiased Monte Carlo estimate of the true
    gradient rather than the derivative of the primal sample (both
    estimate the same integrals; ``tests/test_torch_us_grad.py`` holds
    them together).  For stochastic optimization this is the standard
    decorrelated-gradient setting, as the reference's finite-difference
    loop (USMain.py:262-289) takes two independent realizations.  K10 has
    no backward kernel; neither has tpu_rt's, whose VJP is its XLA
    wavefront.

    Raises ValueError when the scene is outside the kernel's scope."""
    live = grad_tensors(scene)
    return _FastGrad.apply(scene, tuple(p for p, _ in live), seed, rays_per_pair,
                           torch.device(device), tile_rows, *(t for _, t in live))
