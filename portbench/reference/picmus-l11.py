"""Plain PyTorch reference of the ``picmus-l11`` configuration's frames.

The acquisition: plane-wave rays from the element centres of a linear
array, each (angle, element) pair's ``rays_per_pair`` rays traced through
the scene's rectangles with the acoustic GGX BSDF (impedance Fresnel,
reflect or refract), every bounce echoing to a random receive element
behind an occlusion test, its pressure (attenuation, directivity ramp,
sin of the phase) split by linear interpolation over the two nearest time
samples of that element's trace, and Russian roulette.  Then the
delay-and-sum image of the RF over a lambda / 4 grid, the envelope by the
analytic signal along depth, and 20 log10 compression over the dynamic
range.

It is a frozen copy of the arithmetic of the port's plain acquisition,
deposit and beamformer (sample streams keyed on (seed, tile, lane) by
SplitMix32), cut to what this scene class uses.  It reads the raw
configuration itself and imports nothing of the port.  ``dtype`` runs
every floating-point operation in that type (float32 as the configuration
states; bfloat16 is the benchmark's control).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from plainmath import (M32, add, clamp_abs, cross, default_dtype, dot, f32, frame, normalize,
                      rng_init, rng_next, safe_sqrt, scale, to_local, to_world, where3)

BIG = 1e8
SHADOW_SHRINK = 1.0 - 1e-3
EPS = 1e-7


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

class Setup:
    """The configuration's constants (float32 values as Python floats), the
    rectangles as (rows of to_object, world normal) and the acoustic BSDF
    rows, and the plane-wave rays [7, A * E] on the CPU, in ``dtype``."""

    def __init__(self, cfg, dtype=torch.float32):
        sc = cfg["scene"]
        it, sen = sc["integrator"], sc["sensor"]
        self.dt = dtype
        self.A = len(it["angles"])
        self.E = int(it["n_elements"])
        self.T = int(it["time_samples"])
        self.max_depth = int(it["max_depth"])
        self.angles = np.asarray(it["angles"], np.float32)
        self.fs, self.freq = f32(it["sampling_rate"]), f32(it["frequency"])
        self.c, self.pitch = f32(it["sound_speed"]), f32(it["pitch"])
        if float(sen.get("radius", "inf")) != math.inf:
            raise ValueError("the reference takes a linear array")
        m = np.asarray(sen["to_world"], np.float32)
        self.sensor = m
        tn = m[:3, :3] @ np.array([0.0, 0.0, 1.0])
        tn = tn / max(np.linalg.norm(tn), 1e-20)
        E = self.E
        self.g = dict(
            rows=[f32(m[i][k]) for i in range(3) for k in (0, 2, 3)],
            tn=[f32(x) for x in tn], pitch=self.pitch, c_lin=f32((E - 1) * 0.5),
            E=f32(E), E_m1=f32(E - 1.0),
            att=f32(-float(np.float32(it["attenuation"])) * (float(self.freq) * 1e-6)),
            db=f32(8.686), inv_c=f32(1.0 / self.c), two_pi_f=f32(2.0 * math.pi * self.freq),
            num_rays=f32(self.A * E), fs=self.fs, max_path=f32(cfg["max_path_length"]))
        main = float(np.deg2rad(np.float32(it["main_beam_angle"])))
        cut = float(np.deg2rad(np.float32(it["cutoff_angle"])))
        self.g.update(cos_cut=f32(math.cos(cut)), inv_ramp=f32(1.0 / max(cut - main, 1e-9)),
                      main=f32(main), cut=f32(cut))
        self.rects, self.bsdfs = [], []
        for name, sh in sc.items():
            if not isinstance(sh, dict) or "bsdf" not in sh:
                continue
            if sh["type"] != "rectangle" or sh["bsdf"]["type"] != "ultrasound_bsdf":
                raise ValueError(f"the reference takes ultrasound rectangles, not {name!r}")
            w = np.asarray(sh["to_world"], np.float32)
            mo = np.linalg.inv(w.astype(np.float64)).astype(np.float32)
            nw = np.linalg.inv(w[:3, :3]).T @ np.array([0.0, 0.0, 1.0])
            nw = nw / max(np.linalg.norm(nw), 1e-20)
            self.rects.append([[f32(x) for x in mo[0]], [f32(x) for x in mo[1]],
                               [f32(x) for x in mo[2]], [f32(x) for x in nw]])
            b = sh["bsdf"]
            self.bsdfs.append((f32(b.get("impedance", 1.54)),
                               f32(np.clip(np.float32(b.get("roughness", 0.5)), np.float32(1e-3),
                                           np.float32(1.0))),
                               f32(b.get("exterior_impedance", 1.2))))
        self.rays = self._rays()

    def _rays(self):
        """Angle-major rays of the (angle, element) pairs: origin, direction,
        transmit delay (x sin a + z cos a) / c, mapped by the sensor."""
        A, E = self.A, self.E
        dt = self.dt
        pitch = torch.tensor(self.pitch, dtype=dt)
        i = torch.arange(E, dtype=dt)
        x_lin = pitch * (i - (E - 1) * 0.5)
        zeros = torch.zeros_like(i)
        pos = torch.stack([x_lin, zeros, zeros], -1)
        ang = torch.repeat_interleave(torch.from_numpy(self.angles).to(dt) * math.radians(1.0), E)
        pe = pos.repeat(A, 1)
        sin_a, cos_a = torch.sin(ang), torch.cos(ang)
        d_local = torch.stack([sin_a, torch.zeros_like(ang), cos_a], -1)
        m = torch.from_numpy(self.sensor).to(dt)
        o = torch.stack([m[k, 0] * pe[:, 0] + m[k, 1] * pe[:, 1] + m[k, 2] * pe[:, 2] + m[k, 3]
                         for k in range(3)], -1)
        d = torch.stack([m[k, 0] * d_local[:, 0] + m[k, 1] * d_local[:, 1]
                         + m[k, 2] * d_local[:, 2] for k in range(3)], -1)
        length = torch.sqrt(torch.clamp((d * d).sum(-1, keepdim=True), min=1e-24))
        d = d * torch.reciprocal(torch.clamp(length, min=EPS))
        tx = (pe[:, 0] * sin_a + pe[:, 2] * cos_a) / torch.tensor(self.c, dtype=dt)
        return torch.cat([o.T, d.T, tx[None]])

    def elements(self):
        """The elements' x and z [E] and the angles [A], degrees."""
        i = torch.arange(self.E, dtype=torch.float32)
        x = torch.tensor(self.pitch, dtype=torch.float32) * (i - (self.E - 1) * 0.5)
        return x, torch.zeros_like(x), torch.from_numpy(self.angles)


def tiny_config(cfg):
    """A copy of the configuration cut to a size that the benchmark's CPU
    tests hold: 3 of the plane waves and 16 elements.  The widths (pitch,
    frequency, sampling) stay as published.  A run never calls it."""
    it = dict(cfg["scene"]["integrator"], angles=[-16.0, 0.0, 16.0], n_elements=16)
    return dict(cfg, scene=dict(cfg["scene"], integrator=it))


# ---------------------------------------------------------------------------
# the acquisition, flat (N,) tensors a component
# ---------------------------------------------------------------------------

def _div(x, c):
    return x / torch.full_like(x, c)


def _acos(x):
    """Abramowitz-Stegun 4.4.45 arccos (max error about 2e-4 rad)."""
    xa = torch.abs(x)
    p = 1.5707288 + xa * (-0.2121144 + xa * (0.0742610 + xa * (-0.0187293)))
    r = safe_sqrt(1.0 - xa) * p
    return torch.where(x >= 0.0, r, math.pi - r)


def _vndf_half(wi_l, alpha, u_a, u_b):
    """A GGX half vector from the visible normals (Heitz's spherical cap),
    two-sided."""
    flip = torch.where(wi_l[2] >= 0.0, 1.0, -1.0)
    wif = scale(wi_l, flip)
    vh = normalize((alpha * wif[0], alpha * wif[1], wif[2]))
    lensq = vh[0] * vh[0] + vh[1] * vh[1]
    inv_len = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    big = lensq > 1e-20
    t1v = (torch.where(big, -vh[1] * inv_len, 1.0),
           torch.where(big, vh[0] * inv_len, 0.0), torch.zeros_like(lensq))
    t2v = cross(vh, t1v)
    r_h = torch.sqrt(torch.clamp(u_a, min=0.0))
    phi_h = (2.0 * math.pi) * u_b
    p1h = r_h * torch.cos(phi_h)
    p2h = r_h * torch.sin(phi_h)
    s_h = 0.5 * (1.0 + vh[2])
    p2h = (1.0 - s_h) * safe_sqrt(1.0 - p1h * p1h) + s_h * p2h
    nh = add(add(scale(t1v, p1h), scale(t2v, p2h)),
              scale(vh, safe_sqrt(1.0 - p1h * p1h - p2h * p2h)))
    mh = normalize((alpha * nh[0], alpha * nh[1], torch.clamp(nh[2], min=1e-6)))
    return scale(mh, flip)


def sweep(S: Setup, o, d, tmin, tmax, any_hit=False):
    """Closest rectangle hit: (t, prim index as a float or -1, normal); with
    ``any_hit`` the hit mask alone."""
    zeros = torch.zeros_like(o[0])
    best_t = torch.full_like(o[0], BIG)
    best_prim = zeros - 1.0
    n = (zeros, zeros, zeros)
    for pi, (m0, m1, m2, nw) in enumerate(S.rects):
        ozp = m2[0] * o[0] + m2[1] * o[1] + m2[2] * o[2] + m2[3]
        dzp = m2[0] * d[0] + m2[1] * d[1] + m2[2] * d[2]
        t = -ozp / clamp_abs(dzp, 1e-9)
        oxp = m0[0] * o[0] + m0[1] * o[1] + m0[2] * o[2] + m0[3]
        dxp = m0[0] * d[0] + m0[1] * d[1] + m0[2] * d[2]
        oyp = m1[0] * o[0] + m1[1] * o[1] + m1[2] * o[2] + m1[3]
        dyp = m1[0] * d[0] + m1[1] * d[1] + m1[2] * d[2]
        xh = oxp + t * dxp
        yh = oyp + t * dyp
        ok = ((torch.abs(dzp) > 1e-12) & (t > tmin) & (t < tmax)
              & (torch.abs(xh) <= 1.0) & (torch.abs(yh) <= 1.0))
        pn = (nw[0] + zeros, nw[1] + zeros, nw[2] + zeros)
        closer = ok & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_prim = torch.where(closer, float(pi), best_prim)
        n = where3(closer, pn, n)
    if any_hit:
        return best_prim >= 0.0
    return best_t, best_prim, n


def trace(S: Setup, rays, lane0, seed, tile_lanes, counts):
    """The records of lanes ``lane0 ..`` (rays [7, N]): per bounce the
    pressure (0 where occluded or dead), the time-sample index and the
    receive element.  ``counts`` gets the sweeps and the echoes that reach
    their element added up."""
    g, dt = S.g, S.dt
    n_lanes = rays.shape[1]
    idx = lane0 + torch.arange(n_lanes, dtype=torch.int64, device=rays.device)
    rng = rng_init(torch.full_like(idx, seed & M32), idx // tile_lanes, idx % tile_lanes)
    o, d, tx_delay = (rays[0], rays[1], rays[2]), (rays[3], rays[4], rays[5]), rays[6]
    tn = g["tn"]
    zeros = torch.zeros_like(tx_delay)
    amp = atten = zeros + 1.0
    tof = geo_len = zeros
    active = zeros == 0.0
    records = []
    for _depth in range(S.max_depth):
        t, prim_f, n = sweep(S, o, d, 1e-4, BIG)
        hit = (prim_f >= 0.0) & active
        counts["closest"] += int(active.sum())
        counts["any"] += int(hit.sum())
        dist = torch.where(hit, t, 0.0)
        p_hit = add(o, scale(d, dist))
        wi = scale(d, -1.0)
        draws = []
        for _ in range(5):
            rng, u = rng_next(rng, dt)
            draws.append(u)
        u_recv, s1, s2a, s2b, u_rr = draws

        recv_f = torch.clamp(torch.floor(u_recv * g["E"]), max=g["E_m1"])
        x = g["pitch"] * (recv_f - g["c_lin"])
        z = torch.zeros_like(x)
        r = g["rows"]
        target = tuple(r[3 * i] * x + r[3 * i + 1] * z + r[3 * i + 2] for i in range(3))
        to_recv = (target[0] - p_hit[0], target[1] - p_hit[1], target[2] - p_hit[2])
        dist_recv = safe_sqrt(dot(to_recv, to_recv))
        sec_dir = scale(to_recv, 1.0 / dist_recv)
        off_sign = torch.where(dot(n, sec_dir) >= 0.0, 1.0, -1.0)
        occ = sweep(S, add(p_hit, scale(n, 1e-4 * off_sign)), sec_dir, 1e-4,
                    dist_recv * SHADOW_SHRINK, any_hit=True)
        visible = hit & ~occ

        atten = atten * torch.where(hit, torch.exp(_div(g["att"] * dist, g["db"])), 1.0)
        tof = tof + dist * g["inv_c"]
        total_time = tx_delay + tof + dist_recv * g["inv_c"]
        phase = g["two_pi_f"] * total_time

        z_int, alpha, z_ext = zeros, zeros + 1e-3, zeros + 1.2
        pidx = torch.where(prim_f >= 0.0, prim_f, 0.0).to(torch.int64)
        for bi, rec in enumerate(S.bsdfs):
            m = (prim_f >= 0.0) & (pidx == bi)
            z_int = torch.where(m, rec[0], z_int)
            alpha = torch.where(m, rec[1], alpha)
            z_ext = torch.where(m, rec[2], z_ext)

        s_fr, t_fr = frame(n)
        wi_l = to_local(n, s_fr, t_fr, wi)
        cos_wi = wi_l[2]
        mh = _vndf_half(wi_l, alpha, s2a, s2b)
        cos_im = dot(wi_l, mh)
        entering = cos_wi > 0.0
        Z1 = torch.where(entering, z_ext, z_int)
        Z2 = torch.where(entering, z_int, z_ext)
        ratio = Z1 / torch.clamp(Z2, min=1e-6)
        cos_i = torch.abs(cos_im)
        sin_t_sqr = ratio * ratio * (1.0 - cos_i * cos_i)
        tir = sin_t_sqr > 1.0
        cos_t = safe_sqrt(1.0 - sin_t_sqr)
        denom = Z2 * cos_i + Z1 * cos_t
        R = (Z2 * cos_i - Z1 * cos_t) / torch.clamp(denom, min=1e-9)
        T = 1.0 + R
        mh2 = scale(mh, 2.0 * cos_im)
        wo_r = (mh2[0] - wi_l[0], mh2[1] - wi_l[1], mh2[2] - wi_l[2])
        wo_t = add(scale(wi_l, -ratio), scale(mh, ratio * cos_i - cos_t))
        prob_r = torch.clamp(R * R, 0.05, 0.95)
        prob_r = torch.where(tir, 1.0, prob_r)
        pick_r = (s1 < prob_r) | tir
        wo_l = normalize(where3(pick_r, wo_r, wo_t))
        bs_amp = torch.where(pick_r, torch.abs(R) / prob_r,
                             torch.abs(T) / torch.clamp(1.0 - prob_r, min=1e-6))
        cos_theta = torch.abs(cos_wi)
        amp = amp * torch.where(hit, bs_amp * cos_theta, 1.0)

        cos_a = -(sec_dir[0] * tn[0] + sec_dir[1] * tn[1] + sec_dir[2] * tn[2])
        a_ang = torch.abs(_acos(torch.clamp(cos_a, -0.999999, 0.999999)))
        ramp = (g["cut"] - a_ang) * g["inv_ramp"]
        fd_dir = torch.where(a_ang <= g["main"], 1.0,
                             torch.where(a_ang <= g["cut"], ramp, 0.0))
        fd = _div(fd_dir * cos_theta, g["num_rays"])
        pressure = atten * amp * fd * torch.sin(phase)
        records.append((torch.where(visible, pressure, 0.0), total_time * g["fs"], recv_f,
                        visible))

        d_new = normalize(to_world(n, s_fr, t_fr, wo_l))
        off2 = torch.where(dot(n, d_new) >= 0.0, 1.0, -1.0)
        o_new = add(p_hit, scale(n, 1e-4 * off2))
        geo_len = geo_len + dist
        rr_prob = torch.clamp(torch.abs(atten * amp), 0.05, 1.0)
        survive = u_rr < rr_prob
        atten = torch.where(survive, atten / rr_prob, 0.0)
        within = (d_new[0] * tn[0] + d_new[1] * tn[1] + d_new[2] * tn[2]) >= g["cos_cut"]
        alive = hit & survive & within & (geo_len < g["max_path"])
        o = where3(alive, o_new, o)
        d = where3(alive, d_new, d)
        active = alive
    return records


def deposit(S: Setup, channel, records, angle_idx, counts):
    """Each bounce's pressure onto its lane's (angle, element) trace, split
    over the two time samples around its fractional index."""
    A, E, T = S.A, S.E, S.T
    for press, t_rec, recv_rec, visible in records:
        t_f = torch.clamp(t_rec, -2.0, float(T) + 2.0)
        recv = torch.clamp(recv_rec.to(torch.int64), 0, E - 1)
        t0 = torch.floor(t_f)
        w1 = t_f - t0
        t0i = t0.to(torch.int64)
        base = (angle_idx * E + recv) * T
        for tap, w in ((t0i, 1.0 - w1), (t0i + 1, w1)):
            inside = (tap >= 0) & (tap < T)
            counts["taps"] += int((visible & inside).sum())
            channel.index_add_(0, torch.clamp(base + tap, 0, A * E * T - 1),
                               torch.where(inside, press * w, 0.0).to(channel.dtype))


def acquisition(cfg, seed, rays_per_pair, tile_lanes, device, dtype=torch.float32,
                lanes_per_call=1 << 21):
    """(channel [A, E, T], tx delays [A, E], counts): the RF of the
    acquisition keyed by ``seed`` with ``rays_per_pair`` consecutive lanes
    a pair, divided by ``rays_per_pair``; counts of the closest-hit and
    any-hit sweeps and of the taps deposited."""
    with default_dtype(dtype):
        S = Setup(cfg, dtype)
        A, E, T = S.A, S.E, S.T
        rays = S.rays.to(device)
        channel = torch.zeros(A * E * T, dtype=dtype, device=device)
        counts = dict(closest=0, any=0, taps=0)
        n_lanes = A * E * rays_per_pair
        for l0 in range(0, n_lanes, lanes_per_call):
            lane = torch.arange(l0, min(n_lanes, l0 + lanes_per_call), device=device)
            pair = lane // rays_per_pair
            recs = trace(S, rays[:, pair], l0, seed, tile_lanes, counts)
            deposit(S, channel, recs, pair // E, counts)
        channel = channel.view(A, E, T) / float(rays_per_pair)
        return channel, S.rays[6].reshape(A, E).to(device), counts


# ---------------------------------------------------------------------------
# the B-mode image
# ---------------------------------------------------------------------------

def grid(cfg, x_bounds, z_bounds):
    """The lambda / 4 pixel grid, float32 x [Nx], z [Nz]."""
    it = cfg["scene"]["integrator"]
    step = f32(it["sound_speed"]) / f32(it["frequency"]) / 4.0
    x = np.arange(x_bounds[0], x_bounds[1] + step, step, dtype=np.float32)
    z = np.arange(z_bounds[0], z_bounds[1] + step, step, dtype=np.float32)
    return torch.from_numpy(x), torch.from_numpy(z)


def das(rf, ex, ez, angles_deg, fs, c, x_grid, z_grid):
    """Delay-and-sum of plane-wave RF [A, E, T] over the grid: [Nx, Nz]."""
    dt = rf.dtype
    angles = angles_deg.to(dt) * math.radians(1.0)
    sin_a, cos_a = torch.sin(angles), torch.cos(angles)
    inv_c = 1.0 / torch.tensor(c, dtype=dt)
    fs = torch.tensor(fs, dtype=dt)
    A, E, T = rf.shape
    X, Z = torch.meshgrid(x_grid.to(dt), z_grid.to(dt), indexing="ij")
    px, pz = X.reshape(-1), Z.reshape(-1)
    chunk = min(16, E)
    out = torch.zeros_like(px)
    for a in range(A):
        t_tx = (px * sin_a[a] + pz * cos_a[a]) * inv_c
        acc_a = torch.zeros_like(px)
        for e0 in range(0, E, chunk):
            exc, ezc = ex[e0:e0 + chunk].to(dt), ez[e0:e0 + chunk].to(dt)
            t_rx = torch.sqrt((px[:, None] - exc[None, :]) ** 2
                              + (pz[:, None] - ezc[None, :]) ** 2) * inv_c
            t_f = (t_tx[:, None] + t_rx - 0.0) * fs
            i0f = torch.floor(t_f)
            w = t_f - i0f
            i0 = i0f.to(torch.int64)
            rows = rf[a, e0:e0 + chunk]
            v0 = torch.gather(rows, 1, torch.clamp(i0, 0, T - 1).T).T
            v1 = torch.gather(rows, 1, torch.clamp(i0 + 1, 0, T - 1).T).T
            v0 = torch.where((i0 >= 0) & (i0 < T), v0, 0.0)
            v1 = torch.where((i0 + 1 >= 0) & (i0 + 1 < T), v1, 0.0)
            acc_a = acc_a + (v0 * (1.0 - w) + v1 * w).sum(dim=1)
        out = out + acc_a
    return out.reshape(X.shape)


def bmode(cfg, rf, x_bounds, z_bounds, dynamic_range):
    """The display image [Nz, Nx] in [0, 1] of the RF ``rf`` (its dtype)."""
    dt = rf.dtype
    with default_dtype(dt):
        S = Setup(cfg, dt)
        ex, ez, angles = S.elements()
        dev = rf.device
        xg, zg = grid(cfg, x_bounds, z_bounds)
        bf = das(rf, ex.to(dev), ez.to(dev), angles.to(dev), S.fs, S.c, xg.to(dev),
                 zg.to(dev))
        n = bf.shape[1]
        h = np.zeros(n, np.float32)
        h[0] = 1.0
        if n % 2 == 0:
            h[n // 2] = 1.0
            h[1:n // 2] = 2.0
        else:
            h[1:(n + 1) // 2] = 2.0
        # the FFT has no bfloat16 form: the envelope runs in float32 there
        ft = torch.float32 if dt == torch.bfloat16 else dt
        xf = torch.fft.fft(bf.to(ft), dim=1)
        env = torch.abs(torch.fft.ifft(xf * torch.from_numpy(h).to(dev, ft)[None, :],
                                       dim=1)).to(dt)
        db = 20.0 * torch.log10(env + 1e-12)
        max_db = db.max()
        min_db = max_db - dynamic_range
        return ((torch.clamp(db, min_db, max_db) - min_db) / dynamic_range).T
