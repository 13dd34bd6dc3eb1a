"""The ultrasound acquisition as a wavefront: every (angle x element x ray)
lane at once, one PyTorch pass a bounce.

Counterpart of ``tpu_rt/integrator/ultrasound.py::simulate_acquisition``:
tpu_rt's default ultrasound route, the port's for every scene outside the
acquisition kernel's scope (``ops/us_kernel.py``: more than 64 prims,
disks, cylinders, spheres of a non-uniform scale), and the backward of
the kernel route (``us_kernel.simulate_acquisition_fastgrad`` replays it
under autograd).  It is differentiable where tpu_rt's is, in the BSDF
table, the ultrasound configuration's tensors and the geometry, under
tpu_rt's conventions: a hit's distance through K7 (a mesh) or the BVH
walk is detached, the brute-force and chunked sweeps keep it (see
``geometry/trace.py``).  Each bounce, for all lanes:

* the closest hit (``geometry/trace.py``: brute force, K7 on a mesh with
  cluster tables, chunks, or the BVH);
* an echo to one receive element drawn per lane, its shadow ray tested up
  to (1 - 1e-3) of the distance;
* attenuation exp(-alpha f_MHz d / 8.686), the time of flight, the receive
  directivity ramp (1 inside main_beam_angle, 0 past cutoff_angle) and the
  |cos| transmit weight over the number of pairs;
* the echo's pressure (times sin(2 pi f t) unless ``deposit_sin=False``)
  split between the two neighbouring time samples of its receive trace
  (linear interpolation, two ``index_add_``), where the echo is visible;
* the acoustic BSDF sample (``bsdf/acoustic.py``), the bounce ray, an
  unbiased Russian roulette on |atten amp| clipped to [0.05, 1], the
  cutoff cone about the transducer normal and the ``max_path_length``
  test.

Randomness is explicit: a ``torch.Generator`` seeded with ``seed`` on the
device draws the element jitter [N, 2] (with ``jitter_elements``), then
each bounce the receive element [N] and the uniforms [N, 4] (lobe, the
microfacet's two, roulette).  ``uniforms=`` takes them instead, so a test
can feed tpu_rt's threefry draws and both packages follow the same paths.
Dead lanes' closest-hit queries are collapsed to an empty segment, and
lanes that hit nothing cast no shadow ray; their results are never read.

Arithmetic keeps tpu_rt's order where it can (t_f = total_time fs, its
floor and weight): a time index moved by an ulp crosses a sample only
where it sits on one.
"""

from __future__ import annotations

import math

import torch

from tpu_rt_torch.bsdf import acoustic
from tpu_rt_torch.core.math import (
    coordinate_system,
    dot,
    normalize,
    to_local,
    to_world,
    transform_point,
)
from tpu_rt_torch.geometry import trace
from tpu_rt_torch.scene.types import grad_tensors, with_tensors
from tpu_rt_torch.sensor.transducer import plane_wave_rays
from tpu_rt_torch.utils.memo import per_object


def _rays(us, device):
    return {k: v.to(device) for k, v in plane_wave_rays(us).items()}


def _inputs(scene, device):
    """What the acquisition needs that depends on the scene alone, on
    ``device``: the scene and the pair rays, kept per scene detached (so
    no later frame is handed an earlier frame's graph).  The tensors that
    require grad are taken anew each call, and the rays made from them."""
    sc, base = per_object(scene, ("wavefront", str(device)),
                          lambda: (scene.detach().to(device), _rays(scene.ultrasound.detach(),
                                                                    device)))
    live = grad_tensors(scene)
    if live:
        sc = with_tensors(sc, [(path, t.to(device)) for path, t in live])
        base = _rays(scene.ultrasound, device)
    return sc, base


def simulate_acquisition(scene, seed=0, rays_per_pair=1, jitter_elements=False,
                         deposit_sin=True, device="cuda", uniforms=None):
    """Run the acoustic acquisition on ``device``.  Returns (channel_buf
    [A, E, T] float32 divided by ``rays_per_pair``, tx_delays [A, E]) and
    sets ``simulate_acquisition.last_ray_count`` (0-d int64: the closest-hit
    rays of the live lanes plus the shadow rays; tpu_rt's state counts the
    hits alone).  Lanes are pair-major: the ``rays_per_pair`` lanes of each
    (angle, element) pair are consecutive.

    ``uniforms``, when given, is a dict of ``recv`` [max_depth, N] (int),
    ``u`` [max_depth, N, 4] and, with ``jitter_elements``, ``jitter``
    [N, 2], N = A * E * rays_per_pair; else a generator seeded with
    ``seed`` draws them.  ``deposit_sin=False`` deposits the amplitude
    impulse, for ``us/beamform.py::apply_pulse``."""
    us = scene.ultrasound
    if us is None:
        raise ValueError("scene has no ultrasound configuration")
    device = torch.device(device)
    A, E, T = us.n_angles, us.n_elements, us.time_samples
    sc, base = _inputs(scene, device)
    tx = base["tx_delay"].reshape(A, E)
    n_rays = torch.zeros((), dtype=torch.int64, device=device)
    simulate_acquisition.last_ray_count = n_rays
    g = sc.geometry
    if g.n_tris + g.n_analytic == 0:  # an empty scene: no echoes, delays still defined
        return torch.zeros((A, E, T), dtype=torch.float32, device=device), tx
    us = sc.ultrasound
    n_pairs = A * E
    n = n_pairs * rays_per_pair
    gen = None
    if uniforms is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)

    def rep(x):
        return torch.repeat_interleave(x, rays_per_pair, dim=0)

    o, d = rep(base["o"]), rep(base["d"])
    tx_delay = rep(base["tx_delay"])
    angle_idx = rep(base["angle_idx"])
    trans_n = base["trans_normal"]
    m = us.sensor_to_world
    if jitter_elements:
        jit = (uniforms["jitter"].to(device) if uniforms is not None
               else torch.rand((n, 2), generator=gen, device=device))
        dx = (jit[:, 0] - 0.5) * us.elements_width
        dy = (jit[:, 1] - 0.5) * us.elements_height
        o = o + (dx[:, None] * m[:3, 0] + dy[:, None] * m[:3, 1])
    elem_world = transform_point(m, base["elem_pos"])  # [E, 3]

    alpha_m = us.main_beam_angle * math.radians(1.0)
    alpha_c = us.cutoff_angle * math.radians(1.0)
    cos_cutoff = torch.cos(alpha_c)
    ramp = torch.clamp(alpha_c - alpha_m, min=1e-9)
    f_mhz = us.frequency * 1e-6
    inv_c = 1.0 / us.sound_speed
    num_rays = float(n_pairs)
    n_bsdf = sc.bsdf_params.shape[0]

    channel = torch.zeros((A * E * T,), dtype=torch.float32, device=device)
    amp = torch.ones((n,), dtype=torch.float32, device=device)
    atten = torch.ones_like(amp)
    tof = torch.zeros_like(amp)
    geo_len = torch.zeros_like(amp)
    active = torch.ones((n,), dtype=torch.bool, device=device)

    for depth in range(us.max_depth):
        if uniforms is not None:
            recv = uniforms["recv"][depth].to(device=device, dtype=torch.int64)
            u = uniforms["u"][depth].to(device)
        else:
            recv = torch.randint(0, E, (n,), generator=gen, device=device)
            u = torch.rand((n, 4), generator=gen, device=device)

        si = trace.ray_intersect(sc, o, d, tmax=torch.where(active, trace.INF, 0.0))
        hit = si.valid & active
        distance = torch.where(hit, si.t, 0.0)

        to_recv = elem_world[recv] - si.p
        dist_recv = torch.sqrt(torch.clamp(dot(to_recv, to_recv), min=1e-20))
        sec_dir = to_recv / dist_recv[:, None]
        occ = trace.ray_test(g, si.spawn_origin(sec_dir), sec_dir, tmin=trace.RAY_EPS,
                             tmax=torch.where(hit, dist_recv * (1.0 - 1e-3), 0.0))
        visible = hit & ~occ
        n_rays = n_rays + active.sum() + hit.sum()

        atten = atten * torch.where(
            hit, torch.exp(-us.attenuation * f_mhz * distance / 8.686), 1.0)
        tof = tof + distance * inv_c
        total_time = tx_delay + tof + dist_recv * inv_c

        sfr, tfr = coordinate_system(si.n)
        wi_local = to_local(si.n, sfr, tfr, si.wi)
        b_idx = sc.shape_bsdf[torch.clamp(si.shape, min=0)]
        b_params = sc.bsdf_params[torch.clamp(b_idx, 0, n_bsdf - 1)]
        bs = acoustic.sample(b_params, wi_local, u[:, 0], u[:, 1:3], hit)

        cos_theta = torch.abs(dot(si.n, si.wi))  # |cos|: tpu_rt's fix of the reference's sign
        amp = amp * torch.where(hit, bs.amplitude * cos_theta, 1.0)

        # receive directivity: the angle between the echo's arrival (-sec_dir)
        # and the transducer normal
        a = torch.abs(torch.arccos(torch.clamp(dot(-sec_dir, trans_n), -0.999999, 0.999999)))
        ramp_w = torch.where(a <= alpha_m, 1.0,
                             torch.where(a <= alpha_c, (alpha_c - a) / ramp, 0.0))
        fd = ramp_w * (cos_theta / num_rays)
        pressure = atten * amp * fd
        if deposit_sin:
            pressure = pressure * torch.sin(2.0 * math.pi * us.frequency * total_time)

        # the two-tap linear-interpolation deposit; an index past [-2, T + 2]
        # is clamped there, where both taps fall outside the trace anyway
        t_f = torch.clamp(total_time * us.sampling_rate, -2.0, float(T) + 2.0)
        t0 = torch.floor(t_f)
        w1 = t_f - t0
        t0i = t0.to(torch.int64)
        base_idx = (angle_idx * E + recv) * T
        for tap, w in ((t0i, 1.0 - w1), (t0i + 1, w1)):
            inside = visible & (tap >= 0) & (tap < T)
            channel.index_add_(0, torch.clamp(base_idx + tap, 0, A * E * T - 1),
                               torch.where(inside, pressure * w, 0.0))

        d_new = normalize(to_world(si.n, sfr, tfr, bs.wo))
        o_new = si.spawn_origin(d_new)
        geo_len = geo_len + distance

        rr_prob = torch.clamp(torch.abs(atten * amp), 0.05, 1.0)
        survive = u[:, 3] < rr_prob
        atten = torch.where(survive, atten / rr_prob, 0.0)
        alive = (hit & survive & (dot(d_new, trans_n) >= cos_cutoff)
                 & (geo_len < us.max_path_length))
        o = torch.where(alive[:, None], o_new, o)
        d = torch.where(alive[:, None], d_new, d)
        active = alive

    simulate_acquisition.last_ray_count = n_rays
    return channel.view(A, E, T) / float(rays_per_pair), tx


simulate_acquisition.last_ray_count = None

# tpu_rt's jitted entry (``simulate_acquisition_jit``, jax.jit over a
# traceable scene); PyTorch runs eagerly, so it is the same function, as
# ``us/pipeline.py`` keeps ``us_render_fast``.
simulate_acquisition_jit = simulate_acquisition
