"""The multi-process dry run: one sharded inverse-rendering step and every
sharded route, in spawned ranks of a ``torch.distributed`` group.

Counterpart of ``__graft_entry__.py::dryrun_multichip`` (tpu_rt's
multi-chip dry run on a device mesh).  ``run_world`` spawns the ranks
(``torch.multiprocessing``, the spawn start method: a fork after CUDA
has started fails), initializes the group through a ``file://`` init
method in a new temporary directory (parallel runs never share a port),
runs a module-level function in each and returns what each returned,
tensors as numpy arrays.  A rank that raises, dies or outlives the time
limit fails the run, and every rank is stopped.

``dryrun_steps`` is the dry run's rank: the steps of tpu_rt's, each
optional and sized by its configuration (``SMALL``, tpu_rt's tiny shapes,
by default):

1. the gradient through the collectives on the example 1/2 (sum w x)^2,
   x = 0..7 split over the ranks: d/dw = 784 at w = 1 on every rank;
2. one sharded train step: a loss through ``render_pass_sharded`` (the
   cbox's wavefront), its gradient in the BSDF table (``pbroadcast``),
   an update by ``torch.optim.Adam`` (lr 1e-2);
3. the sharded acquisition through the acoustic wavefront, then through
   K10 (``parallel/ultrasound.py``);
4. the sharded film kernel K1, the direct mesh kernel K9 and the Stokes
   kernels (K3 for box / tent, K6 for other filters);
5. the sharded DAS, both forms, on random RF.

Rank 0 also computes the single-process functions at every rank's seeds
(their sum, or mean for the RF), the train step's gradient in one process
over the same pixels and draws, and the DAS and its gradient in one
process, for the caller to hold the sharded results to.  With ``timing`` set, each route is timed
(one warm-up, ``timing`` runs) beside rank 0's single-process run while
the other ranks wait, and the collectives on each route's film or RF.

    python -m tpu_rt_torch.parallel.dryrun [N] [--cpu]

runs ``dryrun_multichip(N)`` (2 by default; on the GPUs under NCCL, or
with ``--cpu`` on the CPU under gloo).
"""

from __future__ import annotations

import os
import queue
import statistics
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[2]
ASSETS = ROOT / "tests" / "assets"
CBOX = str(ASSETS / "cbox" / "cbox.xml")
SIMPLE = str(ASSETS / "mesh" / "simple.xml")
CBOX_POL = str(ASSETS / "cbox_pol" / "cbox_pol.xml")


def _to_host(x):
    """``x`` with every tensor a numpy array (dicts, lists and tuples
    walked), so that a result pickles without shared memory."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def rank_device(rank, device):
    """The device of rank ``rank``: the CPU, or GPU rank % count."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _entry(fn, rank, n, backend, device, init_method, args, results):
    # every rank of a spawned world is on this host: gloo talks over the
    # loopback interface unless the caller named another
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        dev = rank_device(rank, device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method, world_size=n, rank=rank)
        try:
            out = _to_host(fn(rank, n, dev, *args))
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))


def _failures(results, n, failed, grace=5.0):
    """The failures reported within ``grace`` seconds of the first, every
    failed rank's traceback in rank order (a rank that fails leaves the
    others to fail in their next collective)."""
    deadline = time.monotonic() + grace
    while True:
        left = deadline - time.monotonic()
        if left <= 0:
            break
        try:
            rank, ok, out = results.get(timeout=left)
        except queue.Empty:
            break
        if not ok:
            failed[rank] = out
    return "\n".join(f"rank {r} of a world of {n} failed:\n{failed[r]}" for r in sorted(failed))


def run_world(fn, n, args=(), backend="gloo", device="cpu", timeout=600.0):
    """Run ``fn(rank, n, device, *args)`` in ``n`` spawned processes, one
    rank each of a ``torch.distributed`` group under ``backend``, rank r
    on ``rank_device(r, device)``.  ``fn`` is a module-level function.
    Returns the ranks' results in rank order, tensors as numpy arrays.
    Raises RuntimeError when a rank raises or dies, TimeoutError when the
    ranks are not done within ``timeout`` seconds; every rank is stopped
    before it returns or raises."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    got = {}
    with tempfile.TemporaryDirectory(prefix="tpu_rt_torch_world_") as tmp:
        init = Path(tmp, "rendezvous").as_uri()
        procs = [ctx.Process(target=_entry, args=(fn, r, n, backend, str(device), init, args,
                                                  results), daemon=True) for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(got) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"a world of {n} not done in {timeout:.0f} s "
                                       f"(ranks done: {sorted(got)})")
                try:
                    rank, ok, out = results.get(timeout=min(left, 2.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and not p.is_alive()]
                    if dead:
                        raise RuntimeError(f"rank(s) {dead} of a world of {n} exited "
                                           "without a result") from None
                    continue
                if not ok:
                    raise RuntimeError(_failures(results, n, {rank: out}))
                got[rank] = out
        finally:
            for p in procs:
                p.join(timeout=10)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    return [got[r] for r in range(n)]


def plate_desc(st):
    """tpu_rt's dry-run plate (``__graft_entry__.py:128-146``): one angle,
    16 elements at 0.5 mm, 1 500 samples, depth 2, a 4 cm rectangle of
    impedance 7.8 and roughness 0.4 at 2 cm."""
    return {
        "type": "scene",
        "integrator": {"type": "ultrasound_integrator", "max_depth": 2, "n_elements": 16,
                       "time_samples": 1500, "pitch": 0.0005,
                       "angles": np.asarray([0.0], np.float32)},
        "sensor": {"type": "ultrasound_sensor", "num_elements_lateral": 16, "pitch": 0.0005,
                   "radius": float("inf"), "to_world": st()},
        "plate": {"type": "rectangle",
                  "to_world": st().translate([0, 0, 0.02]) @ st().rotate([0, 1, 0], 180)
                  @ st().scale([0.04, 0.04, 1]),
                  "bsdf": {"type": "ultrasound_bsdf", "impedance": 7.8, "roughness": 0.4}},
    }


def das_inputs(n):
    """tpu_rt's dry-run DAS inputs (``__graft_entry__.py:204-212``) for a
    world of n: RF [2, 4, 128] from numpy's generator seeded 0, angles
    -5 and 5 degrees, 4 elements over 3 mm, 2n + 3 columns, 7 rows,
    fs 50 MHz, c 1540 m/s."""
    rng = np.random.default_rng(0)
    return dict(rf=rng.standard_normal((2, 4, 128)).astype(np.float32),
                angles=np.asarray([-5.0, 5.0], np.float32),
                elem_x=np.linspace(-1.5e-3, 1.5e-3, 4, dtype=np.float32),
                x_grid=np.linspace(-2e-3, 2e-3, 2 * n + 3, dtype=np.float32),
                z_grid=np.linspace(0.2e-3, 2e-3, 7, dtype=np.float32),
                fs=50e6, c=1540.0)


# tpu_rt's dry-run shapes; None for a route's spp or rays a pair is the
# world's size (one sample a rank), for a depth the scene's own
SMALL = dict(
    seed=0, tile_rows=16, timing=0,
    train=dict(path=CBOX, res=16, depth=3),
    acq_wave=dict(desc=None, rpp=None),
    acq_kernel=dict(desc=None, rpp=None),
    k1=dict(path=CBOX, res=16, spp=None, depth=2),
    k9=dict(path=SIMPLE, res=32, spp=None),
    stokes=dict(path=CBOX_POL, res=8, spp=None, depth=2, filters=(None,)),
    das=dict(inputs=None, methods=("gather", "matmul"), rf_from=None),
    wave=None,
    acq_grad=None,
)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ms(fn, dev, reps):
    """Median ms of ``reps`` calls of fn after one warm-up (host clock,
    synchronized: the ranks share the device, so CUDA events would time
    the other rank's work too)."""
    fn()
    times = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _timed(route, single, dev, reps, rank):
    """(sharded ms on every rank, rank 0's single-process ms while the
    others wait) for a route."""
    dist.barrier()
    sharded = _ms(route, dev, reps)
    dist.barrier()
    alone = _ms(single, dev, reps) if rank == 0 else None
    dist.barrier()
    return {"sharded_ms": sharded, "single_ms": alone}


def _counted(route):
    """(route(), the kernel launches it made): the counts set to 0 just
    before the call and read just after."""
    from tpu_rt_torch.utils.profiling import launch_counts, reset_launch_counts

    reset_launch_counts()
    res = route()
    return res, launch_counts()


def _collective(t, dev, reps):
    """The median ms of an all-reduce of a tensor like ``t`` over the
    group, and its MiB."""
    x = torch.zeros_like(t)
    return {"allreduce_ms": _ms(lambda: dist.all_reduce(x), dev, reps),
            "allreduce_mib": x.numel() * x.element_size() / 2**20}


def _load(tt, path, res, spp, depth=None, filter_type=None):
    sc = tt.load_file(path, res=res, spp=spp)
    if depth is not None:
        sc = sc.replace(max_depth=depth)
    if filter_type is not None:
        sc = sc.replace(camera=sc.camera.replace(filter_type=filter_type))
    return sc


def _step_psum(n, rank):
    """1/2 (sum_i w x_i)^2 over x = 0..7 split into n contiguous shards:
    (the sum, d/dw at w = 1) on this rank."""
    from tpu_rt_torch.parallel.render import pbroadcast, psum

    w = torch.tensor(1.0, requires_grad=True)
    x = torch.arange(8, dtype=torch.float32).chunk(n)[rank]
    s = psum((pbroadcast(w) * x).sum())
    (0.5 * s * s).backward()
    return {"sum": s.detach(), "grad": w.grad}


def _step_train(tt, cfg, n, rank, dev):
    """One sharded train step on the cbox (tpu_rt's dry run: a zero target,
    the mean squared image, Adam at lr 1e-2)."""
    from tpu_rt_torch.parallel.render import render_pass_sharded, trace_tile

    scene = _load(tt, cfg["path"], cfg["res"], 1, cfg["depth"])
    seed = cfg.get("seed", 0)
    target = torch.zeros((scene.camera.height, scene.camera.width, 3), device=dev)

    def loss_of(fv, fw):
        img = fv / torch.clamp(fw[..., None], min=1e-12)
        return ((img - target) ** 2).mean()

    params = scene.bsdf_params.to(dev).clone().requires_grad_()
    opt = torch.optim.Adam([params], lr=1e-2)
    t0 = time.perf_counter()
    fv, fw, n_rays = render_pass_sharded(scene.replace(bsdf_params=params), seed=seed,
                                         device=dev)
    loss = loss_of(fv, fw)
    opt.zero_grad()
    loss.backward()
    grad = params.grad.clone()
    opt.step()
    _sync(dev)
    out = {"loss": loss.detach(), "grad": grad, "params": params.detach(), "rays": n_rays,
           "ms": (time.perf_counter() - t0) * 1e3}
    if rank == 0:
        leaf = scene.bsdf_params.to(dev).clone().requires_grad_()
        sc = scene.replace(bsdf_params=leaf).to(dev)
        parts = [trace_tile(sc, seed, n, r, max_depth=None) for r in range(n)]
        loss_of(sum(p[0] for p in parts), sum(p[1] for p in parts)).backward()
        out["grad_ref"] = leaf.grad
    return out


def _step_acq(tt, cfg, n, rank, dev, kernel, seed, timing):
    """The sharded acquisition through the wavefront or K10; rank 0's
    reference is the mean of the single-process runs at the ranks'
    seeds."""
    from tpu_rt_torch.integrator import ultrasound as wavefront
    from tpu_rt_torch.ops import us_kernel
    from tpu_rt_torch.parallel import ultrasound as pu
    from tpu_rt_torch.parallel.render import RANK_SEED_STRIDE

    scene = tt.load_dict(cfg["desc"] or plate_desc(tt.ScalarTransform4f))
    rpp = cfg["rpp"] or n
    rpp_local = -(-rpp // n)
    if kernel:
        def route():
            return pu.simulate_acquisition_pallas_sharded(scene, seed=seed, rays_per_pair=rpp,
                                                          device=dev)

        def single(s, rays):
            return us_kernel.simulate_acquisition(scene, seed=us_kernel._wrap_i32(s),
                                                  rays_per_pair=rays, device=dev)[0]
    else:
        def route():
            return pu.simulate_acquisition_sharded(scene, seed=seed, rays_per_pair=rpp,
                                                   device=dev)

        def single(s, rays):
            return wavefront.simulate_acquisition(scene, seed=s, rays_per_pair=rays,
                                                  device=dev)[0]
    (ch, tx), counts = _counted(route)
    out = {"ch": ch, "tx": tx, "counts": counts}
    if rank == 0:
        out["ref"] = sum(single(seed + r * RANK_SEED_STRIDE, rpp_local) for r in range(n)) / n
    if timing:
        out.update(_timed(route, lambda: single(seed, rpp), dev, timing, rank))
        out.update(_collective(ch, dev, timing))
    return out


def _step_k1(tt, cfg, n, rank, dev, seed, tile_rows, timing):
    from tpu_rt_torch.ops import path_kernel as pk
    from tpu_rt_torch.parallel import render as pr
    from tpu_rt_torch.sensor.film import develop

    scene = _load(tt, cfg["path"], cfg["res"], 1, cfg["depth"])
    spp = cfg["spp"] or n

    def route():
        return pr.render_pallas_sharded(scene, spp=spp, seed=seed, tile_rows=tile_rows,
                                        device=dev)

    img, counts = _counted(route)
    out = {"img": img, "rays": pr.render_pallas_sharded.last_ray_count, "counts": counts}
    tables = pk.pack_tables(pk.bake_scene(scene), scene.camera, tile_rows, dev)
    if rank == 0:
        film = sum(pk.film_chunks(tables, pk.film_trace, [(pr.film_seed(seed, r), spp // n)])[0]
                   for r in range(n))
        out["ref"] = develop(film[:3].permute(1, 2, 0), film[3])
    if timing:
        out.update(_timed(route, lambda: pk.render_film(scene, spp=spp, seed=seed, device=dev,
                                                        tile_rows=tile_rows), dev, timing,
                          rank))
        out.update(_collective(torch.zeros((tables.n_val, tables.H, tables.W), device=dev),
                               dev, timing))
    return out


def _step_k9(tt, cfg, n, rank, dev, seed, timing):
    from tpu_rt_torch.ops import mesh_kernel as mk
    from tpu_rt_torch.parallel.render import RANK_SEED_STRIDE
    from tpu_rt_torch.sensor.film import develop

    scene = tt.load_file(cfg["path"], res=cfg["res"], spp=1)
    spp = cfg["spp"] or n

    def route():
        return mk.mesh_direct_render_sharded(scene, spp=spp, seed=seed, device=dev)

    img, counts = _counted(route)
    out = {"img": img, "rays": mk.mesh_direct_render_sharded.last_ray_count, "counts": counts}
    if rank == 0:
        ds = mk._direct_inputs(scene, None, dev)
        fv = fw = 0
        for r in range(n):
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed + r * RANK_SEED_STRIDE)
            pv, pw, _ = mk._direct_films(ds, scene.camera, spp // n, gen, dev, 64)
            fv, fw = fv + pv, fw + pw
        out["ref"] = develop(fv, fw)
    if timing:
        out.update(_timed(route, lambda: mk.mesh_direct_render(scene, spp=spp, seed=seed,
                                                               device=dev), dev, timing, rank))
        out.update(_collective(torch.zeros((4, *img.shape[:2]), device=dev), dev, timing))
    return out


def _step_stokes(tt, cfg, n, rank, dev, seed, tile_rows, timing, filter_type):
    """The sharded Stokes render with the scene's filter (``filter_type``
    None) or another; rank 0's reference: the ranks' partial films
    summed (K3: ``path_kernel.film_chunks``, K6: ``path_kernel.sample_film``), and for
    box / tent ``render_stokes_film(spp, spp_per_pass=k)``."""
    from tpu_rt_torch.ops import path_kernel as pk
    from tpu_rt_torch.parallel import render as pr
    from tpu_rt_torch.scene.types import FILTER_BOX, FILTER_TENT
    from tpu_rt_torch.sensor.film import develop

    scene = _load(tt, cfg["path"], cfg["res"], 1, cfg["depth"], filter_type)
    c = scene.camera
    spp = cfg["spp"] or n
    k = spp // n

    def route():
        return pr.render_stokes_pallas_sharded(scene, spp=spp, seed=seed, tile_rows=tile_rows,
                                               device=dev)

    S, counts = _counted(route)
    out = {"img": S, "rays": pr.render_stokes_pallas_sharded.last_ray_count,
           "filter": c.filter_type, "counts": counts}
    tables = pk.pack_tables(pk.bake_scene(scene), c, tile_rows, dev, stokes=True)
    film_route = c.filter_type in (FILTER_BOX, FILTER_TENT)
    if rank == 0:
        if film_route:
            film = sum(pk.film_chunks(tables, pk.stokes_film_trace,
                                      [(pr.film_seed(seed, r, k), k)])[0] for r in range(n))
            S_ref = develop(film[:12].permute(1, 2, 0), film[12])
            out["ref_film"] = pk.render_stokes_film(scene, spp=spp, seed=seed, device=dev,
                                                    spp_per_pass=k, tile_rows=tile_rows)[0]
        else:
            parts = [pk.sample_film(tables, pk.stokes_sample_trace, pk.sample_planes_split, k,
                                    pr.sample_seed(seed, r, k), k, c.filter_type)
                     for r in range(n)]
            S_ref = develop(sum(p[0] for p in parts), sum(p[1] for p in parts))
        out["ref"] = S_ref.reshape(c.height, c.width, 4, 3)
    if timing:
        def single():
            if film_route:
                return pk.render_stokes_film(scene, spp=spp, seed=seed, device=dev,
                                             spp_per_pass=k, tile_rows=tile_rows)
            return pk.sample_film(tables, pk.stokes_sample_trace, pk.sample_planes_split, spp,
                                  pr.sample_seed(seed, 0, spp), spp, c.filter_type)

        out.update(_timed(route, single, dev, timing, rank))
        planes = tables.n_val if film_route else 13
        out.update(_collective(torch.zeros((planes, c.height, c.width), device=dev), dev,
                               timing))
    return out


def _step_das(cfg, n, rank, dev, rf, timing):
    """The sharded DAS in each form on ``rf`` (or the configuration's
    inputs), and its gradient in the RF (of half the image's squared
    norm, through the tiles' all_gather); rank 0's references: the
    single-process function on the same inputs (the matmul form with the
    window sized from the full grid) and its gradient."""
    from tpu_rt_torch.parallel import ultrasound as pu
    from tpu_rt_torch.us.beamform import das_beamform, das_beamform_matmul

    d = dict(cfg["inputs"] or das_inputs(n))
    rf = torch.as_tensor(d["rf"], device=dev) if rf is None else rf.detach()
    geo = {k: torch.as_tensor(d[k], device=dev) for k in ("angles", "elem_x", "x_grid",
                                                          "z_grid")}
    ez = None if d.get("elem_z") is None else torch.as_tensor(d["elem_z"], device=dev)
    rest = (geo["angles"], geo["elem_x"], d["fs"], d["c"], geo["x_grid"], geo["z_grid"])
    window = pu.das_window(geo["x_grid"], geo["z_grid"], d["fs"], d["c"])
    singles = {"gather": lambda x: das_beamform(x, *rest, elem_z=ez),
               "matmul": lambda x: das_beamform_matmul(x, *rest, elem_z=ez, window=window)}

    def grad(fn):
        leaf = rf.clone().requires_grad_()
        img = fn(leaf)
        (0.5 * (img * img).sum()).backward()
        return leaf.grad

    out = {"counts": {}}
    for method in cfg["methods"]:
        def route(x=rf, method=method):
            return pu.das_beamform_sharded(x, *rest, elem_z=ez, method=method)

        single = singles[method]
        res = {}
        res["img"], out["counts"][method] = _counted(route)
        res["grad"] = grad(route)
        if rank == 0:
            res["ref"] = single(rf)
            res["grad_ref"] = grad(single)
        if timing:
            res.update(_timed(route, lambda: single(rf), dev, timing, rank))
        out[method] = res
    return out


def _step_wave(tt, cfg, n, rank, dev, seed):
    from tpu_rt_torch.parallel.render import render_sharded

    scene = _load(tt, cfg["path"], cfg["res"], 1, cfg["depth"])
    img = render_sharded(scene, spp=cfg["spp"], seed=seed, device=dev)
    return {"img": img, "rays": render_sharded.last_ray_count}


def _step_acq_grad(tt, cfg, n, rank, dev):
    """d sum(ch^2) / d the BSDF table through the sharded wavefront, rank
    r fed ``cfg["uniforms"][r]``."""
    from tpu_rt_torch.parallel.ultrasound import simulate_acquisition_sharded

    scene = tt.load_dict(cfg["desc"])
    leaf = scene.bsdf_params.clone().requires_grad_()
    uniforms = [{k: torch.as_tensor(v) for k, v in u.items()} for u in cfg["uniforms"]]
    ch, _ = simulate_acquisition_sharded(scene.replace(bsdf_params=leaf), seed=cfg["seed"],
                                         rays_per_pair=cfg["rpp"], device=dev,
                                         uniforms=uniforms)
    (ch * ch).sum().backward()
    return {"ch": ch, "grad": leaf.grad}


def dryrun_steps(rank, n, device, cfg=None):
    """One rank of the dry run (``run_world``'s function): every step of
    ``cfg`` (``SMALL`` by default; a step set to None is left out).
    Returns a dict of each step's results, with ``counts``: each step's
    kernel launches on this rank (the counts set to 0 just before the
    step's sharded call and read just after; rank 0's references and the
    timed repeats are not counted)."""
    import tpu_rt_torch as tt
    from tpu_rt_torch.utils.profiling import launch_counts, reset_launch_counts

    cfg = dict(SMALL, **(cfg or {}))
    seed, tile_rows = cfg["seed"], cfg["tile_rows"]
    timing = cfg["timing"]
    dev = torch.device(device)
    out = {"psum": _step_psum(n, rank), "counts": {}}

    def run(name, fn, *args):
        reset_launch_counts()
        t0 = time.perf_counter()
        res = fn(*args)
        _sync(dev)
        res["step_s"] = time.perf_counter() - t0
        out["counts"][name] = res.pop("counts") if "counts" in res else launch_counts()
        out[name] = res

    if cfg["train"] is not None:
        run("train", _step_train, tt, dict(cfg["train"], seed=seed), n, rank, dev)
    if cfg["acq_wave"] is not None:
        run("acq_wave", _step_acq, tt, cfg["acq_wave"], n, rank, dev, False, seed, 0)
    if cfg["acq_kernel"] is not None:
        run("acq_kernel", _step_acq, tt, cfg["acq_kernel"], n, rank, dev, True, seed,
            timing)
    if cfg["k1"] is not None:
        run("k1", _step_k1, tt, cfg["k1"], n, rank, dev, seed, tile_rows, timing)
    if cfg["k9"] is not None:
        run("k9", _step_k9, tt, cfg["k9"], n, rank, dev, seed, timing)
    if cfg["stokes"] is not None:
        for f in cfg["stokes"]["filters"]:
            run(f"stokes_{f}", _step_stokes, tt, cfg["stokes"], n, rank, dev, seed,
                tile_rows, timing, f)
    if cfg["das"] is not None:
        rf = None
        if cfg["das"].get("rf_from") == "acq_kernel":
            rf = torch.as_tensor(out["acq_kernel"]["ch"], device=dev)
        run("das", _step_das, cfg["das"], n, rank, dev, rf, timing)
    if cfg["wave"] is not None:
        run("wave", _step_wave, tt, cfg["wave"], n, rank, dev, seed)
    if cfg["acq_grad"] is not None:
        run("acq_grad", _step_acq_grad, tt, cfg["acq_grad"], n, rank, dev)
    return out


def dryrun_multichip(n_devices, backend=None, device="cuda", cbox=CBOX, simple=SIMPLE,
                     cbox_pol=CBOX_POL, timeout=600.0):
    """tpu_rt's ``dryrun_multichip`` over ``n_devices`` spawned ranks:
    ``dryrun_steps`` at tpu_rt's tiny shapes on the repository's fixtures,
    with rank 0's references.  ``device`` "cuda" puts rank r on GPU r %
    count (``backend`` NCCL by default: one process a GPU), "cpu" on the
    CPU (gloo by default).  Prints a line a step, raises on a non-finite or
    empty result, ranks that disagree, or a route that differs from its
    single-process references beyond their tolerances (DAS: tpu_rt's
    rtol 1e-6 / atol 1e-7; the rest 1e-5 of the largest value, the sums
    taken in another order).  Returns the ranks' results."""
    if backend is None:
        backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    cfg = dict(SMALL, train=dict(SMALL["train"], path=cbox), k1=dict(SMALL["k1"], path=cbox),
               k9=dict(SMALL["k9"], path=simple), stokes=dict(SMALL["stokes"], path=cbox_pol))
    res = run_world(dryrun_steps, n_devices, args=(cfg,), backend=backend, device=device,
                    timeout=timeout)
    r0 = res[0]
    tag = f"dryrun_multichip({n_devices})"

    def close(a, b, what, rtol=1e-5, atol=None):
        a, b = np.asarray(a), np.asarray(b)
        atol = rtol * max(float(np.abs(b).max()), 1e-30) if atol is None else atol
        if a.shape != b.shape or not np.isfinite(a).all() or not np.allclose(a, b, rtol=rtol,
                                                                             atol=atol):
            raise AssertionError(f"{tag}: {what} differs from its single-process reference")

    for r in res:
        if float(r["psum"]["grad"]) != 784.0 or float(r["psum"]["sum"]) != 28.0:
            raise AssertionError(f"{tag}: the gradient through psum / pbroadcast is "
                                 f"{float(r['psum']['grad'])}, not 784")
        if not np.array_equal(r["train"]["params"], r0["train"]["params"]):
            raise AssertionError(f"{tag}: the ranks' parameters differ after the Adam step")
    loss = float(r0["train"]["loss"])
    if not np.isfinite(loss) or not np.isfinite(r0["train"]["params"]).all():
        raise AssertionError(f"{tag}: the train step is not finite")
    close(r0["train"]["grad"], r0["train"]["grad_ref"], "the train step's gradient")
    print(f"{tag}: one sharded train step OK, loss={loss:.6g}")
    for name, label in (("acq_wave", "sharded acquisition"),
                        ("acq_kernel", "sharded US kernel")):
        ch = r0[name]["ch"]
        total = float(np.abs(ch).sum())
        if not (np.isfinite(total) and total > 0.0):
            raise AssertionError(f"{tag}: {label} gave no echo")
        close(ch, r0[name]["ref"], label, rtol=1e-6)
        print(f"{tag}: {label} OK, |RF|={total:.6g}")
    img = r0["k1"]["img"]
    if not (np.isfinite(img).all() and img.max() > 0.0):
        raise AssertionError(f"{tag}: the sharded film kernel render is empty")
    close(img, r0["k1"]["ref"], "the sharded film kernel render")
    print(f"{tag}: sharded film kernel render OK, mean={img.mean():.6g}, "
          f"rays={int(r0['k1']['rays'])}")
    img = r0["k9"]["img"]
    close(img, r0["k9"]["ref"], "the sharded direct mesh kernel render")
    print(f"{tag}: sharded direct mesh kernel OK, mean={img.mean():.6g}")
    S = r0["stokes_None"]["img"]
    if not (np.isfinite(S).all() and S[..., 0, :].max() > 0.0):
        raise AssertionError(f"{tag}: the sharded Stokes render is empty")
    close(S, r0["stokes_None"]["ref"], "the sharded Stokes render")
    print(f"{tag}: sharded Stokes kernel OK, I mean={S[..., 0, :].mean():.6g}")
    for method in cfg["das"]["methods"]:
        d = r0["das"][method]
        close(d["img"], d["ref"], f"the sharded DAS ({method})", rtol=1e-6, atol=1e-7)
        close(d["grad"], d["grad_ref"], f"the sharded DAS's gradient ({method})")
        print(f"{tag}: sharded DAS ({method}) OK, |bf|={np.abs(d['img']).sum():.6g}")
    return res


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    dryrun_multichip(int(args[0]) if args else 2,
                     device="cpu" if "--cpu" in sys.argv else "cuda")
