"""The benchmark's run: a cell found by name, its set-up, a closed-loop
window of calls, the check against the plain reference, and the result.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

* ``configs/<config>.json``: the configuration as it is run (``kind``,
  the scene or its file under ``configs/``);
* ``reference/<config>.py``: its plain reference (with ``tiny_config``,
  the configuration's cut for the benchmark's CPU tests, where it needs
  one);
* ``traffic/<traffic>.json``: the mix (``kind``: the entry it drives; its
  sizes; ``check_outputs``, how many completed calls are checked;
  ``limits`` of the compared numbers);
* ``drivers/<kind>.py``: a traffic kind's ``Entry`` (the program's set-up,
  one call of the timed path, the check of kept outputs against the
  reference) and its ``Control`` (the reference in bfloat16 in the
  program's place), and ``TINY``, the traffic keys that the benchmark's
  CPU tests cut; the program (``tpu_rt_torch``) is imported there and
  nowhere else in a run;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``,
  which returns a number or None where the cell has nothing to read.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import random
import sys
import time

import torch

import devtrace
import yardstick

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_rt")


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_bench(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find_cell(bench, name, bench_dir=HERE):
    """(workload entry, configuration, traffic, reference module) of the
    cell ``name``, each found by its name."""
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = load_json(os.path.join(bench_dir, "configs", wl["config"] + ".json"))
    cfg["dir"] = os.path.join(bench_dir, "configs")
    trf = load_json(os.path.join(bench_dir, "traffic", wl["traffic"] + ".json"))
    ref = load_module(os.path.join(bench_dir, "reference", wl["config"] + ".py"),
                      "portbench_reference_" + wl["config"].replace("-", "_").replace(".", "_"))
    return wl, cfg, trf, ref


def driver(kind, bench_dir=HERE):
    """The module of the traffic kind ``kind``: its ``Entry`` and
    ``Control``."""
    return load_module(os.path.join(bench_dir, "drivers", kind + ".py"),
                       "portbench_driver_" + kind.replace(".", "_").replace("-", "_"))


def metric_reader(name, bench_dir=HERE):
    return load_module(os.path.join(bench_dir, "metrics", name + ".py"),
                       "portbench_metric_" + name.replace(".", "_").replace("-", "_"))


def call_seed(run_seed, i):
    """Call i's seed in [0, 2^31): SplitMix64 of (run seed, i)."""
    z = (run_seed * 0x9E3779B97F4A7C15 + (i + 1) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2 ** 64 - 1)
    return (z ^ (z >> 31)) & 0x7FFFFFFF


def forbidden_modules():
    """The top-level names of loaded modules that are JAX or the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window(entry, run_seed, seconds, device, n_check):
    """Closed loop: calls back to back, each ended by a synchronise, until
    ``seconds`` have passed.  Returns (latencies s, window s, kept), kept
    holding ``n_check`` completed calls drawn uniformly by reservoir
    sampling from the run's seed: (index, seed, outputs)."""
    pick = random.Random(run_seed)
    kept, lat = [], []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    t_end = t_start
    i = 0
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline:
            break
        s = call_seed(run_seed, i)
        out = entry.call(s)
        _sync(device)
        t_end = time.perf_counter()
        lat.append(t_end - t0)
        if len(kept) < n_check:
            kept.append((i, s, out))
        else:
            j = pick.randrange(i + 1)
            if j < n_check:
                kept[j] = (i, s, out)
        del out
        i += 1
    return lat, t_end - t_start, kept


def run(args, device, t_proc0, entry_hook=None, out=sys.stdout, err=sys.stderr,
        bench_dir=HERE, root=ROOT):
    """One run of a cell; prints the result line and returns it (None
    where the run must fail).  ``entry_hook(entry)`` may wrap the entry:
    the traffic kind's ``Control`` puts the reference in bfloat16 in the
    program's place, and the tests break the timed path with it."""
    bench = load_bench(root)
    wl, cfg, trf, ref = find_cell(bench, args.workload, bench_dir)
    entry = driver(trf["kind"], bench_dir).Entry(cfg, trf, ref, device)
    if entry_hook is not None:
        entry = entry_hook(entry)
    warm = entry.call(call_seed(args.seed, -1))
    _sync(device)
    del warm
    setup_s = time.perf_counter() - t_proc0

    trace = None
    if args.trace:
        trace = devtrace.Recorder(device)
        with trace:
            lat, win_s, kept = window(entry, args.seed, args.seconds, device,
                                      trf["check_outputs"])
    else:
        lat, win_s, kept = window(entry, args.seed, args.seconds, device, trf["check_outputs"])
    n = len(lat)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    shapes = entry.shapes
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    values = entry.check(kept, args.seed)
    del kept
    limits = trf["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    correct = all(math.isfinite(v) and v <= limits[k] for k, v in values.items())
    failed = 0 if correct else trf["check_outputs"]

    metrics = {}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": n, "failed": failed}
    if args.trace:
        ctx = trace.context(n, shapes, getattr(entry, "counts", None))
        for m in bench["per_layer"]:
            if wl["name"] not in m.get("workloads", [wl["name"]]):
                continue
            v = metric_reader(m["name"], bench_dir).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info["busy_s"] = ctx.busy_s
        device_info["window_s"] = ctx.window_s
        result["breakdown"] = ctx.breakdown()
    else:
        e2e = {m["name"]: m for m in bench["end_to_end"]
               if wl["name"] in m.get("workloads", [wl["name"]])}
        per_call = {"ms": 1e3 * win_s / n, "p95_ms": 1e3 * yardstick.percentile(lat, 95)}
        for name, m in e2e.items():
            if name == "setup_s":
                metrics[name] = {"value": setup_s, "unit": "s"}
            else:
                metrics[name] = {"value": per_call[trf["metrics"][name]], "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device_info
    result["checks"] = checks

    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=err)
        return None
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=err)
    print(json.dumps(result), file=out)
    out.flush()
    return result
