"""USMain's roughness loop (USMain.py:262-298) on the card in the variants
that tell the objective apart from the gradient estimator, through
``chip_smoke.py::roughness_loop`` (the loop phase 32 runs and gates).

    python tools/us_roughness_loop.py [--scene usmain|plate] [--rpp 64]
        [--steps 25] [--variants das:kernel:0,bmode:kernel:0,...]
        [--grad-stats N] [--scan] [--out FILE.json]

A variant is ``objective:route:seed``:

* objective: ``bmode`` (us_render's B-mode, USMain's), ``envelope``,
  ``das`` or ``rf`` (the DAS's image before the log, before the
  envelope, or the RF, each over the target's mean square);
* route: ``kernel`` (K10's primal, fastgrad's backward: the acoustic
  wavefront replayed on its own stream) or ``wave`` (the wavefront
  forward and backward on one stream, the frame's exact gradient);
* seed: the target and every step at that seed (the loss is 0 at 0.7).

USMain's frames cover us_render's grid (x within 4 cm, z 1-50 mm).
``--scene plate`` takes the plate of tpu_rt's roughness recovery test
(``chip_smoke.py::recovery_plate``: 16 elements, angles -5 and 5, 600
samples, depth 2, the plate at 8 mm) and beamforms x within 4 mm, z 6-10
mm.  Prints each variant's summary (final roughness, loss, the steps
whose gradient points toward 0.7, seconds) and whether it meets tpu_rt's
recovery bars.  ``--grad-stats N`` also takes, for each objective and
route named, the gradient at roughness 0.1 on seeds 0..N-1 (the target
at 0.7 on the same seed): its mean, standard error and the seeds whose
gradient points toward 0.7.
``--scan`` also takes, for each objective and seed named, the loss of the
kernel route's frame (no gradient) at roughness 1e-4, 0.05, 0.1, 0.2, ...,
0.7 against the target at 0.7: where a loop started at 0.1 can descend
to.  Needs a CUDA device.
"""

import argparse
import importlib.util
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

R0 = 0.1
SCAN = (1e-4, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7)


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def grad_stats(cs, tt, scene, key, dev, objective, use_kernel, n, r0, rpp, bounds):
    """d loss / d roughness at ``r0`` on seeds 0..n-1: mean, its standard
    error, and how many point toward the target."""
    from tpu_rt_torch.opt import inverse

    row = scene.ids["shape_bsdf"][scene.ids["shapes"][key.split(".")[0]]]
    grads = []
    for seed in range(n):
        with torch.no_grad():
            target = cs.loop_frame(tt, inverse.set_param(scene, key, cs.ROUGH_TARGET),
                                   seed, objective, use_kernel, rpp, dev, bounds)
        p = inverse.set_param(scene, key, r0).bsdf_params.clone().requires_grad_()
        frame = cs.loop_frame(tt, scene.replace(bsdf_params=p), seed, objective, use_kernel,
                              rpp, dev, bounds)
        cs.loop_loss(frame, target, objective).backward()
        grads.append(p.grad[row, 1].item())
    g = np.asarray(grads)
    return dict(mean=float(g.mean()), sem=float(g.std(ddof=1) / np.sqrt(n)),
                toward=int((g < 0).sum()), n=n, grads=grads)


def loss_scan(cs, tt, scene, key, dev, objective, seed, rpp, bounds):
    """The kernel route's loss at each roughness of SCAN, the target at 0.7
    and every frame at ``seed``."""
    from tpu_rt_torch.opt import inverse

    with torch.no_grad():
        frame = [cs.loop_frame(tt, inverse.set_param(scene, key, r), seed, objective, True, rpp,
                               dev, bounds) for r in SCAN]
        return [float(cs.loop_loss(f, frame[-1], objective)) for f in frame]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", choices=("usmain", "plate"), default="usmain")
    ap.add_argument("--rpp", type=int, default=64)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--variants", default="das:kernel:0,envelope:kernel:0,bmode:kernel:0")
    ap.add_argument("--grad-stats", type=int, default=0)
    ap.add_argument("--scan", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    cs = chip_smoke()
    import tpu_rt_torch as tt
    from torch_port_scenes import usmain_desc

    dev = torch.device("cuda")
    st = tt.ScalarTransform4f
    if args.scene == "plate":
        scene, key, bounds = cs.recovery_plate(tt), cs.PLATE_KEY, cs.PLATE_WINDOW
    else:
        scene = tt.load_dict(usmain_desc(st))
        key, bounds = cs.ROUGH_KEY, cs.US_FULL
    results, stats, scans = [], [], []
    for variant in args.variants.split(",") if args.steps else ():
        objective, route, seed = variant.split(":")
        r = cs.roughness_loop(tt, scene, dev, objective=objective, use_kernel=route == "kernel",
                              seed=int(seed), rpp=args.rpp,
                              n_iters=args.steps, bounds=bounds, key=key)
        r["variant"] = variant
        r["meets_bars"] = bool(r["losses"][-1] < cs.LOSS_BAR * r["losses"][0]
                               and abs(r["final"] - cs.ROUGH_TARGET) < cs.ROUGH_BAR)
        cs.print_loop(f"{args.scene} {variant} (rpp {args.rpp})", r, per_step=False)
        print(f"  meets tpu_rt's bars (loss x{cs.LOSS_BAR}, roughness within {cs.ROUGH_BAR}): "
              f"{r['meets_bars']}", flush=True)
        results.append(r)
    if args.grad_stats:
        for objective, route in sorted({tuple(v.split(":")[:2]) for v in
                                        args.variants.split(",")}):
            s = grad_stats(cs, tt, scene, key, dev, objective, route == "kernel", args.grad_stats,
                           R0, args.rpp, bounds)
            s.update(objective=objective, route=route, r0=R0)
            print(f"gradient at roughness {R0}, {objective}:{route}, seeds 0-"
                  f"{args.grad_stats - 1}: mean {s['mean']:+.4e}, standard error {s['sem']:.4e}"
                  f", toward 0.7 on {s['toward']} of {s['n']}", flush=True)
            stats.append(s)
    if args.scan:
        for objective, seed in sorted({(v.split(":")[0], v.split(":")[2]) for v in
                                       args.variants.split(",")}):
            losses = loss_scan(cs, tt, scene, key, dev, objective, int(seed), args.rpp, bounds)
            scans.append(dict(objective=objective, seed=int(seed), roughness=SCAN,
                              losses=losses))
            print(f"loss against roughness, {objective}, seed {seed}: " + ", ".join(
                f"{r:g} {v:.4e}" for r, v in zip(SCAN, losses)), flush=True)
    summary = dict(device=torch.cuda.get_device_name(0), scene=args.scene, rpp=args.rpp,
                   steps=args.steps, results=results, grad_stats=stats,
                   scans=scans)
    print(json.dumps({"device": summary["device"], "final": {r["variant"]: r["final"]
                                                             for r in results}}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
