"""tpu_rt's fastgrad loop beside the port's, on the CPU: the roughness
recovery of tests/test_parallel_and_grad.py::
test_inverse_rendering_recovers_roughness (the plate at 8 mm, 16
elements, angles -5 and 5, 600 samples, depth 2; 0.1 toward 0.7, Adam at
lr 2e-2 clipped to [1e-4, 1], 25 steps) run through each package's
kernel route, whose gradient is the acoustic wavefront's on its own
random stream (tpu_rt's ``simulate_acquisition_fastgrad``, interpret
mode; the port's, K10's plain version as the primal).

    JAX_PLATFORMS=cpu python tests/torch_fastgrad_witness.py
        [--objective rf|bmode] [--rpp 8] [--seeds 0-11]
        [--packages tpu_rt,port] [--route kernel|wave] [--jobs 8]

``rf``: the test's own loss, the RF's MSE times 1e6; ``bmode``: the B-mode
MSE (USMain.py:262-298's objective) of us_render over x within 4 mm, z
6-10 mm.  Seed s makes the target (at 0.7) and every step.  Prints, per
package and seed, the final roughness, the loss's ratio and whether the
loop meets the test's bars (the loss down to 0.7 of its first value, the
roughness within 0.25 of 0.7), then a count a package.  Not a test: a
witness of what each package's fastgrad does on an objective, by loops
of tens of seconds each in tpu_rt's interpret mode.
"""

import argparse
import multiprocessing as mp
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
WINDOW = dict(x_bounds=(-0.004, 0.004), z_bounds=(0.006, 0.010))
KEY = "plate.bsdf.roughness"


def _loop(job):
    package, route, objective, rpp, seed = job
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.dirname(HERE))
    sys.path.insert(0, HERE)
    from torch_port_scenes import plate_desc

    kernel = route == "kernel"
    desc = dict(roughness=0.1, angles=(-5.0, 5.0), z=0.008, time_samples=600, max_depth=2)
    if package == "tpu_rt":
        import jax.numpy as jnp

        import tpu_rt
        from tpu_rt.integrator.ultrasound import simulate_acquisition
        from tpu_rt.opt.inverse import get_param, optimize, set_param
        from tpu_rt.ops.pallas_us import simulate_acquisition_fastgrad
        from tpu_rt.us.pipeline import us_render

        scene = tpu_rt.load_dict(plate_desc(tpu_rt.ScalarTransform4f, **desc))
        if objective == "rf":
            def frame(sc):
                if kernel:
                    return simulate_acquisition_fastgrad(sc, seed, rpp, True)[0]
                return simulate_acquisition(sc, seed=seed, rays_per_pair=rpp)[0]
        else:
            def frame(sc):
                return us_render(sc, seed=seed, rays_per_pair=rpp, use_pallas=kernel, **WINDOW)[0]
        mean = jnp.mean
    else:
        import torch

        torch.set_num_threads(1)
        import tpu_rt_torch as tt
        from tpu_rt_torch.integrator.ultrasound import simulate_acquisition
        from tpu_rt_torch.ops.us_kernel import simulate_acquisition_fastgrad
        from tpu_rt_torch.opt.inverse import get_param, optimize, set_param

        scene = tt.load_dict(plate_desc(tt.ScalarTransform4f, **desc))
        if objective == "rf":
            acquire = simulate_acquisition_fastgrad if kernel else simulate_acquisition

            def frame(sc):
                return acquire(sc, seed=seed, rays_per_pair=rpp, device="cpu")[0]
        else:
            def frame(sc):
                return tt.us_render(sc, seed=seed, rays_per_pair=rpp, use_kernel=kernel,
                                    device="cpu", **WINDOW)[0]
        mean = torch.mean
    scale = 1e6 if objective == "rf" else 1.0
    target = frame(set_param(scene, KEY, 0.7))
    if package == "port":
        target = target.detach()
    out, losses = optimize(scene, [KEY], lambda sc: mean((frame(sc) - target) ** 2) * scale,
                           n_iters=25, lr=2e-2, bounds=(1e-4, 1.0))
    final = float(get_param(out, KEY))
    ratio = losses[-1] / losses[0]
    return job, final, ratio, bool(ratio < 0.7 and abs(final - 0.7) < 0.25)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--objective", choices=("rf", "bmode"), default="rf")
    ap.add_argument("--rpp", type=int, default=8)
    ap.add_argument("--seeds", default="0-11")
    ap.add_argument("--packages", default="tpu_rt,port")
    ap.add_argument("--route", choices=("kernel", "wave"), default="kernel")
    ap.add_argument("--jobs", type=int, default=8)
    args = ap.parse_args()
    lo, _, hi = args.seeds.partition("-")
    seeds = range(int(lo), int(hi or lo) + 1)
    jobs = [(p, args.route, args.objective, args.rpp, s)
            for p in args.packages.split(",") for s in seeds]
    with mp.get_context("spawn").Pool(args.jobs) as pool:
        results = pool.map(_loop, jobs)
    met = {}
    for (package, route, objective, rpp, seed), final, ratio, ok in results:
        print(f"{package:6s} {route} {objective} rpp {rpp} seed {seed:2d}: roughness 0.1 -> "
              f"{final:.4f}, loss x{ratio:.4f}, meets the bars {ok}", flush=True)
        met.setdefault(package, []).append(ok)
    for package, oks in met.items():
        print(f"{package}: the bars met on {sum(oks)} of {len(oks)} seeds")


if __name__ == "__main__":
    main()
