"""Monte-Carlo noise of the ultrasound traffic against its rays a pair,
on the card: what backs a traffic mix's ``rays_per_pair``.

    python3 portbench/convergence.py --config picmus-l11 --traffic bmode.rpp64 \
        --rpp 16 64 256 1024 4096 16384 --seeds 6 --out build/convergence.json

For each number of rays an (angle, element) pair, ``--seeds`` independent
acquisitions of the configuration (``simulate_acquisition``, the
kernel's route) and their B-mode over the traffic's grid.  Prints, a
line each, the relative noise of one acquisition: the standard deviation
over seeds, summed over every sample, over the norm of the seeds' mean,

* ``rf_noise``: of the channel data [A, E, T];
* ``env_noise``: of the envelope of the DAS image, before the log;
* ``bmode_noise_db``: the RMS over pixels of the displayed B-mode's
  standard deviation, in dB of its dynamic range.

The benchmark's own runs do not run this.
"""

import argparse
import copy
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def rel_noise(xs):
    """sqrt(sum over elements of the unbiased variance over seeds) over
    the norm of the mean: the relative RMS error of one sample."""
    import torch

    st = torch.stack([x.double() for x in xs])
    mean = st.mean(0)
    var = ((st - mean) ** 2).sum(0) / (len(xs) - 1)
    return math.sqrt(float(var.sum())) / max(float(mean.norm()), 1e-300)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="picmus-l11")
    p.add_argument("--traffic", default="bmode.rpp64")
    p.add_argument("--rpp", type=int, nargs="+", default=[16, 64, 256, 1024, 4096, 16384])
    p.add_argument("--seeds", type=int, default=6)
    p.add_argument("--first-seed", type=int, default=8_100_000_001)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import tpu_rt_torch as tt
    from tpu_rt_torch.ops.us_kernel import simulate_acquisition
    from tpu_rt_torch.sensor.transducer import element_geometry
    from tpu_rt_torch.us.beamform import das_beamform, grid_scan, hilbert_envelope, log_compress

    with open(os.path.join(HERE, "configs", args.config + ".json")) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "traffic", args.traffic + ".json")) as f:
        trf = json.load(f)
    dev = torch.device(args.device)
    scene = tt.load_dict(copy.deepcopy(cfg["scene"]))
    us = scene.ultrasound
    pos, _ = element_geometry(us.n_elements, us.pitch, us.radius, us.opening_angle)
    ex, ez, angles = pos[:, 0].to(dev), pos[:, 2].to(dev), us.angles.to(dev)
    step = float(us.sound_speed) / float(us.frequency) / 4.0
    (x0, x1), (z0, z1) = trf["x_bounds"], trf["z_bounds"]
    xg, zg = (g.to(dev) for g in grid_scan(x0, x1, z0, z1, step, step))
    dr = trf.get("dynamic_range", 60.0)
    rows = []
    for rpp in args.rpp:
        rfs, envs, bms = [], [], []
        for k in range(args.seeds):
            rf, _ = simulate_acquisition(scene, seed=args.first_seed + k, rays_per_pair=rpp,
                                         device=dev)
            bf = das_beamform(rf, angles, ex, us.sampling_rate, us.sound_speed, xg, zg,
                              elem_z=ez)
            env = hilbert_envelope(bf, axis=1)
            rfs.append(rf.cpu())
            envs.append(env.cpu())
            bms.append(log_compress(env, dr).cpu())
        st = torch.stack([b.double() for b in bms])
        bm_db = dr * math.sqrt(float(st.var(0, unbiased=True).mean()))
        row = {"rays_per_pair": rpp, "lanes": rpp * us.n_angles * us.n_elements,
               "rf_noise": rel_noise(rfs), "env_noise": rel_noise(envs),
               "bmode_noise_db": bm_db, "seeds": args.seeds}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del rfs, envs, bms
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"config": args.config, "traffic": args.traffic, "rows": rows,
                       "device": torch.cuda.get_device_name(0) if dev.type == "cuda"
                       else "cpu"}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
