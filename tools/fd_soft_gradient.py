"""The soft-shadow gradient against finite differences of the hard render,
over seeds, on tpu_rt's rod scene (tests/test_projective.py:99-135).

For each seed: d(shadow band) / d(x-translation of the rod) by autograd of
``integrator/projective.py::render_soft``'s estimate at each ``--width``
(``--spp-ad`` samples; ``tests/torch_port_scenes.py::soft_band_grad``, 64
samples a pixel a trace), and the central difference of the hard render
(``tests/torch_port_scenes.py::hard_band_loss``, the box-filtered render
traced 64 samples a pixel a call; the same seed at +-``--delta``: common
random numbers) at each ``--spp-fd``.  Prints one line a seed, then each
estimator's mean and standard deviation over the seeds and the relative
difference of the means; ``--out`` writes the numbers as JSON.

    python tools/fd_soft_gradient.py --seeds 16 --width 0.015 0.0075 \\
        --spp-fd 1024 4096 --out chiprun_out/fd.json

Runs on the card by default (``--device cpu`` for a small rehearsal).
"""

import argparse
import json
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main(argv=None):
    import tpu_rt_torch as tt
    from torch_port_scenes import hard_band_loss, rod_desc, soft_band_grad, write_rod

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--spp-ad", type=int, default=512)
    ap.add_argument("--width", type=float, nargs="+", default=[0.015])
    ap.add_argument("--delta", type=float, default=0.02)
    ap.add_argument("--spp-fd", type=int, nargs="+", default=[1024])
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("fd_soft_gradient: no CUDA device; pass --device cpu")
    work = os.path.join(ROOT, "build", "fd_soft_gradient")
    os.makedirs(work, exist_ok=True)

    def rod_scene(dx):
        path = os.path.join(work, f"rod_{dx:+.5f}.txt")
        write_rod(path, 0.25 + dx, 2.0, 0.08)
        return tt.load_dict(rod_desc(tt.ScalarTransform4f, path, res=args.res))

    rod = rod_scene(0.0)
    plus, minus = rod_scene(args.delta), rod_scene(-args.delta)
    rows = []
    for seed in range(args.seeds):
        t0 = time.perf_counter()
        row = {"seed": seed, "ad": {}, "fd": {}}
        for width in args.width:
            row["ad"][str(width)] = soft_band_grad(rod, args.spp_ad, 1000 + seed, width, dev)[1]
        for spp in args.spp_fd:
            lp, lm = (hard_band_loss(sc, spp, seed, dev) for sc in (plus, minus))
            row["fd"][str(spp)] = (lp - lm) / (2 * args.delta)
        rows.append(row)
        print(f"seed {seed}: soft " + ", ".join(f"w {w} {v:+.6e}" for w, v in row["ad"].items())
              + "; FD " + ", ".join(f"{s} spp {v:+.6e}" for s, v in row["fd"].items())
              + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    def stats(vals):
        return statistics.mean(vals), statistics.stdev(vals) if len(vals) > 1 else 0.0

    summary = {"ad": {w: stats([r["ad"][w] for r in rows]) for w in rows[0]["ad"]},
               "fd": {s: stats([r["fd"][s] for r in rows]) for s in rows[0]["fd"]}}
    for kind, d in summary.items():
        for k, (m, sd) in d.items():
            print(f"{kind} {k}: mean {m:+.6e}, sd {sd:.3e} over {len(rows)} seeds")
    for w, (ma, _) in summary["ad"].items():
        for s, (mf, _) in summary["fd"].items():
            per = [abs(r["ad"][w] - r["fd"][s]) / abs(r["fd"][s]) for r in rows]
            print(f"soft w {w} vs FD {s} spp: means differ by {abs(ma - mf) / abs(mf):.4f}; "
                  f"per seed within 0.05 on {sum(p < 0.05 for p in per)} of {len(per)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"args": vars(args), "rows": rows, "summary": summary,
                       "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"},
                      f, indent=1)


if __name__ == "__main__":
    main()
