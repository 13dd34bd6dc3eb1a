"""Readings that set a cell's limits, on the chip at the cell's own size.

    python3 portbench/control.py --workload <name> --seeds 12 --control-seeds 3 --seconds 1

Each reading is one run of the cell through the harness (``harness.run``:
the cell's set-up, a window of ``--seconds`` at its own load, the check of
a call drawn from the window), all in one process: ``--seeds`` runs of the
program (the lower readings, what sound runs read) and ``--control-seeds``
runs with the control in the program's place (the cell's driver's
``Control``, the plain reference computed in bfloat16: the upper
readings).  Prints each run's compared numbers and ``correct``, then one
JSON summary; exits non-zero unless every program run is correct and
every control run is not.  The benchmark's own runs do not run this.
"""

import argparse
import io
import json
import os
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--first-seed", type=int, default=7_000_000_001)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, HERE)
    import torch

    import harness

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trf = harness.find_cell(harness.load_bench(), args.workload)[2]
    control = harness.driver(trf["kind"]).Control

    def one(seed, hook):
        a = types.SimpleNamespace(workload=args.workload, seed=seed, seconds=args.seconds,
                                  trace=0)
        r = harness.run(a, "cuda", time.perf_counter(), entry_hook=hook, out=io.StringIO(),
                        err=io.StringIO())
        return r["correct"], {k: c["value"] for k, c in r["checks"].items()}, r["attempted"]

    lower, upper, ok = [], [], True
    for who, n, seed0, hook, out in (("program", args.seeds, args.first_seed, None, lower),
                                     ("control", args.control_seeds, args.first_seed + 10 ** 6,
                                      control, upper)):
        for k in range(n):
            t0 = time.perf_counter()
            correct, v, calls = one(seed0 + k, hook)
            ok &= correct if hook is None else not correct
            out.append(v)
            print(f"{who} seed {seed0 + k}: correct={correct} {v} ({calls} calls, "
                  f"{time.perf_counter() - t0:.1f} s)", flush=True)
    names = list((lower or upper)[0])
    summary = {n: {"lower": max(v[n] for v in lower) if lower else None,
                   "upper": min(v[n] for v in upper) if upper else None} for n in names}
    print(json.dumps({"workload": args.workload, "readings": summary,
                      "program_correct_and_control_not": ok,
                      "device": torch.cuda.get_device_name(0)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
