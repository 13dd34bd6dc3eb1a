"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU.  Sets up the
cell named in BENCHMARK.json (its configuration, traffic mix, plain
reference and per-layer metric readers, each found by name under
portbench/), runs the timed path in a closed loop for ``--seconds``,
checks what it produced against the plain reference, and prints one JSON
line: the end-to-end metrics with ``--trace 0``, the per-layer metrics
read from a device trace with ``--trace 1``.  Exits non-zero, with no
result, without a CUDA device, or if JAX or the JAX package was loaded.
"""

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    # the program's kernel caches live at fixed paths inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    sys.path.insert(0, ROOT)
    sys.path.insert(0, HERE)
    import torch

    import harness

    chips = next((w["chips"] for w in harness.load_bench()["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = harness.run(args, "cuda", T_PROC0)
    return 0 if result is not None else 3


if __name__ == "__main__":
    sys.exit(main())
