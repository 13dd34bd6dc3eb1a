"""Paths of the benchmark and a copy of it cut to tiny sizes, for its CPU
tests."""

import json
import os
import shutil
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for p in (ROOT, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)

# each traffic kind cut to a size a CPU test holds; the configuration's
# widths (pitch, frequency, sampling) stay as published
TINY_TRAFFIC = {
    "image": dict(spp=8, spp_per_pass=4, overrides={"res": 16}),
    "us_frame": dict(rays_per_pair=4, x_bounds=[-0.004, 0.004], z_bounds=[0.046, 0.054]),
}
TINY_US = dict(angles=[-16.0, 0.0, 16.0], n_elements=16)


def bench_cells():
    """The names of BENCHMARK.json's cells."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


def make_tiny(dst):
    """A copy of BENCHMARK.json and portbench/ under ``dst`` with every
    traffic mix and the ultrasound configuration cut to tiny sizes.
    Returns (bench_dir, root)."""
    bench_dir = os.path.join(dst, "portbench")
    shutil.copytree(BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    tdir = os.path.join(bench_dir, "traffic")
    for name in os.listdir(tdir):
        path = os.path.join(tdir, name)
        with open(path) as f:
            t = json.load(f)
        t.update(TINY_TRAFFIC[t["kind"]])
        with open(path, "w") as f:
            json.dump(t, f)
    cpath = os.path.join(bench_dir, "configs", "picmus-l11.json")
    with open(cpath) as f:
        c = json.load(f)
    c["scene"]["integrator"].update(TINY_US)
    with open(cpath, "w") as f:
        json.dump(c, f)
    return bench_dir, dst
