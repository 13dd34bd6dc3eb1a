"""Paths of the benchmark and a copy of it cut to tiny sizes, for its CPU
tests.  The cuts belong to the benchmark's files: each traffic kind's
driver declares the traffic keys it overrides (``TINY``), and a
configuration that needs a cut declares it in its plain reference
(``tiny_config``), so a new kind or configuration brings its own."""

import json
import os
import shutil
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for p in (ROOT, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402


def bench_cells():
    """The names of BENCHMARK.json's cells."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


def _rewrite(path, cut):
    with open(path) as f:
        d = json.load(f)
    with open(path, "w") as f:
        json.dump(cut(d), f)


def copy_bench(dst, src=ROOT):
    """A copy of ``src``'s BENCHMARK.json and portbench/ (its tests left
    out) under ``dst``.  Returns (bench_dir, root)."""
    bench_dir = os.path.join(dst, "portbench")
    shutil.copytree(os.path.join(src, "portbench"), bench_dir,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(src, "BENCHMARK.json"), dst)
    return bench_dir, dst


def make_tiny(dst, src=ROOT):
    """``copy_bench`` of ``src`` with each cell's traffic mix cut by its
    kind's ``TINY`` and each configuration by its reference's
    ``tiny_config``, where it has one.  Returns (bench_dir, root)."""
    bench_dir, _ = copy_bench(dst, src)
    bench = harness.load_bench(dst)
    for name in sorted({w["traffic"] for w in bench["workloads"]}):
        _rewrite(os.path.join(bench_dir, "traffic", name + ".json"),
                 lambda t: dict(t, **harness.driver(t["kind"], bench_dir).TINY))
    for c in bench["configs"]:
        ref = harness.load_module(os.path.join(bench_dir, "reference", c["name"] + ".py"),
                                  "tiny_reference")
        if hasattr(ref, "tiny_config"):
            _rewrite(os.path.join(bench_dir, "configs", c["name"] + ".json"), ref.tiny_config)
    return bench_dir, dst
