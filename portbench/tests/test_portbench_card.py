"""On the card: each cell's command runs for a short window, in both
modes, and prints a result line with the contract's keys, correct.

    python -m pytest portbench/tests/test_portbench_card.py -q

(skips without an NVIDIA GPU)."""

import json
import os
import subprocess
import sys

import pytest

from portbench_tiny import BENCH_DIR, ROOT, bench_cells


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("wl", bench_cells())
def test_cell_runs_on_the_card(card, wl, trace):
    p = subprocess.run([sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload", wl,
                        "--seed", "5000000017", "--seconds", "2", "--trace", str(trace)],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(r)[-1] == "checks" and r["correct"] is True
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    group = b["per_layer"] if trace else b["end_to_end"]
    want = {m["name"] for m in group if wl in m.get("workloads", [wl])}
    assert set(r["metrics"]) == want
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
