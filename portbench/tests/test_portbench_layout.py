"""The benchmark's files: every configuration, traffic mix, reference and
per-layer metric found by its name; a new cell, and a new configuration
with a new traffic kind, added by files and entries alone, CPU tests
included; BENCHMARK.json within the contract's limits; no run without a
card."""

import json
import os
import re
import shutil
import subprocess
import sys
import types

import pytest

from portbench_tiny import BENCH_DIR, ROOT, copy_bench, make_tiny
from test_portbench_faults import Broken, altered, half, unchanged

import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("wl", [w["name"] for w in bench()["workloads"]])
def test_cell_found_by_name(wl):
    w, cfg, trf, ref = harness.find_cell(bench(), wl)
    drv = harness.driver(trf["kind"])
    assert w["name"] == wl and callable(drv.Entry) and callable(drv.Control)
    assert set(trf["limits"]) and set(trf["metrics"]) <= {m["name"] for m in bench()["end_to_end"]}
    assert hasattr(ref, "image_pixels") or hasattr(ref, "acquisition")


@pytest.mark.parametrize("metric", [m["name"] for m in bench()["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.metric_reader(metric).read)


def test_names_units_and_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["source"]) <= 200 and all(NAME.match(k) for k in c["reduced"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                          "workloads"}
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    assert 1 <= b["run_seconds"] <= 51 and b["paths"] == ["portbench"]
    assert len(json.dumps(b)) <= 64 * 1024


def _snapshot(bench_dir):
    """Every file of the benchmark's copy and its bytes."""
    out = {}
    for d, _, files in os.walk(bench_dir):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.join(d, f)] = fh.read()
    return out


def _add_cell(bench_dir, root, name, traffic, t):
    """A traffic file and a BENCHMARK.json entry of a cbox cell, listed
    where the cbox cell is."""
    with open(os.path.join(bench_dir, "traffic", traffic + ".json"), "w") as f:
        json.dump(t, f)
    b = bench()
    b["workloads"].append({"name": name, "config": "cbox", "traffic": traffic,
                           "chips": 1, "why": "a cell added by data alone"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "cbox.512.spp256" in m.get("workloads", []):
            m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    args = types.SimpleNamespace(workload=name, seed=2 ** 31 + 5, seconds=0.2, trace=0)
    out = open(os.devnull, "w")
    return harness.run(args, "cpu", 0.0, out=out, err=out, bench_dir=bench_dir, root=root)


def test_new_workload_needs_no_edit(tmp_path):
    """A traffic file and a BENCHMARK.json entry make a new cell: it is
    found, set up and checked with no file of the harness changed."""
    bench_dir, root = make_tiny(str(tmp_path))
    before = _snapshot(bench_dir)
    with open(os.path.join(bench_dir, "traffic", "spp256.json")) as f:
        t = json.load(f)
    t.update(spp=4, spp_per_pass=2)
    r = _add_cell(bench_dir, root, "cbox.16.spp4", "spp4", t)
    assert r["correct"] and r["attempted"] >= 1
    assert set(r["metrics"]) == {"image_ms", "image_p95_ms", "setup_s"}
    after = _snapshot(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before


def test_new_kind_is_a_file(tmp_path):
    """A new entry point is a driver file, drivers/<kind>.py, that a
    traffic file names: found by the harness with no file changed."""
    bench_dir, root = make_tiny(str(tmp_path))
    before = _snapshot(bench_dir)
    shutil.copy(os.path.join(bench_dir, "drivers", "image.py"),
                os.path.join(bench_dir, "drivers", "image_twin.py"))
    with open(os.path.join(bench_dir, "traffic", "spp256.json")) as f:
        t = json.load(f)
    t.update(kind="image_twin", spp=4, spp_per_pass=4)
    r = _add_cell(bench_dir, root, "cbox.16.twin", "twin", t)
    assert r["correct"] and r["attempted"] >= 1
    after = _snapshot(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before


def test_tiny_cuts_come_from_the_benchmarks_files(tmp_path):
    """``make_tiny`` cuts each cell's traffic by its kind's ``TINY`` and
    each configuration by its reference's ``tiny_config``, and nothing
    else."""
    bench_dir, root = make_tiny(str(tmp_path))
    b = bench()

    def load(d, sub, name):
        with open(os.path.join(d, sub, name + ".json")) as f:
            return json.load(f)

    for w in b["workloads"]:
        t = load(BENCH_DIR, "traffic", w["traffic"])
        assert load(bench_dir, "traffic", w["traffic"]) == dict(t, **harness.driver(t["kind"]).TINY)
    for c in b["configs"]:
        ref = harness.load_module(os.path.join(BENCH_DIR, "reference", c["name"] + ".py"), "r")
        cfg = load(BENCH_DIR, "configs", c["name"])
        want = ref.tiny_config(cfg) if hasattr(ref, "tiny_config") else cfg
        assert load(bench_dir, "configs", c["name"]) == want


# a traffic kind that no file of the benchmark names: the image driver's
# call with its image as (H, W, 1, 3), its own check of that shape, its
# own control and its own CPU size
LAYERS_DRIVER = '''"""Traffic kind ``image_layers``: an image as (H, W, 1, 3)."""

import os

import torch

import harness
import yardstick

image = harness.driver("image", os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = dict(spp=4, spp_per_pass=2, overrides={"res": 8})


class Entry(image.Entry):
    def call(self, seed):
        return (super().call(seed)[0][:, :, None, :],)

    def check(self, kept, seed):
        worst = 0.0
        for _, s, (img,) in kept:
            got = img.reshape(-1, 1, 3)[:, 0].to(torch.float64)
            worst = max(worst, yardstick.rel_max(got, self.reference(s)))
        return {"image_err": worst}


class Control(image.Control):
    def call(self, seed):
        return (super().call(seed)[0][:, :, None, :],)
'''


def _add_config_and_kind(bench_dir, root):
    """A configuration that no file names (cbox's JSON, scene and reference
    under a new name), the ``image_layers`` kind, its traffic file and the
    BENCHMARK.json entries of their cell, by new files and entries alone."""
    cdir, rdir = os.path.join(bench_dir, "configs"), os.path.join(bench_dir, "reference")
    shutil.copytree(os.path.join(cdir, "cbox"), os.path.join(cdir, "cbox_twin"))
    with open(os.path.join(cdir, "cbox.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(cdir, "cbox_twin.json"), "w") as f:
        json.dump(dict(cfg, name="cbox_twin", scene="cbox_twin/cbox.xml"), f)
    shutil.copy(os.path.join(rdir, "cbox.py"), os.path.join(rdir, "cbox_twin.py"))
    with open(os.path.join(bench_dir, "drivers", "image_layers.py"), "w") as f:
        f.write(LAYERS_DRIVER)
    with open(os.path.join(bench_dir, "traffic", "spp256.json")) as f:
        t = json.load(f)
    with open(os.path.join(bench_dir, "traffic", "layers.json"), "w") as f:
        json.dump(dict(t, kind="image_layers"), f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({"name": "cbox_twin", "source": "a copy of cbox",
                         "file": "portbench/configs/cbox_twin.json", "reduced": [],
                         "why": "a configuration added by files alone"})
    b["workloads"].append({"name": "cbox_twin.layers", "config": "cbox_twin",
                           "traffic": "layers", "chips": 1, "why": "a kind added by files alone"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "cbox.512.spp256" in m.get("workloads", []):
            m["workloads"].append("cbox_twin.layers")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)


def test_new_config_and_kind_need_no_edit(tmp_path):
    """A new configuration and a new traffic kind, added to a copy of the
    benchmark by files and entries alone, are cut by ``make_tiny`` from
    their own files, and their cell behaves as cbox's does: the sound path
    correct, the bfloat16 control and each fault not correct."""
    src_dir, src = copy_bench(str(tmp_path / "src"))
    before = _snapshot(src_dir)
    _add_config_and_kind(src_dir, src)
    after = _snapshot(src_dir)
    assert {k: v for k, v in after.items() if k in before} == before
    bench_dir, root = make_tiny(str(tmp_path / "tiny"), src)
    with open(os.path.join(bench_dir, "traffic", "layers.json")) as f:
        t = json.load(f)
    assert (t["spp"], t["spp_per_pass"], t["overrides"]) == (4, 2, {"res": 8})

    def run(hook=None):
        args = types.SimpleNamespace(workload="cbox_twin.layers", seed=2 ** 31 + 7, seconds=0.2,
                                     trace=0)
        out = open(os.devnull, "w")
        return harness.run(args, "cpu", 0.0, entry_hook=hook, out=out, err=out,
                           bench_dir=bench_dir, root=root)

    r = run()
    assert r["correct"] and r["attempted"] >= 1
    assert set(r["metrics"]) == {"image_ms", "image_p95_ms", "setup_s"}
    assert run(harness.driver("image_layers", bench_dir).Control)["correct"] is False
    for fault in (unchanged, half, altered):
        assert run(lambda e: Broken(e, fault))["correct"] is False, fault.__name__


def test_no_card_no_result():
    """Without a CUDA device the run exits non-zero and prints no result:
    it never falls back to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload",
                        "cbox.512.spp256", "--seed", "12345678901", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA device" in p.stderr
