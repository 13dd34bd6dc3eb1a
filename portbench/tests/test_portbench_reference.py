"""Each configuration's plain reference computes what the port's CPU plain
route computes, at a tiny size of the configuration, and its control (the
reference in bfloat16 in the program's place) fails the cell's limits."""

import copy
import io
import json
import os
import types

import pytest
import torch

from portbench_tiny import BENCH_DIR, bench_cells

import harness

SEEDS = [3, 2 ** 31 + 11, 9_876_543_210]


def _ref(name):
    return harness.load_module(os.path.join(BENCH_DIR, "reference", name + ".py"), "ref_" + name)


def _picmus():
    with open(os.path.join(BENCH_DIR, "configs", "picmus-l11.json")) as f:
        return _ref("picmus-l11").tiny_config(json.load(f))


@pytest.mark.parametrize("seed", SEEDS)
def test_cbox_reference_matches_the_port(seed):
    import tpu_rt_torch as tt

    ref = _ref("cbox")
    path = os.path.join(BENCH_DIR, "configs", "cbox", "cbox.xml")
    img = tt.render(tt.load_file(path, res=16), spp=8, seed=seed, device="cpu",
                    spp_per_pass=4, tile_rows=16)
    want, rays = ref.image_pixels(path, seed, 8, 16 * 128, torch.arange(256), "cpu",
                                  overrides={"res": 16})
    assert rays == int(tt.render.last_ray_count)
    err = float((img.reshape(-1, 3).double() - want).abs().max() / want.abs().max())
    assert err < 1e-6
    low, _ = ref.image_pixels(path, seed, 8, 16 * 128, torch.arange(256), "cpu",
                              dtype=torch.bfloat16, overrides={"res": 16})
    assert float((low.double() - want).abs().max() / want.abs().max()) > 1e-2


@pytest.mark.parametrize("seed", SEEDS)
def test_picmus_reference_matches_the_port(seed):
    import tpu_rt_torch as tt

    ref = _ref("picmus-l11")
    cfg = _picmus()
    xb, zb = (-0.004, 0.004), (0.046, 0.054)
    bm, rf, tx = tt.us_render(tt.load_dict(copy.deepcopy(cfg["scene"])), seed=seed,
                              rays_per_pair=4, x_bounds=xb, z_bounds=zb, device="cpu")
    rf_r, tx_r, counts = ref.acquisition(cfg, seed, 4, 8 * 128, "cpu")
    assert rf.abs().max() > 0 and counts["taps"] > 0
    assert float((rf - rf_r).abs().max() / rf_r.abs().max()) < 1e-6
    assert torch.equal(tx, tx_r)
    assert float((bm - ref.bmode(cfg, rf_r, xb, zb, 60.0)).abs().max()) < 1e-4


@pytest.mark.parametrize("wl", bench_cells())
def test_control_fails_the_limits(tiny_bench, wl):
    """The control (the cell's driver's ``Control``: the reference in
    bfloat16 in the program's place) run through the harness's own window
    and comparison comes out not correct on each seed, at a tiny size (on
    the card at the cell's own size: portbench/control.py)."""
    bench_dir, root = tiny_bench
    trf = harness.find_cell(harness.load_bench(root), wl, bench_dir)[2]
    control = harness.driver(trf["kind"], bench_dir).Control
    for seed in SEEDS:
        args = types.SimpleNamespace(workload=wl, seed=seed, seconds=0.1, trace=0)
        r = harness.run(args, "cpu", 0.0, entry_hook=control, out=io.StringIO(),
                        err=io.StringIO(), bench_dir=bench_dir, root=root)
        assert r["attempted"] >= 1
        assert r["correct"] is False, r["checks"]
