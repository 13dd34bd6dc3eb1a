"""The ``cbox_pol`` configuration on the CPU at 16 x 16 and 8 samples a
pixel: its plain reference computes what the port's Stokes route computes
(both figures of the check at round-off, the same rays, polarization
seen), its bfloat16 control fails the cell's limits, the traffic kind's
check of blocks of pixels adds up to one block's, and the
``stokes_film.roofline`` reader's work by hand."""

import json
import os
import types

import pytest
import torch

from portbench_tiny import BENCH_DIR

import harness
import yardstick

SEEDS = [3, 2 ** 31 + 11, 9_876_543_210]
PATH = os.path.join(BENCH_DIR, "configs", "cbox_pol", "cbox_pol.xml")
RES, SPP = 16, 8


def _ref():
    return harness.load_module(os.path.join(BENCH_DIR, "reference", "cbox_pol.py"),
                               "ref_cbox_pol")


def _limits():
    with open(os.path.join(BENCH_DIR, "traffic", "stokes.spp512.json")) as f:
        return json.load(f)["limits"]


def _errs(got, want):
    """(image_err, pol_err) of [N, 4, 3] Stokes values."""
    got = got.reshape(-1, 4, 3).to(torch.float64)
    return (yardstick.rel_max(got[:, 0], want[:, 0]), yardstick.rel_max(got[:, 1:], want[:, 1:]))


def _reference(ref, seed, dtype=torch.float32):
    return ref.image_pixels(PATH, seed, SPP, 16 * 128, torch.arange(RES * RES), "cpu",
                            dtype=dtype, overrides={"res": RES})


@pytest.mark.parametrize("seed", SEEDS)
def test_cbox_pol_reference_matches_the_port(seed):
    import tpu_rt_torch as tt

    ref = _ref()
    img = tt.render(tt.load_file(PATH, res=RES), spp=SPP, seed=seed, device="cpu",
                    spp_per_pass=4, tile_rows=16)
    assert img.shape == (RES, RES, 4, 3)
    want, counts = _reference(ref, seed)
    assert counts["closest"] + counts["any"] == int(tt.render.last_ray_count)
    assert counts["closest"] >= RES * RES * SPP and counts["mueller"] > 0
    assert want[:, 1:].abs().max() > 0
    image_err, pol_err = _errs(img, want)
    assert image_err < 1e-6 and pol_err < 1e-6
    low, _ = _reference(ref, seed, torch.bfloat16)
    limits = _limits()
    for err, name in zip(_errs(low, want), ("image_err", "pol_err")):
        assert err > 1e-2 and err > limits[name], name


def test_blocks_of_pixels_add_up(tiny_bench):
    """The traffic kind's reference in blocks of pixels gives one block's image
    and counts."""
    bench_dir, root = tiny_bench
    wl, cfg, trf, ref = harness.find_cell(harness.load_bench(root), "cbox_pol.256.spp512",
                                          bench_dir)
    entry = harness.driver(trf["kind"], bench_dir).Entry(cfg, trf, ref, "cpu")
    whole = entry.reference(SEEDS[1])
    counts = entry.counts
    entry.block = 100
    parts = entry.reference(SEEDS[1])
    assert torch.equal(parts, whole) and entry.counts == counts
    assert entry.shapes["n_val"] == 13 and entry.shapes["launches"] == 2


def _ctx(counts, device_s, shapes):
    return types.SimpleNamespace(shapes=shapes, counts=counts, calls=2,
                                 layer_s=lambda sources: device_s * 2)


def test_stokes_film_roofline_by_hand():
    read = harness.metric_reader("stokes_film.roofline").read
    shapes = dict(W=4, H=2, spp=3, n_prims=5, radius=2, launches=1, n_val=13)
    assert read(_ctx({}, 1.0, shapes)) is None
    assert read(_ctx(dict(closest=30, any=7, mueller=11), 0.0, shapes)) is None
    counts = dict(closest=8 * 3 + 6, any=7, mueller=11)
    # 8 pixels x 3 samples: primaries against 5 prims, the gaussian splat
    # of 12 values and a weight over 25 offsets; 6 more closest-hit and 7
    # shadow sweeps; 11 Mueller events
    per_sample = 25 * (2 * 12 + 3) + 2 * 5 * yardstick.OPS_W1D + 1
    ops = 24 * 5 * 20 + 24 * per_sample + 13 * 5 * 20 + 11 * (46 + 3 * 72)
    nbytes = 4 * (20 * 5 + (25 * 13 + 1) * 8)
    want = 100.0 * max(ops / yardstick.PEAK_FP32, nbytes / yardstick.PEAK_BYTES) / 1e-6
    assert read(_ctx(counts, 1e-6, shapes)) == pytest.approx(want, rel=1e-12)
