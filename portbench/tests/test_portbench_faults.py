"""A run with its timed path broken underneath comes out not correct:
the harness's look for a card skipped, the rest of a run driven on the CPU
at a tiny size, once for each fault the cells can have (a call that
returns its state unchanged; half of the work left out and the mean taken
over the rest; an answer altered where it is produced).  The cells run on
one chip, so no exchange between chips can be left out."""

import io
import types

import pytest

from portbench_tiny import bench_cells

import harness


class Broken:
    """The entry with its ``call`` replaced by ``fault(entry, seed)``."""

    def __init__(self, entry, fault):
        self.entry, self.fault = entry, fault

    def __getattr__(self, name):
        return getattr(self.entry, name)

    def call(self, seed):
        return self.fault(self.entry, seed)


def unchanged(entry, seed):
    """The first call's outputs handed back on every call."""
    if not hasattr(entry, "first"):
        entry.first = entry.call(seed)
    return entry.first


def half(entry, seed):
    """Half the samples or rays (the program divides by what it ran)."""
    t = entry.trf
    if "spp" in t:
        return (entry.tt.render(entry.scene, spp=t["spp"] // 2, seed=seed, device=entry.device,
                                spp_per_pass=t["spp_per_pass"], tile_rows=t["tile_rows"]),)
    old = t["rays_per_pair"]
    t["rays_per_pair"] = old // 2
    try:
        return entry.call(seed)
    finally:
        t["rays_per_pair"] = old


def altered(entry, seed):
    """One answer changed where it is produced: the image's or the RF's
    largest value off by 1%."""
    out = list(entry.call(seed))
    k = 1 if len(out) == 3 else 0  # us_render: (B-mode, RF, tx)
    flat = out[k].view(-1)
    i = int(flat.abs().argmax())
    flat[i] = flat[i] * 1.01
    return tuple(out)


@pytest.mark.parametrize("fault", [unchanged, half, altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("wl", bench_cells())
def test_broken_path_is_not_correct(tiny_bench, wl, fault):
    bench_dir, root = tiny_bench
    args = types.SimpleNamespace(workload=wl, seed=4_000_000_007, seconds=0.3, trace=0)
    r = harness.run(args, "cpu", 0.0, entry_hook=lambda e: Broken(e, fault),
                    out=io.StringIO(), err=io.StringIO(), bench_dir=bench_dir, root=root)
    assert r["attempted"] >= 1
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("wl", bench_cells())
def test_sound_path_is_correct(tiny_bench, wl):
    bench_dir, root = tiny_bench
    args = types.SimpleNamespace(workload=wl, seed=4_000_000_007, seconds=0.3, trace=0)
    r = harness.run(args, "cpu", 0.0, out=io.StringIO(), err=io.StringIO(),
                    bench_dir=bench_dir, root=root)
    assert r["correct"] is True, r["checks"]
