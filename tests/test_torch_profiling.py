"""The port's profiling utilities (``tpu_rt_torch/utils/profiling.py``) and
warm-up (``tpu_rt_torch/warmup.py``) on the CPU: ``RenderStats`` against
tpu_rt's for the same records, ``trace`` writing a Chrome trace,
``measure_device_trace`` refusing a trace without device events (there is
no card here), the warm-up refusing to run without a card and naming only
fixtures that exist, and the launch counters."""

import glob
import json

import pytest
import torch

import tpu_rt_torch
from tpu_rt.utils import profiling as prof_j
from tpu_rt_torch import warmup
from tpu_rt_torch.ops import path_kernel
from tpu_rt_torch.utils import profiling as prof_t

torch.set_num_threads(1)

RECORDS = [("cbox", 123_456_789, 0.0518), ("usmain", 41_495, 0.000958), ("mesh", 7, 1e-13)]


@pytest.mark.parametrize("n", [1, 3])
def test_render_stats_summary_matches_tpu_rt(n):
    s_j, s_t = prof_j.RenderStats(), prof_t.RenderStats()
    for tag, rays, wall in RECORDS[:n]:
        s_j.record(tag, rays, wall_s=wall)
        s_t.record(tag, torch.tensor(rays), wall_s=wall)
    assert s_t.summary() == s_j.summary()
    assert s_t.entries == s_j.entries


def test_trace_writes_a_chrome_trace(tmp_path):
    sc = tpu_rt_torch.load_file(str(warmup.FIXTURES["cbox"]), res=8, spp=1)
    with prof_t.trace(str(tmp_path)):
        tpu_rt_torch.render(sc, device="cpu")
    files = glob.glob(str(tmp_path / "trace.*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        evs = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" for e in evs)


def test_measure_device_trace_needs_device_events(tmp_path):
    with pytest.raises(RuntimeError, match="no device events"):
        prof_t.measure_device_trace(lambda: torch.ones(4).sum(), log_dir=str(tmp_path))


def test_kernel_names_are_the_ports_kernels():
    assert prof_t.kernel_names() == {
        "path_film_kernel", "film_splat_kernel", "stokes_sample_kernel", "path_sample_kernel",
        "us_acq_kernel", "us_das_pack_kernel", "us_das_kernel", "us_das_adjoint_kernel",
        "mesh_direct_kernel", "mesh_isect_kernel"}


def test_launch_counts_reset_and_read():
    path_kernel.film_trace.launches = 3
    path_kernel.stokes_film_trace.regen_launches = 2
    counts = prof_t.launch_counts()
    assert counts["path_film"] == 3 and counts["regen"] == 2
    prof_t.reset_launch_counts()
    assert set(prof_t.launch_counts().values()) == {0}


def test_warmup_needs_a_card_and_names_existing_fixtures():
    assert all(p.is_file() for p in warmup.FIXTURES.values())
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        warmup.main()
