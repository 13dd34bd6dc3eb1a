"""The port's profiling utilities (``tpu_rt_torch/utils/profiling.py``) and
warm-up (``tpu_rt_torch/warmup.py``) on the CPU: the named spans of
``render`` (its film and Stokes routes) and ``us_render`` in a Chrome
trace, nested in the call and counted a stage each, and no
``record_function`` when no profiler records;
``trace`` writing a Chrome trace, ``measure_device_trace`` refusing a
trace without device events (there is no card here), the warm-up refusing
to run without a card and naming only fixtures that exist, and the launch
counters."""

import collections
import glob
import json
import sys
from pathlib import Path

import pytest
import torch

import tpu_rt_torch
from tpu_rt_torch import warmup
from tpu_rt_torch.ops import path_kernel
from tpu_rt_torch.utils import profiling as prof_t

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_port_scenes import usmain_desc  # noqa: E402

torch.set_num_threads(1)

US_KW = dict(rays_per_pair=1, x_bounds=(-0.001, 0.001), z_bounds=(0.049, 0.051))
US_SPANS = ["tpu_rt_torch.simulate_acquisition", "tpu_rt_torch.das_beamform",
            "tpu_rt_torch.hilbert_envelope", "tpu_rt_torch.log_compress"]


def _spans(tmp_path, fn):
    """The port's spans (name, start, end, thread) in the Chrome trace of
    ``fn()`` under ``profiling.trace``, in order of start, an enclosing
    span before the spans it holds."""
    with prof_t.trace(str(tmp_path)):
        fn()
    (path,) = glob.glob(str(tmp_path / "trace.*.json"))
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"])
             for e in evs if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("tpu_rt_torch.")]
    return sorted(spans, key=lambda s: (s[1], -s[2]))


def _inside(child, parent):
    """``child`` lies in ``parent``'s interval, on its thread (the trace's
    times are microseconds to the nanosecond)."""
    return (child[3] == parent[3] and child[1] >= parent[1] - 1e-3
            and child[2] <= parent[2] + 1e-3)


def _usmain():
    return tpu_rt_torch.load_dict(usmain_desc(tpu_rt_torch.ScalarTransform4f))


def test_cbox_render_spans(tmp_path):
    """The film route's stages, once a call or once a chunk of
    ``spp_per_pass`` samples, each inside ``render``'s span."""
    sc = tpu_rt_torch.load_file(str(warmup.FIXTURES["cbox"]), res=8, spp=8)
    spans = _spans(tmp_path, lambda: tpu_rt_torch.render(sc, device="cpu", spp_per_pass=4,
                                                         tile_rows=8))
    counts = collections.Counter(s[0] for s in spans)
    assert counts == {"tpu_rt_torch.render": 1, "tpu_rt_torch.bake_scene": 1,
                      "tpu_rt_torch.pack_tables": 1, "tpu_rt_torch.film_trace": 2,
                      "tpu_rt_torch.deposit": 2, "tpu_rt_torch.develop": 1}
    (outer,) = [s for s in spans if s[0] == "tpu_rt_torch.render"]
    assert all(_inside(s, outer) for s in spans)


def test_stokes_render_spans(tmp_path):
    """The Stokes film route: ``render_stokes`` once a call inside
    ``render``'s span, its stages inside it, ``stokes_film_trace`` once a
    chunk of ``spp_per_pass`` samples; the image the one rendered with no
    profiler."""
    sc = tpu_rt_torch.load_file(str(warmup.FIXTURES["cbox_pol"]), res=16, spp=8)

    def run():
        return tpu_rt_torch.render(sc, device="cpu", spp_per_pass=4, tile_rows=16)

    want = run()
    got = []
    spans = _spans(tmp_path, lambda: got.append(run()))
    counts = collections.Counter(s[0] for s in spans)
    assert counts == {"tpu_rt_torch.render": 1, "tpu_rt_torch.render_stokes": 1,
                      "tpu_rt_torch.bake_scene": 1, "tpu_rt_torch.pack_tables": 1,
                      "tpu_rt_torch.stokes_film_trace": 2, "tpu_rt_torch.deposit": 2,
                      "tpu_rt_torch.develop": 1}
    (outer,) = [s for s in spans if s[0] == "tpu_rt_torch.render"]
    (stokes,) = [s for s in spans if s[0] == "tpu_rt_torch.render_stokes"]
    assert _inside(stokes, outer)
    assert all(_inside(s, stokes) for s in spans if s not in (outer, stokes))
    assert got[0].shape == (16, 16, 4, 3) and torch.equal(got[0], want)


def test_us_render_spans(tmp_path):
    """The acquisition, the DAS, the envelope and the log compression,
    once a frame, in that order, each inside ``us_render``'s span."""
    us = _usmain()
    spans = _spans(tmp_path, lambda: tpu_rt_torch.us_render(us, device="cpu", **US_KW))
    assert [s[0] for s in spans] == ["tpu_rt_torch.us_render"] + US_SPANS
    assert all(_inside(s, spans[0]) for s in spans[1:])
    assert all(a[2] <= b[1] + 1e-3 for a, b in zip(spans[1:], spans[2:]))


def test_render_of_an_ultrasound_scene_nests_us_render(tmp_path):
    us = _usmain()
    spans = _spans(tmp_path, lambda: tpu_rt_torch.render(us, device="cpu", **US_KW))
    assert [s[0] for s in spans] == ["tpu_rt_torch.render", "tpu_rt_torch.us_render"] + US_SPANS
    assert all(_inside(s, spans[0]) for s in spans[1:])
    assert all(_inside(s, spans[1]) for s in spans[2:])


def _no_record_function(*args, **kwargs):
    raise AssertionError("record_function called with no profiler recording")


def test_span_off_is_one_shared_null_context(monkeypatch):
    monkeypatch.setattr(prof_t, "record_function", _no_record_function)
    assert not torch.autograd._profiler_enabled()
    a, b = prof_t.span("tpu_rt_torch.a"), prof_t.span("tpu_rt_torch.b")
    assert a is b
    with a:
        with b:
            pass


@pytest.mark.parametrize("kind", ["cbox", "usmain"])
def test_no_record_function_on_the_path_when_off(monkeypatch, kind):
    """Every span of a call is the null context when no profiler records."""
    monkeypatch.setattr(prof_t, "record_function", _no_record_function)
    if kind == "cbox":
        sc = tpu_rt_torch.load_file(str(warmup.FIXTURES["cbox"]), res=8, spp=2)
        img = tpu_rt_torch.render(sc, device="cpu", spp_per_pass=1, tile_rows=8)
    else:
        img = tpu_rt_torch.render(_usmain(), device="cpu", **US_KW)
    assert torch.isfinite(img).all()


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
    path_kernel.film_trace.regen_launches = 1
    path_kernel.stokes_sample_trace.launches = 2
    counts = prof_t.launch_counts()
    assert counts["path_film"] == 3 and counts["regen"] == 1 and counts["stokes_sample"] == 2
    assert "stokes_film" not in counts  # K3's trace launches count as K6's, one kernel
    prof_t.reset_launch_counts()
    assert set(prof_t.launch_counts().values()) == {0}


def test_warmup_needs_a_card_and_names_existing_fixtures():
    assert all(p.is_file() for p in warmup.FIXTURES.values())
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        warmup.main()
