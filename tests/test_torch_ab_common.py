"""tools/ab_common.py, the A/B tools' shared helpers, on the CPU: a
variant's source directory with its constants set (no GPU, no nvcc); and
tools/ab_film.py's launch of a build by that build's own mode numbers."""

import os
import sys
import types

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))

import ab_common  # noqa: E402

CSRC = os.path.join(ab_common.ROOT, "tpu_rt_torch", "ops", "csrc")


def test_a_plain_variant_is_its_directory(tmp_path):
    assert ab_common.variant_dir("new", CSRC, ("us_acq.cu",), str(tmp_path)) == CSRC
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("const, value, source", [("kMaxTableFloats", "8192", "us_acq.cu"),
                                                   ("kStages", "6", "us_das.cu")])
def test_a_constant_is_set_in_a_copy(tmp_path, const, value, source):
    d = ab_common.variant_dir("v", f"{CSRC}:{const}={value}", ("us_acq.cu", "us_das.cu"),
                              str(tmp_path))
    assert d == os.path.join(str(tmp_path), "v")
    assert sorted(os.listdir(d)) == ["common.cuh", "us_acq.cu", "us_das.cu"]
    with open(os.path.join(d, source)) as f:
        assert f"constexpr int {const} = {value};" in f.read()
    with open(os.path.join(CSRC, source)) as f:
        assert f"constexpr int {const} = {value};" not in f.read()


def test_a_constant_not_found_once_is_refused(tmp_path):
    with pytest.raises(ValueError, match="kNoSuch found 0 times"):
        ab_common.variant_dir("v", f"{CSRC}:kNoSuch=1", ("us_acq.cu",), str(tmp_path))
    # kThreads is in both sources: which one is meant is not clear
    with pytest.raises(ValueError, match="kThreads found 2 times"):
        ab_common.variant_dir("v", f"{CSRC}:kThreads=64", ("us_acq.cu", "us_das.cu"),
                              str(tmp_path))


# an older build's launch modes: K3's trace under a mode of its own, which
# the program lacks, and the others numbered after it
OLD_ENUM = """// launch modes
enum {
  MODE_FILM = 0, MODE_K3_FILM = 1, MODE_STOKES_SAMPLE = 2, MODE_RAYGEN_SAMPLE = 3,
  MODE_RAYS_SAMPLE = 4
};
"""


@pytest.mark.parametrize("build", ["package", "older"])
def test_ab_film_launches_a_build_by_its_own_mode_numbers(build, tmp_path, monkeypatch):
    """tools/ab_film.py reads each build's launch-mode enum from its
    path_film.cu and gives it each program mode by name: the package's
    numbers are path_kernel's ``_MODE_*``.  A build's K3 trace is its K6
    launch, or the one mode of an older build that the program lacks; its
    records are the first 13 planes."""
    import ab_film
    from tpu_rt_torch.ops import path_kernel as pk

    d = CSRC
    if build == "older":
        d = str(tmp_path)
        (tmp_path / "path_film.cu").write_text(OLD_ENUM)
    modes = ab_film.launch_modes(d)
    calls = []

    def launch(t, s, n, mode, n_out, *a, **kw):
        calls.append(mode)
        return torch.zeros((n_out, n, 2))

    monkeypatch.setattr(ab_film, "ORIG_LAUNCH", launch)
    b = ab_film.Build(None, modes)
    for name in ("MODE_FILM", "MODE_STOKES_SAMPLE", "MODE_RAYGEN_SAMPLE", "MODE_RAYS_SAMPLE"):
        b.launch(None, 0, 1, getattr(pk, "_" + name), 4, "test")
    assert b.k3_records(types.SimpleNamespace(n_val=13), 0, 3).shape == (13, 3, 2)
    if build == "package":
        assert modes == {m: getattr(pk, "_" + m) for m in modes}
        assert calls == [0, 1, 2, 3, 1]
    else:
        assert calls == [0, 2, 3, 4, 1]
