"""tools/ab_common.py, the A/B tools' shared helpers, on the CPU: a
variant's source directory with its constants set (no GPU, no nvcc)."""

import os
import sys

import pytest

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
