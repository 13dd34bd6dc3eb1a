"""Fixtures of the benchmark's CPU tests: the harness on the path, a copy
of the benchmark cut to tiny sizes, and the card check for the tests that
need one (decided inside a fixture, never at import)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from portbench_tiny import make_tiny  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def tiny_bench(tmp_path):
    return make_tiny(str(tmp_path))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the benchmark's runs measure nothing on the CPU")
