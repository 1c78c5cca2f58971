"""Shared set-up of the benchmark harness's tests: a tiny configuration
(tiny_se100.json beside this file) served on the CPU.

    python -m pytest portbench/tests -q

Tests marked `card` run only where torch sees a CUDA card; they decide
that in a fixture, never while the module is imported."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on a card")
