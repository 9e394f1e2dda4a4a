"""Shared pytest fixtures.

NOTE: deliberately does NOT set ``--xla_force_host_platform_device_count``:
smoke tests and benchmarks must see the real single CPU device.  The
distributed / dry-run tests that need fake devices spawn subprocesses with
their own XLA_FLAGS (see tests/test_distributed.py, tests/test_dryrun_small.py).
"""
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the repro_torch kernels); "
        "skipped elsewhere, run on the H100 with -m gpu")
