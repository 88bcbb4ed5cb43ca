"""Test configuration: force CPU with an 8-device virtual mesh so sharding
logic is testable without TPU hardware, and keep the oracle importable."""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Free jitted executables between test modules.  The suite compiles
    dozens of large fused-step variants; keeping them all alive crashed
    XLA's CPU compiler late in the run (round-2 full-suite SIGSEGV)."""
    yield
    import schroedinger_tpu

    schroedinger_tpu.clear_compiled_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips where there is none)")
    config.addinivalue_line(
        "markers", "slow: long-running; the tier-1 run deselects it")
