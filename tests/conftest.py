"""Test configuration: run on the CPU with an 8-device virtual mesh.

Sharding and collective paths are validated on virtual CPU devices; the
same paths run on GPUs through ``python chip_smoke.py`` (``--mesh 4`` for
four cards).  The platform and device count must be fixed before JAX
initializes a backend, so they are set here, at conftest import.

Tests that need a GPU carry the ``gpu`` marker and decide in a fixture
(``gpu_device``), never at import time, whether a card is present; on a
host without one they skip with a reason.
"""

import os
import re

os.environ["JAX_PLATFORMS"] = "cpu"
# The CLI turns on JAX's persistent compilation cache (utils/cache.py); the
# test workers keep theirs off so they never share cache files.
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" in flags:
    # REPLACE a pre-existing count (e.g. =1 left over from a debug shell):
    # keeping it would shrink the virtual mesh and let every sharding test
    # pass trivially with zero multi-device coverage.
    flags = re.sub(
        r"--xla_force_host_platform_device_count=\d+",
        "--xla_force_host_platform_device_count=8",
        flags,
    )
    os.environ["XLA_FLAGS"] = flags
else:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-minute gates (pod-scale compile subprocesses)"
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skips on a host without one (run on the "
        "card through chip_smoke.py)",
    )


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when the process has none.  Decided here,
    at test time, never while a test module is imported."""
    import jax

    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("no GPU in this process (JAX_PLATFORMS=cpu)")
    return gpus[0]
