"""Test harness config.

8 host platform devices (NOT the dry-run's 512 -- that flag stays local to
repro.launch.dryrun): the distributed/sharding tests need a real multi-
device mesh, and 8 keeps single-device smoke tests fast.  Must be set
before the first jax import in the test process.
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

# NOTE: do NOT enable JAX's persistent compilation cache here
# (JAX_COMPILATION_CACHE_DIR): on jax 0.4.x CPU, executables loaded from
# the disk cache were observed to produce slightly different numerics than
# freshly-compiled ones, breaking the exact-resume guarantee asserted by
# tests/test_fault_tolerance.py (cold cache passes, warm cache fails).

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running large-geometry cases, excluded from the tier-1 "
        "run (select with -m slow)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the port's kernels); skips without one")


def pytest_collection_modifyitems(config, items):
    if config.getoption("-m"):
        return  # explicit marker expression wins
    skip_slow = pytest.mark.skip(reason="slow: run with -m slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture(scope="session")
def host_mesh():
    from repro.core.compat import make_mesh
    return make_mesh((4, 2), ("data", "model"))


@pytest.fixture(scope="session")
def mesh82():
    from repro.core.compat import make_mesh
    return make_mesh((2, 4), ("data", "model"))
