"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Tests validate numerics and multi-device sharding on the CPU; tests marked
``gpu`` need the card and skip elsewhere (the ``gpu`` fixture decides, at
run time).  Flags must be set before the first ``import jax`` anywhere in
the test process.
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from video_stabilization.utils.timing import enable_compile_cache  # noqa: E402

# Persistent compilation cache at JAX_COMPILATION_CACHE_DIR or
# <repo>/.jax_cache.  On the CPU backend it is READ-ONLY: PJRT:CPU's
# executable.serialize() CHECK-aborts the whole process for some
# engine-step programs, so the suite never writes an executable.
enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX sees no GPU."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU (run with `pytest -m gpu` on the card)")
    return devices[0]
