"""Test harness configuration.

The suite runs on the CPU backend with a virtual 8-device mesh, so the
sharding tests exercise multi-device semantics without accelerators. Set
``JAX_PLATFORMS`` before pytest starts to run on another backend: tests
marked ``gpu`` run only where JAX's first device is a GPU, e.g.

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu

Whether a GPU is present is decided inside the ``gpu`` fixture, never at
import or collection time, so every xdist worker collects the same tests.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# the repo root, for `tools` (the numpy references and benchmark configs)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def gpu(request):
    """Skip a ``gpu``-marked test unless JAX's first device is a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return None
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev


@pytest.fixture()
def rng():
    # function-scoped on purpose: a shared (session-scoped) Generator makes
    # every test's data depend on which tests ran before it, so adding a
    # test anywhere silently changes unrelated tests' fixtures
    return np.random.default_rng(1234)


@pytest.fixture(scope="session", params=["float32", "complex64"])
def dtype(request):
    return np.dtype(request.param)
