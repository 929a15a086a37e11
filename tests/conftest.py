"""Test configuration.

The reference runs GoogleTest per-op executables via ctest
(cmake/gtest.cmake:15-19).  Here: pytest on the CPU backend with 8 virtual
devices (``--xla_force_host_platform_device_count=8``) so the distributed
layer is exercised without a cluster — the fake-backend mechanism SURVEY §4
calls for.  The Triton kernel runs in interpret mode on the CPU through an
explicit ``interpret=True``.  x64 is enabled so float64/int64 oracle tests
run natively.

Tests that need the card carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them when JAX finds no GPU.  On a machine with one:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped when JAX finds none"
    )


@pytest.fixture
def gpu():
    """Device 0 when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            f"needs a GPU (JAX platform here: {dev.platform}); run "
            "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/ on one"
        )
    return dev


@pytest.fixture
def rng():
    import numpy as np

    return np.random.default_rng(0)
