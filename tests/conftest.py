import os

import pytest

# Tests run on a virtual 8-device CPU mesh (the "fake cluster" mechanism,
# SURVEY.md §4).  Tests marked `gpu` take the `gpu` fixture and skip there;
# on a machine with an NVIDIA GPU run them with
#   SLB2D_TEST_PLATFORM=gpu python -m pytest tests/test_gpu.py -m gpu
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ.get("SLB2D_TEST_PLATFORM") != "gpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The default JAX device when it is an NVIDIA GPU; skips otherwise.
    Decided when the test runs, never at import."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (default device: {dev.platform})")
    return dev
