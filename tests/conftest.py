"""Test configuration.

Tests run on CPU with 8 virtual devices, so multi-device sharding logic
is exercised without accelerators.  This must run before jax is imported
anywhere.

Tests marked `gpu` check what is compiled for the card (a Pallas kernel
through Triton has no CPU path); here they skip with a reason.
chip_smoke.py runs them on the GPU in its own process, with
AUDIO_SUITE_TEST_DEVICE=gpu so that the process keeps its device.
"""
import os
import sys

import pytest

if os.environ.get("AUDIO_SUITE_TEST_DEVICE") != "gpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax  # noqa: E402
    jax.config.update("jax_platforms", "cpu")
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided at run time, never
    at import, so every test worker collects the same tests)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs the GPU: runs the kernel as compiled for the "
                    "card (chip_smoke.py runs it there)")
