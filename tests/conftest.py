"""Test harness: JAX on the CPU with 8 virtual devices, so the
multi-device sharding paths compile and run without a GPU.

Tests that need the GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them when JAX finds no GPU; they are run on the card
with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

from nanomod import use_compile_cache  # noqa: E402

use_compile_cache()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none.  Decided
    here, at run time, never while a test module is imported."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (JAX finds none)")
