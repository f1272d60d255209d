"""Test harness configuration.

Tests run on the CPU with 8 virtual devices (to exercise the multi-device
sharding path without a card) and with x64 available so JAX numerics can
be compared against the float64 oracle at tight tolerances.  Tests that
need the GPU carry the `gpu` marker and skip here through the `gpu`
fixture; `python chip_smoke.py` runs them on the card in its own process
with MPC_TESTS_ON_CARD=1, which leaves the platform and x64 alone.
"""

import os

import pytest

if os.environ.get("MPC_TESTS_ON_CARD") != "1":
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if os.environ.get("MPC_TESTS_ON_CARD") != "1":
    # a pytest plugin may import jax before this file runs, so the
    # platform is set through jax.config (still possible before backend
    # init), not via os.environ alone
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

from mpc_limx_control_tpu.utils import compile_cache  # noqa: E402

# Persistent compilation cache (JAX_COMPILATION_CACHE_DIR, else the
# checkout's .jax_cache): repeat runs skip the large rollout compiles.
compile_cache.enable()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time,
    never at import, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run by `python chip_smoke.py`")
    return jax.devices()[0]
