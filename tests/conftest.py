"""Test configuration: run everything on a virtual 8-device CPU mesh.

Must set env BEFORE jax is imported anywhere. This forces the CPU for the
unit-test run. The tests marked ``gpu`` run on the card with
``RZ_TEST_PLATFORM=gpu python -m pytest -m gpu`` (chip_smoke.py runs them
too); that variable leaves the platform alone.
"""
import os

if os.environ.get("RZ_TEST_PLATFORM") != "gpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402
import pytest  # noqa: E402


def cpu_cache_dir() -> str:
    """The CPU suite's persistent compile cache: JAX_COMPILATION_CACHE_DIR
    when set, else .jax_cache_cpu in the checkout."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache_cpu")


if os.environ.get("RZ_TEST_PLATFORM") != "gpu":
    # suite time is dominated by XLA compiles of the integrator/kernel
    # programs, which are identical across runs; thresholds at 0 so even
    # small programs cache. On the card the package places the cache.
    jax.config.update("jax_compilation_cache_dir", cpu_cache_dir())
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_enable_xla_caches", "all")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX's platform is not gpu.
    Decided here, at run time, never while the module is imported."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with RZ_TEST_PLATFORM=gpu "
                    "python -m pytest -m gpu on the card")
    return jax.devices("gpu")[0]
