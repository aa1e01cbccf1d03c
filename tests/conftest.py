"""Test environment: the CPU backend with 8 virtual devices, so the sharded
engines' meshes are exercised without accelerators (SURVEY.md §4).

Tests that need a GPU carry the `gpu` marker and request the `gpu_device`
fixture, which skips them when no GPU is visible.  Whether a GPU is present
is decided inside that fixture, never at import or collection time, so
every test worker collects the same tests.  Run them on a GPU host with
`JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`; the whole GPU path is
driven by `python chip_smoke.py`.
"""

import os

if os.environ.get("JAX_PLATFORMS", "") in ("", "cpu"):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import pytest  # noqa: E402

from gridmap_slam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (skipped where JAX sees none)")


@pytest.fixture
def gpu_device():
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a GPU; JAX sees only "
                    f"{devices[0].platform} devices")
    return devices[0]
