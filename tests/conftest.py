"""Test configuration: the suite runs on the CPU backend with 8 virtual
devices, so the multi-device sharding paths are exercised without an
accelerator (``JAX_PLATFORMS=cpu python -m pytest tests/``; the
variable is also forced here, before any backend initialization).
What only a GPU can show is checked by ``python chip_smoke.py`` on the
card."""

import os

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _lean_executable_state():
    """Drop live executables between test modules.

    XLA:CPU segfaults sporadically in executable-heavy long processes —
    4/4 full-suite runs died inside compile or AOT-deserialize during
    test_miehe_tension_adaptive_full (2026-08-17), while the same test
    passes in a lean process (alone, or in a 6-file subset).  Clearing
    the in-process executable caches per module keeps the process lean;
    the on-disk persistent cache makes the re-JITs cheap."""
    yield
    jax.clear_caches()
