"""Test configuration: run the suite on CPU with 8 virtual devices.

Multi-device sharding tests follow SURVEY.md §7 step 8: an 8-device CPU
mesh (xla_force_host_platform_device_count) stands in for several cards.
The platform is set via jax.config (before any backend use), so the suite
runs on the CPU even where JAX would pick a GPU by default.

Tests marked `gpu` need the card: they take the `gpu_device` fixture,
which skips them unless JAX finds a GPU. Run them on the card with
`SCS_GPU_TESTS=1 python -m pytest tests/ -m gpu`.
"""

import os

os.environ.setdefault("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

import jax

if os.environ.get("SCS_GPU_TESTS") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache (the library's one policy): the suite
# compiles hundreds of tiny distinct programs; caching them across runs
# cuts repeat suite time several-fold.
from scs_tpu.settings import ensure_compile_cache  # noqa: E402

ensure_compile_cache()

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: full-depth sweeps and other long runs; excluded from the "
        "default (CI-budget) tier — run with SCS_TPU_SLOW=1 to include",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU (skips without one); run on the card with "
        "SCS_GPU_TESTS=1 python -m pytest tests/ -m gpu",
    )


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX finds none. Decided
    here, at run time, never at import or collection time."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev


def pytest_collection_modifyitems(config, items):
    """Two-tier suite (VERDICT r2 item 7): the default run stays inside a
    ~5-minute single-process budget; SCS_TPU_SLOW=1 runs everything
    (documented in README: `SCS_TPU_SLOW=1 python -m pytest tests/`)."""
    if os.environ.get("SCS_TPU_SLOW") == "1":
        return
    skip = pytest.mark.skip(
        reason="slow tier (set SCS_TPU_SLOW=1 to run the full suite)"
    )
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables after each test module.

    The suite compiles hundreds of distinct XLA CPU programs; with all of
    them kept live in one process, a late shard_map compilation segfaults
    inside XLA (reproducible at tests/test_sharding.py when the FULL suite
    runs in one process, absent when the module runs alone). Bounding the
    live-executable population avoids the crash and caps memory; tests
    recompile transparently."""
    yield
    jax.clear_caches()
    # compiled cores cache jitted callables; drop them with the caches
    from scs_tpu import solver as _solver
    from scs_tpu.ops import projections as _proj

    _solver._CORE_CACHE.clear()
    _proj._PROJECTOR_CACHE.clear()
