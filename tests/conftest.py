"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Mirrors the survey's multi-device test strategy (SURVEY.md §4): sharded
search logic is validated without accelerator hardware by forcing the CPU
backend with 8 logical host devices.

Tests marked ``gpu`` need the card.  A run selected with ``-m gpu`` leaves
the platform to JAX, so it finds the GPU; those tests skip when there is
none.  Every other run is held to the CPU.
"""

import os

import jax
import numpy as np
import pytest

from fastpyvectordb_jax import compile_cache


def pytest_configure(config):
    # runs before any test module is imported and before JAX initializes
    # a backend, so the platform and device count can still be chosen
    if (config.getoption("markexpr") or "").strip() != "gpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        jax.config.update("jax_platforms", "cpu")
    # persistent compilation cache: the suite is dominated by XLA
    # compiles; cache them across runs
    compile_cache.enable()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    # XLA:CPU AOT cache entries embed machine-feature flags that trip
    # noisy loader warnings across hosts; cache only the HLO level
    jax.config.update("jax_persistent_cache_enable_xla_caches", "none")


@pytest.fixture()
def rng():
    # function-scoped: a session-scoped generator's stream depends on
    # which tests ran before, making data-dependent failures
    # irreproducible under -k / reordering
    return np.random.default_rng(42)


@pytest.fixture()
def tmp_db_path(tmp_path):
    return tmp_path / "db"


