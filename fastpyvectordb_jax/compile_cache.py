"""Where the persistent XLA compile cache lives.

One rule for every entry point (chip_smoke.py, bench.py, prime, the test
suite): if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX's own setting wins
and no other directory is configured; otherwise the cache is the fixed
directory ``.jax_cache`` at the root of the checkout.  The path is part of
the cache's key, so it never depends on a temporary name, a process id or
the time.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def cache_dir() -> str:
    """The compile cache directory this process should use."""
    return os.environ.get(ENV_VAR) or str(DEFAULT_DIR)


def enable(path: str | None = None) -> str:
    """Point JAX's persistent compile cache at ``path`` (default:
    ``cache_dir()``) and return it.  Call before the first compile."""
    import jax
    path = path or cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
