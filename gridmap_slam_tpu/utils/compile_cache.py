"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (CLI, bench.py, chip_smoke.py, the tests):
when `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and nothing
here overrides it; otherwise the cache goes to `<repo>/.jax_cache`, a fixed
path (the path is part of the cache key, so a moving directory never hits)
that `.gitignore` lists.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> str:
    """The cache directory the process should use."""
    return os.environ.get(ENV_VAR) or str(DEFAULT_DIR)


def enable_compile_cache() -> str:
    """Point JAX at `compile_cache_dir()` and return it.  Sets JAX's option
    only when the environment variable is unset."""
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path
