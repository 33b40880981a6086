"""JAX's persistent compile cache, set up in one place.

The CLI, bench.py, chip_smoke.py and the tools call `enable()` before
their first compile.  The cache lives where JAX_COMPILATION_CACHE_DIR
says when that is set, and in <repo>/.jax_cache (gitignored) otherwise;
no other path is set in code.
"""
from __future__ import annotations

import os

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable() -> str:
    """Point JAX's persistent compile cache at its directory and cache
    every compile that takes a second or more.  Returns the directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
