"""Where JAX keeps its persistent compilation cache.

Every entry point (``chip_smoke.py``, ``bench.py``, ``__graft_entry__.py``,
the tests, ``examples/`` and ``scripts/``) calls :func:`enable_compile_cache`
before its first compile, so all of them share one cache.
"""

from __future__ import annotations

import os
from pathlib import Path

# A fixed path: the directory is part of the cache key, so a cache that
# moves is never hit again. Listed in .gitignore.
REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing else is set here. Otherwise the cache goes to
    ``<repo>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)
