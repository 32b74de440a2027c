"""JAX's persistent compilation cache, kept at one fixed place.

A cold compile of the 512^2 network takes tens of seconds; the cache makes
every later process with the same program skip it. If
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
changed here. Otherwise the cache goes to ``<checkout>/.jax_cache``, a fixed
path (listed in ``.gitignore``): the directory is part of what a cache hit
needs, so it must not move between runs.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache(environ=os.environ) -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    path = environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
