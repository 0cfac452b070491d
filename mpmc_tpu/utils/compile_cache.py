"""JAX's persistent compilation cache for the accelerator entry points.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module changes nothing.  Otherwise the cache lives at a fixed path,
``<repo>/.jax_cache`` (listed in .gitignore): the path is part of the
cache key, so a directory that moves between runs never hits.  CPU runs
(the test tier, ``--cpu``) are left uncached.
"""
from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable() -> str | None:
    """Point JAX at the cache directory; returns it (None on CPU)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    platforms = (jax.config.jax_platforms
                 or os.environ.get("JAX_PLATFORMS", ""))
    if platforms.strip().lower() == "cpu":
        return None
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
