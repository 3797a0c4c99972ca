"""Persistent compilation cache location, shared by every entry point.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing here overrides it.  Otherwise the cache lives at a fixed path
inside the checkout (``.jax_cache/``, git-ignored): the cache key
includes nothing about the directory, so a fixed path is what lets one
run find what an earlier run compiled.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory.  Call before the first compile."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
