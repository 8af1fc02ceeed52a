"""Persistent JAX compilation cache at a place the caller controls.

A cache hit needs the same directory on every run, so the default is a
fixed path inside the checkout (``<repo>/.jax_cache``, git-ignored),
never one built from a temp name, a pid or the time. When
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set in code.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory. Call before the first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
