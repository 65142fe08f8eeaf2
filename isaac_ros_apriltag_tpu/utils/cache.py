"""JAX persistent compilation cache: one location for every entry point.

If `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing is
set here. Otherwise the cache lives at a fixed directory of the checkout
(`.jax_cache/`, listed in .gitignore): the path is part of the cache key,
so a fixed path is what lets a later process hit it.
"""

from __future__ import annotations

import os

import jax

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its one location and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
