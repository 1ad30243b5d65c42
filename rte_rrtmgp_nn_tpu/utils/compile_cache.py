"""JAX's persistent compilation cache for the entry-point scripts.

``JAX_COMPILATION_CACHE_DIR``, when set, is the cache and nothing else is
configured (JAX reads the variable itself). Otherwise the cache lives in one
fixed directory inside the checkout, ``<checkout>/.jax_cache``: the path is
part of the cache key, so a directory that moved between runs would never
hit.
"""
from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
    ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory (see the
    module docstring) and return that directory."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
