"""Persistent JAX compilation cache at a fixed path.

A cold process compiles every receive graph again; the persistent cache
lets the next process on the same machine skip that.  The cache key
includes the directory, so the path must never move between runs: it
is either what ``JAX_COMPILATION_CACHE_DIR`` names (JAX reads that
variable itself, and nothing is set here) or ``<checkout>/.jax_cache``.
"""

from __future__ import annotations

import os

__all__ = ["enable_compile_cache", "CACHE_DIR_ENV"]

CACHE_DIR_ENV = "JAX_COMPILATION_CACHE_DIR"
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache(checkout: str | None = None) -> str:
    """Point JAX's persistent compile cache at its fixed directory.

    Call before the first compilation.  Returns the directory in use.
    """
    env = os.environ.get(CACHE_DIR_ENV)
    if env:
        return env
    import jax

    path = os.path.join(checkout or _CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
