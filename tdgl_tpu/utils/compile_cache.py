"""JAX's persistent compilation cache, kept in one fixed place.

The chunk programs (thousands of fused TDGL steps around a multigrid solve)
take long to compile; with the cache, a later process with the same
configuration and shapes loads them instead. The cache directory is part of
the cache's key, so it must not move between runs:
``JAX_COMPILATION_CACHE_DIR`` when it is set, else ``.jax_cache`` at the
root of the checkout.
"""

from __future__ import annotations

import logging
import os

import jax

logger = logging.getLogger(__name__)

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


def enable() -> None:
    """Point jax's persistent compilation cache at :func:`cache_dir`.

    A directory already configured in jax (by the environment variable or
    by the embedding application) is left as it is.
    """
    if jax.config.jax_compilation_cache_dir:
        return
    path = cache_dir()
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:  # never let cache plumbing break a solve
        logger.debug("Could not create the compilation cache directory %s.",
                     path, exc_info=True)
        return
    jax.config.update("jax_compilation_cache_dir", path)
    # Only the programs that are slow to build are worth a cache entry.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 10.0)
