"""JAX's persistent compilation cache, in one place.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this module
sets no directory. Otherwise the cache lives in `.jax_cache/` at the root
of the checkout (listed in .gitignore): a fixed path, because the path is
part of the cache key and a moving directory never hits.
"""

from __future__ import annotations

import os

import jax

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_dir() -> str | None:
    """The directory `enable` sets, or None when the environment decides."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(_ROOT, ".jax_cache")


def enable() -> str:
    """Turn the cache on for this process; returns its directory."""
    path = cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path or os.environ["JAX_COMPILATION_CACHE_DIR"]
