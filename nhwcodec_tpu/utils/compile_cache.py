"""Persistent XLA compilation cache location.

The device programs (entropy chain extraction, the chunked fixpoints,
the device scans) take from seconds to minutes to compile; cached they
load in milliseconds.  The cache directory is part of the cache's key,
so it must not move between runs:

- ``JAX_COMPILATION_CACHE_DIR`` set: that directory, and no other;
- unset: the fixed ``<checkout>/.jax_cache``.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent.parent


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        CHECKOUT / ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``cache_dir()`` and
    cache every program that takes a second or more to compile.
    Returns the directory."""
    import jax

    d = cache_dir()
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
    return d
