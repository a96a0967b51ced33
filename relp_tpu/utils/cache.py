"""Persistent XLA compilation cache.

Compile time is part of every cold solve's end-to-end time.  JAX's
persistent compilation cache stores the serialized executable keyed by
(HLO, platform), so a later process loads it instead of compiling.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
module sets no directory.  Otherwise the cache goes to the fixed
``<checkout>/.jax_cache``: the path is part of what makes a later run find
the entries, so it must not move between runs.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)

_enabled = False


def compilation_cache_dir() -> str:
    """Where compiled executables are persisted."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_compilation_cache() -> str | None:
    """Enable the persistent JAX compilation cache (idempotent).

    Returns the cache directory, or None on the CPU backend: CPU compiles
    are cheap, and reloading CPU AOT results emits noisy machine-feature
    mismatch warnings.  Only compiles slower than 1 s are persisted.
    """
    global _enabled
    import jax

    if jax.default_backend() == "cpu":
        return None
    path = compilation_cache_dir()
    if _enabled:
        return path
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _enabled = True
    return path
