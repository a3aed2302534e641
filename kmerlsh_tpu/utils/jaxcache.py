"""Persistent XLA compilation cache.

The clustering loop compiles one program per (capacity, samples) shape, so
a fresh process spends most of a small run compiling. JAX's persistent
cache makes every pipeline/bench invocation after the first start hot.

Where the cache lives:

  * ``JAX_COMPILATION_CACHE_DIR`` set — JAX reads it itself; nothing is
    configured here;
  * unset — one fixed directory inside the checkout
    (:data:`CACHE_ROOT`/``jax``). The path is part of the cache key, so
    a fixed path is what lets a later process find the entries.
"""

from __future__ import annotations

import os

# per-checkout cache root (listed in .gitignore); also holds the device
# memory calibration of utils/hbm.py
CACHE_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".cache")

_enabled = False


def cache_dir() -> str | None:
    """Directory this module would configure, or None when
    ``JAX_COMPILATION_CACHE_DIR`` already names one."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(CACHE_ROOT, "jax")


def enable_compilation_cache() -> None:
    global _enabled
    if _enabled:
        return
    path = cache_dir()
    if path is not None:
        import jax

        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    _enabled = True
