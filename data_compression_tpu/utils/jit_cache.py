"""Persistent compilation cache.

Enabled lazily, on the first device compile of an encode or decode path,
never on bare ``import data_compression_tpu``.  Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this module
sets nothing.  Otherwise the cache lives in one fixed directory inside
the checkout, ``.jax_cache/`` (git-ignored): the path is part of each
entry's key, so it never depends on a temporary name, a pid or the time.
"""

from __future__ import annotations

import os
from typing import Optional

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)

_done = False


def cache_dir() -> Optional[str]:
    """Directory this module points JAX at: None when the environment
    variable names one (JAX then uses it as it stands)."""
    return None if ENV in os.environ else CHECKOUT_DIR


def enable_persistent_cache() -> None:
    """Idempotent; call before the first device compile."""
    global _done
    if _done:
        return
    _done = True
    d = cache_dir()
    if d is None:
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
