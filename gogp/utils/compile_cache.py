"""Where JAX keeps its persistent compilation cache for this checkout.

The benchmark scripts and ``chip_smoke.py`` call :func:`enable_compile_cache`
once at start-up.  When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and nothing is set here.  Otherwise the cache lives at
``<checkout>/.jax_cache``: a fixed path, because the path is part of what the
cache is keyed on, so a per-process or temporary directory would never hit.
"""

from __future__ import annotations

import os
import pathlib

import jax

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]
ENV = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at the checkout unless the environment
    already chose a directory; returns the directory in use.  Programs that
    compile in under two seconds are not cached."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return path
