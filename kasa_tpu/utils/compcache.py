"""Persistent XLA compilation cache.

The reference binary pays no warm-up: identify maps the index and
starts scanning (Compare.hpp:182-276).  Our XLA programs compile on
first use; JAX's persistent compilation cache turns every repeat run's
compile into a disk read.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing.  Otherwise the cache lives at one fixed directory
inside the checkout (``.jax_cache/``, listed in ``.gitignore``): the
directory is part of the cache's key, so a path that moves never hits.

Called by the CLI, chip_smoke.py, bench.py and the profiling tools
before the first dispatch.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Return the persistent compile cache's directory: the one
    JAX_COMPILATION_CACHE_DIR names (JAX reads it itself), else
    CHECKOUT_DIR, which this points JAX at.  Safe to call repeatedly;
    it takes effect when called before the first compile."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax
    if jax.config.jax_compilation_cache_dir != CHECKOUT_DIR:
        os.makedirs(CHECKOUT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", CHECKOUT_DIR)
        # keep every program, not only those over JAX's 1 s default:
        # the turbo family is a handful of executables, and each
        # recompile is paid again on every cold start
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return CHECKOUT_DIR
