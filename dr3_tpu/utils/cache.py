"""Persistent XLA compilation cache.

The scan program, the BA solvers and the panorama programs each take
seconds to minutes to compile, so first-run latency of the pipelines is
compile-dominated. JAX's persistent compilation cache serializes compiled
executables keyed by the program and its compile options. Every entry
point calls :func:`enable_persistent_cache` before its first compile.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing. Otherwise the cache lives at the fixed path
``<checkout>/.jax_cache`` (listed in ``.gitignore``): the path is part of
what a cache hit needs, so it must not move between runs.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_persistent_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already uses that directory
    and only the minimum compile time to cache is set here."""
    import jax

    if not os.environ.get(ENV_VAR):
        os.makedirs(DEFAULT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir()
