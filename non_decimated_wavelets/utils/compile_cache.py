"""Where the persistent XLA compilation cache lives.

One rule for every entry point (``chip_smoke.py``, ``bench.py``,
``scripts/multihost_bench.py``): if ``JAX_COMPILATION_CACHE_DIR`` is set,
JAX already reads it and no other cache is set here; otherwise the cache
goes to ``.jax_cache`` beside the package, a fixed path, because the path
is part of the cache key and a directory that moves never hits.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the cache uses under the rule above."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`."""
    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
