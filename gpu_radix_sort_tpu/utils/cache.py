"""JAX's persistent compilation cache: one rule for every entry point.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and the
cache stays there.  Where it is not, the cache goes to ``.jax_cache`` at the
root of this checkout — a fixed path, because the path is part of the
cache's key and a directory that moves never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir(environ=None) -> tuple[str, bool]:
    """(directory, whether this module has to set it): the environment's
    directory where ``JAX_COMPILATION_CACHE_DIR`` is set, else the
    checkout's ``.jax_cache``."""
    environ = os.environ if environ is None else environ
    path = environ.get(ENV)
    if path:
        return path, False
    return str(DEFAULT_DIR), True


def enable_compile_cache() -> str:
    """Point JAX's compilation cache at :func:`compile_cache_dir` and
    return the directory.  Call before the first compile."""
    import jax

    path, must_set = compile_cache_dir()
    if must_set:
        jax.config.update("jax_compilation_cache_dir", path)
    return path
