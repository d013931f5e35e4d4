"""Where the persistent compilation cache lives.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself, so when it is set nothing is
configured in code.  Otherwise the cache goes to ``<repo>/.jax_cache``: a
fixed path, because the cache key includes it and a directory that moves
never hits.  Scripts call :func:`use_compile_cache` before their first
compile; the library itself never does.
"""

from __future__ import annotations

import os

import jax

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV = "JAX_COMPILATION_CACHE_DIR"


def use_compile_cache() -> str:
    """Return the cache directory in force, configuring ``<repo>/.jax_cache``
    when the environment names none."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    path = os.path.join(REPO, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
