"""Persistent compilation cache location — one rule for every entry point.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this module
sets nothing. Otherwise the cache lives at the fixed ``<repo>/.jax_cache``
(listed in ``.gitignore``): the path is part of the cache key, so it must
not move between runs.
"""

from __future__ import annotations

import os

__all__ = ["REPO_CACHE_DIR", "compile_cache_dir", "enable_compile_cache"]

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compile_cache_dir() -> str:
    """The directory the persistent cache uses under the rule above."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    (a no-op when ``JAX_COMPILATION_CACHE_DIR`` is set); returns the
    directory."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
