"""Where the persistent XLA compilation cache lives.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when that variable is set
nothing here changes it.  Otherwise the cache goes to one fixed directory
inside the checkout (``<repo>/.jax_cache``, git-ignored): the path is part
of the cache key, so a directory that moved between runs would never hit.
"""

from __future__ import annotations

import os
import pathlib

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The directory the cache uses: the environment's, else REPO_CACHE."""
    return os.environ.get(ENV_VAR) or str(REPO_CACHE)


def enable() -> str:
    """Point JAX's persistent cache at :func:`cache_dir`; returns it."""
    import jax

    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE))
    return cache_dir()
