"""Persistent XLA compilation cache setup.

The cache lives where JAX_COMPILATION_CACHE_DIR says when it is set, and
otherwise at the fixed <repo>/.jax_cache (the path is part of the cache key,
so a directory that moves never hits). Call enable_compilation_cache()
before the first compile.
"""

from __future__ import annotations

import os
from pathlib import Path

_DEFAULT = Path(__file__).resolve().parent.parent.parent / ".jax_cache"


def cache_dir(path: str | os.PathLike | None = None) -> Path:
    """The directory the cache uses: `path`, else JAX_COMPILATION_CACHE_DIR,
    else <repo>/.jax_cache."""
    return Path(path or os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT)


def enable_compilation_cache(path: str | os.PathLike | None = None) -> None:
    import jax

    d = cache_dir(path)
    d.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(d))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
