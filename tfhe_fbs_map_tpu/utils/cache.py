"""Persistent JAX compilation cache shared by every entry point."""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["enable_compile_cache"]

# a fixed path inside the checkout (never a temporary name, pid or time),
# so every run from this checkout finds what the previous one compiled
_REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and no
    other directory is set here.  Otherwise the cache lives in
    ``<repo>/.jax_cache`` (listed in ``.gitignore``)."""
    import jax
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(_REPO_CACHE_DIR))
    return str(_REPO_CACHE_DIR)
