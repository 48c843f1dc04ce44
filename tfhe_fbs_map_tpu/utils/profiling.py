"""Profiling: the JAX profiler as a context manager for kernel-level
traces.  Timings elsewhere end in ``block_until_ready`` (device work is
asynchronous)."""

from __future__ import annotations

import contextlib

import jax

__all__ = ["jax_trace"]


@contextlib.contextmanager
def jax_trace(logdir: str):
    """JAX profiler trace (view with tensorboard or xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
