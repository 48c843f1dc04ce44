"""Multi-process entry for the mesh executor.

The reference has no distributed story at all (SURVEY.md §2 "Parallelism
strategies: none").  Here every process initializes ``jax.distributed``,
the global (dp, tp) mesh spans all processes' devices, the dp axis
carries the batch (independent ciphertext slices — no collectives on the
hot path), and each tp group stays inside one process, whose cards share
the key-contraction psum over their direct links.

Single-process runs (tests, one process driving all cards of a host) skip
initialization and get the local mesh — the executor code is identical
either way.
"""

from __future__ import annotations

import logging
import os

import jax
import numpy as np
from jax.sharding import Mesh

from .mesh import make_mesh

__all__ = ["init_distributed", "global_mesh"]

log = logging.getLogger(__name__)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize ``jax.distributed`` when running multi-process.

    Arguments default to the environment variables
    ``JAX_COORDINATOR_ADDRESS`` (e.g. ``localhost:12345``) /
    ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``; nothing is auto-detected,
    so a multi-process run names all three.  Returns True when a
    multi-process runtime was initialized, False for the single-process
    fallback.
    """
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    num_processes = num_processes if num_processes is not None else \
        int(os.environ.get("JAX_NUM_PROCESSES", "0") or 0)
    process_id = process_id if process_id is not None else \
        int(os.environ.get("JAX_PROCESS_ID", "-1") or -1)

    if not coordinator and num_processes <= 1:
        log.info("single-process run: jax.distributed not initialized")
        return False
    kwargs = {}
    if coordinator:
        kwargs["coordinator_address"] = coordinator
    if num_processes > 0:
        kwargs["num_processes"] = num_processes
    if process_id >= 0:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    log.info("jax.distributed: process %d/%d, %d local / %d global devices",
             jax.process_index(), jax.process_count(),
             jax.local_device_count(), jax.device_count())
    return True


def global_mesh(tp: int = 1) -> Mesh:
    """(dp, tp) mesh over ALL processes' devices, tp innermost.

    ``jax.devices()`` orders devices process-major, so reshaping to
    (dp, tp) keeps each tp group inside one process as long as tp divides
    the local device count — asserted here, because a tp group spanning
    processes would put the per-step key-contraction psum on the
    inter-host network.
    """
    local = jax.local_device_count()
    assert tp >= 1 and local % tp == 0, \
        f"tp={tp} must divide the {local} local devices (a tp group may " \
        f"not span processes: the key-contraction psum must stay in-host)"
    return make_mesh(np.asarray(jax.devices()), tp=tp)
