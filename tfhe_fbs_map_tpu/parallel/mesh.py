"""Device-mesh sharding for batched homomorphic execution.

Parallelism axes of the framework (the reference has none — SURVEY.md §2
"Parallelism strategies: none"):

* ``dp`` — data parallel over the ciphertext batch (independent bootstraps
  of one circuit level × user batch).  Embarrassingly parallel.
* ``tp`` — tensor parallel over key material: the key-switch key rows and
  the key-matrix contraction are sharded, with XLA inserting the int32
  psum (NCCL between GPUs).

The cards of one host are joined all to all, so the mesh is
``jax.devices()`` reshaped to (dp, tp) and follows the algorithm alone.

Keys are sharded once at setup; batches are sharded per call.  Everything
goes through ``jax.jit`` with ``NamedSharding`` annotations so GSPMD
propagates layouts and inserts collectives.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_batch", "replicate", "shard_fast_keys",
           "sharded_bootstrap"]


def make_mesh(devices=None, dp: int | None = None, tp: int = 1) -> Mesh:
    """2D (dp, tp) mesh over the available devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if dp is None:
        dp = n // tp
    assert dp * tp == n, f"{n} devices cannot form mesh ({dp}, {tp})"
    return Mesh(devices.reshape(dp, tp), axis_names=("dp", "tp"))


def shard_batch(mesh: Mesh, x: jnp.ndarray) -> jnp.ndarray:
    """Shard the leading (batch) axis over dp, replicate over tp."""
    return jax.device_put(x, NamedSharding(mesh, P("dp")))


def replicate(mesh: Mesh, x: jnp.ndarray) -> jnp.ndarray:
    return jax.device_put(x, NamedSharding(mesh, P()))


def shard_fast_keys(mesh: Mesh, fast):
    """Lay out FastKeys for the mesh.

    * key-switch limbs: sharded over tp rows (contraction -> psum);
    * matmul-orientation key matrices ([n, L·(k+1)·N, rows·N]): the
      contraction dimension rows·N is sharded over tp — each device holds
      a slice of every negacyclic key matrix and the external product's
      partial sums meet in a psum;
    * compact keys replicate (dp only: they are small, and each step's
      matrix is rebuilt from them on every device).
    """
    from ..ops.blind_rotate import FastKeys
    if fast.orientation == "matmul":
        bsk = jax.device_put(fast.bsk_kernels,
                             NamedSharding(mesh, P(None, None, "tp")))
    else:
        bsk = jax.device_put(fast.bsk_kernels, NamedSharding(mesh, P()))
    ksk = jax.device_put(fast.ksk_limbs, NamedSharding(mesh, P(None, "tp")))
    return FastKeys(fast.params, bsk, ksk, fast.orientation)


def sharded_bootstrap(mesh: Mesh, fast):
    """Batched FBS with dp-sharded inputs/outputs on ``mesh``, partitioned
    by GSPMD from the key layout of :func:`shard_fast_keys` (the keys are
    traced arguments, not constants baked into the executable)."""
    from ..ops.blind_rotate import _fbs_fast_impl
    batch = NamedSharding(mesh, P("dp"))
    jitted = jax.jit(
        lambda bsk, ksk, big_cts, tvs, posts: _fbs_fast_impl(
            fast.params, fast.orientation, bsk, ksk, big_cts, tvs, posts),
        in_shardings=(fast.bsk_kernels.sharding, fast.ksk_limbs.sharding,
                      batch, batch, batch),
        out_shardings=batch)

    def fn(big_cts, tvs, posts):
        return jitted(fast.bsk_kernels, fast.ksk_limbs, big_cts, tvs, posts)
    return fn
