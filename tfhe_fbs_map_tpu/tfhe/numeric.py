"""Exact mod-2^32 torus arithmetic helpers (JAX int32/uint32).

Accelerator int32 arithmetic is 32-bit two's-complement with wraparound —
exactly arithmetic mod 2^32, so the torus needs no emulation.  This module fixes the
conventions:

* canonical ciphertext dtype is ``int32`` (signed view of the torus),
* shifts/rounding go through ``uint32`` views (``astype`` wraps, preserving
  bit patterns),
* the signed gadget decomposition is the standard balanced base-2^b digit
  expansion with carry propagation (TFHE-rs style), vectorized over any
  leading batch shape.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .params import Q_BITS

I32 = jnp.int32
U32 = jnp.uint32


def to_torus(x) -> jnp.ndarray:
    """Any integer array -> canonical int32 torus representation."""
    return jnp.asarray(x).astype(U32).astype(I32)


def round_shift_right(x, shift: int) -> jnp.ndarray:
    """Round-to-nearest right shift of the uint32 view: round(x / 2^shift).

    Result is uint32 in [0, 2^(32-shift)] (the wrap at the top maps to 0,
    consistent mod 2^(32-shift))."""
    u = jnp.asarray(x).astype(U32)
    if shift == 0:
        return u
    rounded = u + U32(1 << (shift - 1))
    return rounded >> U32(shift)


def gadget_decompose(x, base_log: int, levels: int) -> jnp.ndarray:
    """Balanced signed gadget decomposition.

    Returns digits ``d`` with shape ``x.shape + (levels,)``, each in
    ``[-B/2, B/2]`` (B = 2^base_log), ordered most-significant level first,
    such that ``sum_i d[..., i] * 2^(32 - base_log*(i+1))`` equals ``x``
    rounded to its top ``base_log*levels`` bits.
    """
    b, l = base_log, levels
    assert b * l <= Q_BITS
    closest = round_shift_right(x, Q_BITS - b * l)  # uint32, b*l bits (+wrap)

    half_base = U32(1 << (b - 1))
    mask = U32((1 << b) - 1)
    digits = []
    for _ in range(l):  # least-significant level first
        d = closest & mask
        closest = closest >> U32(b)
        carry = (d >= half_base).astype(U32)
        d = d.astype(I32) - (carry.astype(I32) << b)
        closest = closest + carry
        digits.append(d)
    return jnp.stack(digits[::-1], axis=-1)


def gadget_recompose(digits, base_log: int) -> jnp.ndarray:
    """Inverse of :func:`gadget_decompose` (up to the rounding it performed)."""
    l = digits.shape[-1]
    acc = jnp.zeros(digits.shape[:-1], dtype=I32)
    for i in range(l):
        acc = acc + (digits[..., i].astype(I32) << (Q_BITS - base_log * (i + 1)))
    return acc


def signed_limbs(x, n_limbs: int = 4, limb_bits: int = 8) -> jnp.ndarray:
    """Balanced base-2^limb_bits limb split of int32 values.

    Returns shape ``x.shape + (n_limbs,)`` int32 limbs in [-2^(b-1), 2^(b-1))
    with ``sum_i limb_i * 2^(b*i) == x (mod 2^32)`` — the int8-friendly form
    the MXU matmul fast path consumes.
    """
    b = limb_bits
    u = jnp.asarray(x).astype(U32)
    half = U32(1 << (b - 1))
    mask = U32((1 << b) - 1)
    limbs = []
    for _ in range(n_limbs):
        d = u & mask
        u = u >> U32(b)
        carry = (d >= half).astype(U32)
        d = d.astype(I32) - (carry.astype(I32) << b)
        u = u + carry
        limbs.append(d)
    return jnp.stack(limbs, axis=-1)


# ---------------------------------------------------------------------------
# numpy mirrors (host-side reference / key generation)
# ---------------------------------------------------------------------------

def np_to_torus(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint32).astype(np.int32)


def np_round_shift_right(x, shift: int) -> np.ndarray:
    u = np.asarray(x).astype(np.uint32)
    if shift == 0:
        return u
    return (u + np.uint32(1 << (shift - 1))) >> np.uint32(shift)
