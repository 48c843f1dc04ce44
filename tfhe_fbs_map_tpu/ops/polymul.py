"""Negacyclic polynomial arithmetic in Z_{2^32}[X]/(X^N + 1).

A negacyclic product is a vector–matrix product with the (anti)circulant
matrix of one operand, so a matrix unit — not an FFT — executes it
exactly (an f32 FFT's error would swamp the torus noise budget).
Exactness comes from int32 wraparound and, on the fast path, from int8
limb splitting with int32 accumulation
(:func:`tfhe_fbs_map_tpu.tfhe.numeric.signed_limbs`).

* :func:`negacyclic_polymul` — generic exact product via an on-the-fly
  negacyclic matrix (gather).  Reference path, any shape.
* int8 limb matmuls against negacyclic key matrices — built in
  :mod:`tfhe_fbs_map_tpu.ops.blind_rotate` for the blind-rotate hot loop.
* :func:`monomial_rotate` — X^a · poly with per-row amounts, a gather.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# canonical torus dtype (duplicated from tfhe.numeric to keep ops/ leaf-level)
I32 = jnp.int32

__all__ = ["negacyclic_matrix", "negacyclic_polymul", "monomial_rotate",
           "np_negacyclic_polymul"]


def negacyclic_matrix(poly: jnp.ndarray) -> jnp.ndarray:
    """[..., N] -> [..., N, N] matrix M with (a ⊛ poly)[t] = Σ_j a[j]·M[j, t].

    M[j, t] = poly[t-j] for t >= j, else -poly[N+t-j] (X^N = -1).
    """
    n = poly.shape[-1]
    t = jnp.arange(n)[None, :]
    j = jnp.arange(n)[:, None]
    idx = (t - j) % n
    sign = jnp.where(t >= j, 1, -1).astype(I32)
    return sign * jnp.take(poly, idx, axis=-1)


def negacyclic_polymul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Exact negacyclic product over matching leading batch dims.

    ``a``: [..., N] (typically small digit values), ``b``: [..., N] torus.
    """
    mat = negacyclic_matrix(b)                       # [..., N, N]
    return jnp.einsum("...j,...jt->...t", a, mat,
                      preferred_element_type=I32).astype(I32)


def monomial_rotate(poly: jnp.ndarray, amount: jnp.ndarray) -> jnp.ndarray:
    """X^amount · poly with amount ∈ [0, 2N), batched.

    ``poly``: [..., N]; ``amount``: broadcastable to ``poly.shape[:-1]``.
    out[t] = poly[t - amount] with the negacyclic sign on wraparound.
    """
    n = poly.shape[-1]
    amount = jnp.asarray(amount)[..., None]           # [..., 1]
    t = jnp.arange(n)                                  # [N]
    idx2n = (t - amount) % (2 * n)                     # [..., N]
    wrap = idx2n >= n
    idx = jnp.where(wrap, idx2n - n, idx2n)
    shape = jnp.broadcast_shapes(poly.shape, idx.shape)
    gathered = jnp.take_along_axis(jnp.broadcast_to(poly, shape),
                                   jnp.broadcast_to(idx, shape), axis=-1)
    return jnp.where(jnp.broadcast_to(wrap, shape), -gathered,
                     gathered).astype(I32)


def negacyclic_rotation_stack(polys: jnp.ndarray) -> jnp.ndarray:
    """[..., N] -> [..., N, N]: row j = X^j·poly — equal to
    :func:`negacyclic_matrix`, built by log2 N doubling steps of static
    negacyclic rolls."""
    n = polys.shape[-1]
    r = polys[..., None, :]
    step = 1
    while step < n:
        r = jnp.concatenate([r, negacyclic_roll_static(r, step)], axis=-2)
        step *= 2
    return r


def negacyclic_roll_static(poly: jnp.ndarray, s: int) -> jnp.ndarray:
    """X^s · poly for a *static* s ∈ [0, 2N): two slices + a concat."""
    n = poly.shape[-1]
    s = s % (2 * n)
    neg = s >= n
    s = s - n if neg else s
    if s == 0:
        out = poly
    else:
        out = jnp.concatenate([-poly[..., n - s:], poly[..., : n - s]],
                              axis=-1)
    return -out if neg else out


# ---------------------------------------------------------------------------
# numpy reference (known-answer tests)
# ---------------------------------------------------------------------------

def np_negacyclic_polymul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact negacyclic product mod 2^32 via full convolution (host-side)."""
    n = a.shape[-1]
    conv = np.convolve(np.asarray(a, dtype=np.int64),
                       np.asarray(b, dtype=np.int64))
    out = np.zeros(n, dtype=np.int64)
    out[: len(conv[:n])] = conv[:n]
    out[: len(conv) - n] -= conv[n:]
    return out.astype(np.uint32).astype(np.int32)
