"""Programmable (functional) bootstrap: key switch → blind rotate → extract.

The device realization of the primitive the reference delegates to
Concrete: it evaluates exactly the semantics of a ``LutProgram`` bootstrap
node (reference ``fbs_exec_env.py:218-220``), including the three negacyclic
half-table acceptance modes of the mapper (``map_to_fbs.py:81-98``):

* tables of length tau <= p look up directly in a window-replicated test
  polynomial;
* tables of length p < tau <= 2p exploit X^N = -1: with the affine encoding
  ``H[x] = T[x]*delta - C*delta/2`` (C = T[x] + T[x+p], constant over the
  overlap — 2 for mode 3, 1 for mode 1, 0 for mode 2), the negated upper
  half decodes to the correct table entries after re-adding the offset.

Everything is batched over ciphertexts ([B, ...]) — the executor's
throughput comes from batching all bootstraps of one circuit level into one
blind rotation (SURVEY.md §5 "level-wise batched bootstrapping").
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.polymul import monomial_rotate, negacyclic_matrix
from .keys import TFHEKeys
from .numeric import I32, gadget_decompose, round_shift_right
from .params import Q_BITS, TFHEParams

__all__ = ["build_test_vector", "keyswitch", "blind_rotate", "sample_extract",
           "functional_bootstrap", "external_product", "cmux"]


# ---------------------------------------------------------------------------
# Test-vector encoding (host-side, per distinct table)
# ---------------------------------------------------------------------------

def build_test_vector(table, params: TFHEParams,
                      out_delta: int | None = None) -> tuple[np.ndarray, int]:
    """(test polynomial [N] int32, post-rotation body offset).

    The polynomial holds ``H[floor(t*p/N)]`` so that after blind rotation by
    the (half-window pre-offset) phase of a ciphertext encoding value ``x``,
    the constant coefficient is ``T[x]*delta - post`` — adding ``post`` to
    the extracted body yields a fresh encryption of ``T[x]*delta``.

    ``out_delta``: torus units per table unit of the OUTPUT encoding
    (default ``params.delta``, i.e. input and output share the grid).
    Output scaling is noise-free — the test-vector values carry no noise —
    so a bootstrap can emit ``T[x]*c*delta`` at the same output variance as
    ``T[x]*delta``.  This is the basis of the scaled-wire-encoding
    optimization (a wire consumed with coefficient ``c`` is produced
    pre-scaled, turning the consumer's lincomb noise amplification ``c^2``
    into 1) and of the staged multi-digit bootstrap
    (:mod:`tfhe_fbs_map_tpu.tfhe.staged`), whose stage-1 emits a packed
    2-bit value on the stage-2 grid.
    """
    p, N = params.p, params.poly_size
    delta = params.delta if out_delta is None else int(out_delta)
    table = list(table)
    tau = len(table)
    assert 1 <= tau <= 2 * p, f"table length {tau} vs fbs size {p}"

    if tau > p:
        c = table[0] + table[p]
        for x in range(tau - p):
            assert table[x] + table[x + p] == c, (
                "table does not satisfy any negacyclic mode "
                f"(len {tau} > p={p}): {table}")
        post = (c * delta) // 2
    else:
        post = 0

    h = np.array([table[min(j, tau - 1)] * delta - post for j in range(p)],
                 dtype=np.int64)
    window = (np.arange(N, dtype=np.int64) * p) // N
    tv = h[window]
    return tv.astype(np.uint32).astype(np.int32), int(post)


# ---------------------------------------------------------------------------
# Core homomorphic operators (jittable; params static)
# ---------------------------------------------------------------------------

def external_product(glwe: jnp.ndarray, ggsw: jnp.ndarray,
                     params: TFHEParams) -> jnp.ndarray:
    """GGSW ⊡ GLWE: [B, k+1, N] x [(k+1)l, k+1, N] -> [B, k+1, N].

    Gadget-decomposes the GLWE components and contracts against the GGSW
    rows; ring products go through the on-the-fly negacyclic matrix (the
    generic exact path — the int8 fast path lives in ops/blind_rotate.py).
    """
    l, b = params.bsk_level, params.bsk_base_log
    k1 = params.glwe_dim + 1
    batch = glwe.shape[0]
    n = params.poly_size

    digits = gadget_decompose(glwe, b, l)            # [B, k+1, N, l]
    digits = jnp.moveaxis(digits, -1, 2)             # [B, k+1, l, N]
    digits = digits.reshape(batch, k1 * l, n)        # rows: c*l + lev

    mats = negacyclic_matrix(ggsw)                   # [(k+1)l, k+1, N, N]
    return jnp.einsum("brj,rcjt->bct", digits, mats,
                      preferred_element_type=I32).astype(I32)


def cmux(ggsw: jnp.ndarray, ct0: jnp.ndarray, ct1: jnp.ndarray,
         params: TFHEParams) -> jnp.ndarray:
    """Select ct1 where the GGSW bit is 1, ct0 where 0."""
    return ct0 + external_product(ct1 - ct0, ggsw, params)


def keyswitch(big_cts: jnp.ndarray, keys: TFHEKeys) -> jnp.ndarray:
    """LWE key switch big (kN) -> small (n): [B, kN+1] -> [B, n+1]."""
    params = keys.params
    kn = params.big_dim
    batch = big_cts.shape[0]
    digits = gadget_decompose(big_cts[:, :kn], params.ksk_base_log,
                              params.ksk_level)      # [B, kN, l]
    flat = digits.reshape(batch, kn * params.ksk_level)
    ksk_flat = keys.ksk.reshape(kn * params.ksk_level, params.lwe_dim + 1)
    out = -jnp.einsum("bt,td->bd", flat, ksk_flat,
                      preferred_element_type=I32)
    return out.at[:, params.lwe_dim].add(big_cts[:, kn])


def modswitch(x: jnp.ndarray, params: TFHEParams) -> jnp.ndarray:
    """Torus -> Z_{2N} rotation amounts (uint32 values in [0, 2N))."""
    log2n1 = params.poly_size.bit_length()  # log2(2N) for power-of-two N
    return round_shift_right(x, Q_BITS - log2n1).astype(I32)


def blind_rotate(small_cts: jnp.ndarray, test_polys: jnp.ndarray,
                 keys: TFHEKeys) -> jnp.ndarray:
    """[B, n+1] x [B, N] -> GLWE accumulators [B, k+1, N].

    ACC := X^{-b~} · v, then n CMux steps ACC := CMux(bsk_i, ACC, X^{a~_i}·ACC)
    leave ACC = X^{-phase~} · v whose constant coefficient is the table
    lookup.  The loop is sequential in the LWE dimension — throughput comes
    from the ciphertext batch inside each step.
    """
    params = keys.params
    n, k, N = params.lwe_dim, params.glwe_dim, params.poly_size
    batch = small_cts.shape[0]

    a_t = modswitch(small_cts[:, :n], params)        # [B, n]
    b_t = modswitch(small_cts[:, n], params)         # [B]

    v_init = monomial_rotate(test_polys, (2 * N - b_t) % (2 * N))
    acc = jnp.concatenate(
        [jnp.zeros((batch, k, N), dtype=I32), v_init[:, None, :]], axis=1)

    def step(i, acc):
        rotated = monomial_rotate(acc, a_t[:, i][:, None])
        return acc + external_product(rotated - acc, keys.bsk[i], params)

    return jax.lax.fori_loop(0, n, step, acc)


def sample_extract(acc: jnp.ndarray, params: TFHEParams) -> jnp.ndarray:
    """Constant coefficient of GLWE -> big LWE: [B, k+1, N] -> [B, kN+1]."""
    k, N = params.glwe_dim, params.poly_size
    batch = acc.shape[0]
    a = acc[:, :k, :]
    a_ext = jnp.concatenate([a[..., :1], -a[..., :0:-1]], axis=-1)
    return jnp.concatenate(
        [a_ext.reshape(batch, k * N), acc[:, k, :1]], axis=1)


@partial(jax.jit, static_argnums=0)
def _fbs_impl(params: TFHEParams, bsk, ksk, big_cts, test_polys, posts):
    keys = TFHEKeys(params=params, lwe_key=None, glwe_key=None,
                    bsk=bsk, ksk=ksk)
    # half-window pre-offset centers each value inside its tv window
    shifted = big_cts.at[:, -1].add(I32(params.half_window))
    small = keyswitch(shifted, keys)
    acc = blind_rotate(small, test_polys, keys)
    out = sample_extract(acc, params)
    return out.at[:, -1].add(posts)


def functional_bootstrap(keys: TFHEKeys, big_cts: jnp.ndarray,
                         test_polys: jnp.ndarray,
                         posts: jnp.ndarray) -> jnp.ndarray:
    """Batched FBS: [B, kN+1] ciphertexts, per-row test polys [B, N] and
    post-offsets [B] -> fresh [B, kN+1] ciphertexts of the table lookups."""
    return _fbs_impl(keys.params, keys.bsk, keys.ksk, big_cts,
                     test_polys, posts)
