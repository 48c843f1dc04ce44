"""Int8 tensor-core fast paths for the programmable bootstrap.

The blind-rotate hot loop costs ``n · (k+1)² · l · N² · L`` int8 MACs per
ciphertext (L = key limbs) — all the FLOPs of the framework.  Each CMux
step is ONE wide s8×s8→s32 ``dot_general`` of the gadget digits
``[B, rows·N]`` against the step's negacyclic key matrix (``L·(k+1)·N``
outputs), inside a ``lax.scan`` over the n steps.  Two key
forms feed that product:

* ``"matmul"``: the key matrices are precomputed once and streamed from
  device memory, ``n·L·rows·N·(k+1)·N`` bytes (10.3 GB at the bench
  anchor), stored output-major ``[L·(k+1)·N, rows·N]`` so the contraction
  dim is minor in both operands — the layout cuBLAS's int8 GEMM takes
  without a transpose of the key.  Optional BSK limb-drop quantization.
* ``"compact"``: only the ``[L·(k+1), rows, 2N]`` anti-periodic limb
  extension of every GGSW row is kept (``N``× smaller: 40 MB at the
  anchor, 139 MB at native p=32) and each step's matrix is rebuilt from it
  as a Toeplitz view (:func:`toeplitz_rows`).  The only form that holds
  N=2048 families, or both staged families at once, in 80 GB.

Exactness mod 2^32 everywhere: keys split into balanced 8-bit limbs
(s32 accumulation stays < 2^27), recombined with wrapping shifts.  Every
path is asserted bit-identical to the generic
:mod:`tfhe_fbs_map_tpu.tfhe.pbs` implementation in tests/test_fast_path.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..tfhe.keys import TFHEKeys
from ..tfhe.numeric import I32, gadget_decompose, signed_limbs
from ..tfhe.params import Q_BITS, TFHEParams
from .polymul import monomial_rotate

__all__ = ["FastKeys", "ORIENTATIONS", "prepare_fast_keys",
           "functional_bootstrap_fast", "external_product_fast",
           "key_bytes", "pick_orientation", "toeplitz_rows"]

N_LIMBS = 4
LIMB_BITS = 8
ORIENTATIONS = ("matmul", "compact")


class FastKeys:
    """Device-side preprocessed key material for the int8 fast path."""

    def __init__(self, params: TFHEParams, bsk_kernels: jnp.ndarray,
                 ksk_limbs: jnp.ndarray, orientation: str = "matmul"):
        assert orientation in ORIENTATIONS, orientation
        self.params = params
        # matmul:  [n, L·(k+1)·N, rows·N] int8 — precomputed key matrices
        # compact: [n, L·(k+1), rows, 2N] int8 — anti-periodic extensions
        self.bsk_kernels = bsk_kernels
        # [N_LIMBS, kN*l_ks, n+1] int8 — key-switch matmul limbs
        self.ksk_limbs = ksk_limbs
        self.orientation = orientation


def key_bytes(params: TFHEParams, orientation: str,
              bsk_limbs: int = N_LIMBS) -> int:
    """Device bytes of the bootstrapping key in ``orientation``'s form."""
    k1 = params.glwe_dim + 1
    rows, N = k1 * params.bsk_level, params.poly_size
    per_step = rows * N * k1 * N if orientation == "matmul" \
        else k1 * rows * 2 * N
    return params.lwe_dim * bsk_limbs * per_step


# Share of the device's memory that precomputed key matrices may take; the
# rest is left to the wire buffer and transients.  A chosen margin, not a
# measured limit (PERF.md lists what has been seen to fit).
MATMUL_KEY_SHARE = 0.6


def pick_orientation(param_sets, backend: str,
                     mem_bytes: float) -> str | None:
    """Key form for the families in ``param_sets`` (all held at once).

    ``None`` (the generic path) off the GPU or when a gadget base does not
    fit int8 digits; otherwise precomputed matrices when all of them take
    at most ``MATMUL_KEY_SHARE`` of ``mem_bytes``, compact keys when they
    do not."""
    if backend != "gpu" or any(p.bsk_base_log > 8 or p.ksk_base_log > 7
                               for p in param_sets):
        return None
    need = sum(key_bytes(p, "matmul") for p in param_sets)
    return "matmul" if need <= MATMUL_KEY_SHARE * mem_bytes else "compact"


def _ksk_limbs(keys: TFHEKeys) -> jnp.ndarray:
    params = keys.params
    kn_l = params.big_dim * params.ksk_level
    limbs = signed_limbs(keys.ksk.reshape(kn_l, params.lwe_dim + 1),
                         N_LIMBS, LIMB_BITS)             # [kn_l, n+1, L]
    return jnp.moveaxis(limbs, -1, 0).astype(jnp.int8)


def prepare_fast_keys(keys: TFHEKeys, orientation: str = "matmul",
                      bsk_limbs: int = N_LIMBS) -> FastKeys:
    """``bsk_limbs`` < 4 drops the least significant key limbs — BSK
    quantization: −25% MACs and memory per dropped limb for a bounded extra
    noise term of std ``sqrt(rows·N·(B²/12)·(2^(8·drop))²/12)`` per
    blind-rotate step."""
    params = keys.params
    assert orientation in ORIENTATIONS, orientation
    assert params.bsk_base_log <= 8, "gadget digits must fit int8"
    assert params.ksk_base_log <= 7

    n = params.lwe_dim
    k1 = params.glwe_dim + 1
    rows = k1 * params.bsk_level
    N = params.poly_size
    drop = N_LIMBS - bsk_limbs

    if orientation == "compact":
        # Per (step, limb λ, component c, row r) the length-2N
        # anti-periodic limb extension E = [limbs(−poly)_λ, limbs(poly)_λ]:
        # row j of the negacyclic matrix is the window E[N−j : 2N−j], so the
        # X^N = −1 signs live in E's data and the matrix is a pure view.
        pos = signed_limbs(keys.bsk, N_LIMBS, LIMB_BITS)     # [n,r,k+1,N,L]
        neg = signed_limbs(-keys.bsk, N_LIMBS, LIMB_BITS)
        ext = jnp.concatenate([neg, pos], axis=-2)[..., drop:]
        ext = jnp.transpose(ext, (0, 4, 2, 1, 3))            # [n,L,k+1,r,2N]
        kern = ext.reshape(n, bsk_limbs * k1, rows, 2 * N).astype(jnp.int8)
        return FastKeys(params, kern, _ksk_limbs(keys), orientation)

    # Precomputed negacyclic matrices of every GGSW row poly, as int8
    # limbs: [n, L*(k+1)*N, rows*N], output (limb, comp, t) limb-major so
    # one wide matmul covers all limbs, contraction (r, j) minor.
    # Built chunk by chunk into a preallocated buffer inside one jit (a
    # fori_loop whose carry XLA updates in place), so the int32
    # transients stay at a few hundred MB.
    def build_chunk(bsk_chunk):                          # [c, rows, k+1, N]
        c = bsk_chunk.shape[0]
        ext = jnp.concatenate([-bsk_chunk, bsk_chunk], axis=-1)
        mats = toeplitz_rows(ext)                        # [c,r,k+1,j,t]
        limbs = signed_limbs(mats, N_LIMBS, LIMB_BITS)[..., drop:]
        limbs = jnp.transpose(limbs, (0, 5, 2, 4, 1, 3))  # [c,L,k+1,t,r,j]
        return limbs.reshape(c, bsk_limbs * k1 * N, rows * N) \
            .astype(jnp.int8)

    chunk = next((c for c in (2, 3, 5, 7, 4, 6, 8, 9, 10, 16)
                  if n % c == 0), 1)
    bsk_r = keys.bsk.reshape(n // chunk, chunk, rows, k1, N)
    out_shape = (n, bsk_limbs * k1 * N, rows * N)

    @jax.jit
    def build_all(b):
        def body(idx, out):
            return jax.lax.dynamic_update_slice(
                out, build_chunk(b[idx]), (idx * chunk, 0, 0))
        return jax.lax.fori_loop(0, n // chunk, body,
                                 jnp.zeros(out_shape, jnp.int8))

    return FastKeys(params, build_all(bsk_r), _ksk_limbs(keys), orientation)


def toeplitz_rows(ext: jnp.ndarray) -> jnp.ndarray:
    """[..., 2N] anti-periodic extensions -> [..., N, N] negacyclic
    matrices, ``M[j, t] = ext[N + t − j]`` (equal to
    :func:`tfhe_fbs_map_tpu.ops.polymul.negacyclic_matrix` of the upper half).

    Gather-free: N back-to-back copies of ``ext`` read with a row stride of
    2N − 1 put ``ext[N − j + t]`` at row j, column t, so the matrix is one
    broadcast, reshape and two slices — a single copy fusion in XLA."""
    two_n = ext.shape[-1]
    n = two_n // 2
    lead = ext.shape[:-1]
    flat = jnp.broadcast_to(ext[..., None, :], lead + (n, two_n)) \
        .reshape(lead + (n * two_n,))
    win = flat[..., n:n + n * (two_n - 1)].reshape(lead + (n, two_n - 1))
    return win[..., :n]


def _combine_limbs(x: jnp.ndarray, axis: int,
                   drop: int = 0) -> jnp.ndarray:
    """Σ_m x_m << (8·(m+drop)) along ``axis`` (exact mod 2^32).

    ``drop`` > 0 means the least-significant limbs were omitted upstream
    (quantized bootstrapping key): remaining limbs shift up accordingly.
    """
    n_limbs = x.shape[axis]
    parts = [jnp.take(x, m, axis=axis).astype(I32)
             << (LIMB_BITS * (m + drop)) for m in range(n_limbs)]
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def external_product_fast(diff: jnp.ndarray, kernels: jnp.ndarray,
                          params: TFHEParams,
                          orientation: str = "matmul") -> jnp.ndarray:
    """GGSW ⊡ diff as one s8×s8→s32 matmul: [B, k+1, N] -> [B, k+1, N].

    ``kernels`` is one step's key: [L·(k+1)·N, rows·N] (matmul) or
    [L·(k+1), rows, 2N] (compact, expanded here by :func:`toeplitz_rows`).
    """
    l, b = params.bsk_level, params.bsk_base_log
    k1 = params.glwe_dim + 1
    N = params.poly_size
    batch = diff.shape[0]

    digits = gadget_decompose(diff, b, l)                # [B, k+1, N, l]
    digits = jnp.moveaxis(digits, -1, 2)                 # [B, k+1, l, N]
    flat = digits.reshape(batch, k1 * l * N).astype(jnp.int8)

    if orientation == "compact":
        g = kernels.shape[0]
        mats = toeplitz_rows(kernels)                    # [G, rows, j, t]
        kernels = jnp.transpose(mats, (0, 3, 1, 2)).reshape(
            g * N, k1 * l * N)
    n_l = kernels.shape[0] // (k1 * N)
    prods = jnp.einsum("bt,dt->bd", flat, kernels,
                       preferred_element_type=I32)       # [B, L*k1*N]
    prods = prods.reshape(batch, n_l, k1 * N)
    out = _combine_limbs(prods, axis=1, drop=N_LIMBS - n_l)
    return out.reshape(batch, k1, N)


def keyswitch_fast(big_cts: jnp.ndarray, fast: FastKeys) -> jnp.ndarray:
    params = fast.params
    kn = params.big_dim
    batch = big_cts.shape[0]
    digits = gadget_decompose(big_cts[:, :kn], params.ksk_base_log,
                              params.ksk_level)
    flat = digits.reshape(batch, kn * params.ksk_level).astype(jnp.int8)
    prods = jnp.einsum("bt,mtd->bmd", flat, fast.ksk_limbs,
                       preferred_element_type=I32)       # [B, L, n+1]
    out = -_combine_limbs(prods, axis=1)
    return out.at[:, params.lwe_dim].add(big_cts[:, kn])


def _modswitch(x, params: TFHEParams):
    log2n1 = params.poly_size.bit_length()
    u = jnp.asarray(x).astype(jnp.uint32)
    return ((u + jnp.uint32(1 << (Q_BITS - log2n1 - 1)))
            >> jnp.uint32(Q_BITS - log2n1)).astype(I32)


@partial(jax.jit, static_argnums=(0, 1))
def _fbs_fast_impl(params: TFHEParams, orientation: str, bsk_kernels,
                   ksk_limbs, big_cts, test_polys, posts):
    fast = FastKeys(params, bsk_kernels, ksk_limbs, orientation)
    n, k, N = params.lwe_dim, params.glwe_dim, params.poly_size
    batch = big_cts.shape[0]

    with jax.named_scope("keyswitch"):
        shifted = big_cts.at[:, -1].add(I32(params.half_window))
        small = keyswitch_fast(shifted, fast)
    with jax.named_scope("modswitch"):
        a_t = _modswitch(small[:, :n], params)
        b_t = _modswitch(small[:, n], params)

    with jax.named_scope("blind_rotate"):
        v_init = monomial_rotate(test_polys, (2 * N - b_t) % (2 * N))
        acc = jnp.concatenate(
            [jnp.zeros((batch, k, N), dtype=I32), v_init[:, None, :]], axis=1)

        def step(acc, xs):
            a_i, kern_i = xs
            rotated = monomial_rotate(acc, a_i[:, None])
            return acc + external_product_fast(
                rotated - acc, kern_i, params, orientation), None
        acc, _ = jax.lax.scan(step, acc, (a_t.T, bsk_kernels))

    with jax.named_scope("sample_extract"):
        a = acc[:, :k, :]
        a_ext = jnp.concatenate([a[..., :1], -a[..., :0:-1]], axis=-1)
        out = jnp.concatenate([a_ext.reshape(batch, k * N), acc[:, k, :1]],
                              axis=1)
        return out.at[:, -1].add(posts)


def functional_bootstrap_fast(fast: FastKeys, big_cts, test_polys, posts):
    """Batched FBS on the int8 fast path; semantics identical to
    :func:`tfhe_fbs_map_tpu.tfhe.pbs.functional_bootstrap`."""
    return _fbs_fast_impl(fast.params, fast.orientation, fast.bsk_kernels,
                          fast.ksk_limbs, big_cts, test_polys, posts)
