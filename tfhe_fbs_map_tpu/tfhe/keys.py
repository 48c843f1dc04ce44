"""Key generation: LWE/GLWE secret keys, bootstrapping and key-switch keys.

Randomness (uniform masks, gaussian noise) is sampled host-side with a seeded
numpy Generator; the ring products assembling the keys run on device as exact
int32 (mod 2^32) matmuls against the GLWE key's negacyclic matrix.  Layouts
are chosen for the device executor:

* bootstrapping key: ``[n, (k+1)*l, k+1, N]`` int32 — one GGSW per small-key
  bit, rows indexed ``(component c, level)`` with level minor,
* key-switch key: ``[kN, l_ks, n+1]`` int32 — LWE rows under the small key,
  ready to flatten into the key-switch matmul.

The GGSW/KSK structure is the standard TFHE construction the reference uses
via Concrete (SURVEY.md §2 C18); built from scratch here.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import jax.numpy as jnp
import numpy as np

from ..ops.polymul import negacyclic_rotation_stack
from .numeric import I32
from .params import Q_BITS, TFHEParams

__all__ = ["TFHEKeys", "generate_keys"]


def _noise(rng: np.random.Generator, std: float, shape) -> np.ndarray:
    return np.round(rng.normal(0.0, std, shape)).astype(np.int64) \
        .astype(np.uint32).astype(np.int32)


def _uniform_torus(rng: np.random.Generator, shape) -> np.ndarray:
    return rng.integers(0, 1 << Q_BITS, shape, dtype=np.uint32) \
        .astype(np.int32)


@dataclass
class TFHEKeys:
    params: TFHEParams
    lwe_key: jnp.ndarray        # [n] int32 in {0,1}
    glwe_key: jnp.ndarray       # [k, N] int32 in {0,1}
    bsk: jnp.ndarray            # [n, (k+1)*l, k+1, N] int32
    ksk: jnp.ndarray            # [kN, l_ks, n+1] int32

    @cached_property
    def extracted_key(self) -> jnp.ndarray:
        """Big LWE key [kN]: the GLWE key coefficients in extract order."""
        return self.glwe_key.reshape(-1)

    @cached_property
    def key_matrices(self) -> jnp.ndarray:
        """Negacyclic matrices of the GLWE key polys, [k, N, N] int32."""
        return negacyclic_rotation_stack(self.glwe_key)


def save_keys(path: str, keys: TFHEKeys) -> None:
    """Serialize a key set (checkpoint; .npz)."""
    import dataclasses
    np.savez_compressed(
        path,
        params=np.array([list(dataclasses.asdict(keys.params).values())],
                        dtype=object),
        param_names=np.array(
            list(dataclasses.asdict(keys.params).keys())),
        lwe_key=np.asarray(keys.lwe_key),
        glwe_key=np.asarray(keys.glwe_key),
        bsk=np.asarray(keys.bsk),
        ksk=np.asarray(keys.ksk))


def load_keys(path: str) -> TFHEKeys:
    with np.load(path, allow_pickle=True) as z:
        kw = dict(zip(z["param_names"].tolist(), z["params"][0]))
        params = TFHEParams(**kw)
        return TFHEKeys(params=params,
                        lwe_key=jnp.asarray(z["lwe_key"]),
                        glwe_key=jnp.asarray(z["glwe_key"]),
                        bsk=jnp.asarray(z["bsk"]),
                        ksk=jnp.asarray(z["ksk"]))


def generate_keys(params: TFHEParams, seed: int = 0, *,
                  rng: np.random.Generator | None = None,
                  lwe_key: np.ndarray | None = None,
                  glwe_key: np.ndarray | None = None) -> TFHEKeys:
    """``lwe_key`` / ``glwe_key``: optional pre-sampled binary secrets —
    used by the staged bootstrap (:mod:`.staged`) to build two parameter
    families over ONE master GLWE secret and one shared small key, so that
    their sample-extracted big-LWE keys coincide (``extracted_key`` is the
    flattened GLWE key in natural order, independent of the (k, N) view)."""
    rng = np.random.default_rng(seed) if rng is None else rng
    n, k, N = params.lwe_dim, params.glwe_dim, params.poly_size
    l_b, b_b = params.bsk_level, params.bsk_base_log
    l_k, b_k = params.ksk_level, params.ksk_base_log

    lwe_key_np = (rng.integers(0, 2, n, dtype=np.int64).astype(np.int32)
                  if lwe_key is None else
                  np.asarray(lwe_key, dtype=np.int32))
    glwe_key_np = (rng.integers(0, 2, (k, N), dtype=np.int64).astype(np.int32)
                   if glwe_key is None else
                   np.asarray(glwe_key, dtype=np.int32).reshape(k, N))
    assert lwe_key_np.shape == (n,) and glwe_key_np.shape == (k, N)
    lwe_key = jnp.asarray(lwe_key_np)
    glwe_key = jnp.asarray(glwe_key_np)

    key_mats = negacyclic_rotation_stack(glwe_key)

    # --- bootstrapping key: GGSW(s_i) under the GLWE key ------------------
    # Fresh zero-encryptions (a_0..a_{k-1}, b = sum_c a_c ⊛ s_c + e), plus
    # the message s_i * g_lev on component c of row (c, lev).
    rows = (k + 1) * l_b
    a = jnp.asarray(_uniform_torus(rng, (n, rows, k, N)))
    e = jnp.asarray(_noise(rng, params.glwe_noise_std, (n, rows, N)))
    body = e
    for c in range(k):
        body = body + jnp.einsum("nrj,jt->nrt", a[:, :, c, :], key_mats[c],
                                 preferred_element_type=I32)

    msg = np.zeros((n, rows, k + 1, N), dtype=np.int64)
    for c in range(k + 1):
        for lev in range(l_b):
            g = 1 << (Q_BITS - b_b * (lev + 1))
            msg[:, c * l_b + lev, c, 0] = lwe_key_np.astype(np.int64) * g
    msg = jnp.asarray(msg.astype(np.uint32).astype(np.int32))

    bsk = jnp.concatenate([a, body[:, :, None, :]], axis=2) + msg

    # --- key-switch key: LWE(s_big[t] * g_lev) under the small key --------
    big_np = glwe_key_np.reshape(-1)                 # [kN]
    kn = big_np.shape[0]
    ks_a = jnp.asarray(_uniform_torus(rng, (kn, l_k, n)))
    ks_e = _noise(rng, params.lwe_noise_std, (kn, l_k)).astype(np.int64)
    ks_gadget = np.array(
        [1 << (Q_BITS - b_k * (lev + 1)) for lev in range(l_k)],
        dtype=np.int64)
    ks_msg = jnp.asarray(
        (big_np.astype(np.int64)[:, None] * ks_gadget[None, :] + ks_e)
        .astype(np.uint32).astype(np.int32))
    ks_b = jnp.einsum("tli,i->tl", ks_a, lwe_key,
                      preferred_element_type=I32) + ks_msg
    ksk = jnp.concatenate([ks_a, ks_b[:, :, None]], axis=2)

    return TFHEKeys(params=params, lwe_key=lwe_key, glwe_key=glwe_key,
                    bsk=bsk, ksk=ksk)
