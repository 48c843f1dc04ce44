"""Staged (multi-digit / tree) functional bootstrap for large FBS sizes.

A size-p FBS must resolve the q/(2p) input grid against modulus-switch
noise, which forces ``N >= 64*p`` (the half-cell rule) — p = 32 lands on
N = 2048 and a ~1.5 ms blind rotation.  This module evaluates the same
size-p node as TWO small bootstraps instead (the lincomb-structured
adaptation of tree-based PBS, Guimarães-Borin-Aranha 2021):

* the mapper-known lincomb ``x = sum c_i w_i + k0`` is split as
  ``x = x_lo + m*x_hi`` with ``m = p/2``: inputs whose coefficient is not
  divisible by m form ``x_lo`` (required ``max(x_lo) < m``), the rest form
  the branch index ``x_hi = sum (c_i/m) w_i + k0//m`` in [0, 4);
* **stage 1** re-grids ``x_lo`` onto q/(2m) = q/p (a size-m FBS, so N can
  halve) and emits the PACKED 2-bit value ``G = f(x_lo) + 2 f(x_lo + m)``
  on the stage-2 grid — multi-valued output is free, the test vector
  carries no noise;
* **stage 2** selects the branch: a size-8 FBS of
  ``z = G + 4*x_hi in [0, 16)`` whose table reads bit ``x_hi & 1`` of G
  for branches 0-1 and — exactly the negacyclic mode-C structure the
  mapper already enforces for tables longer than p (reference
  ``fbs_mapper/map_to_fbs.py:81-98``) — ``C - bit`` for branches 2-3,
  making the select table itself a valid length-16 negacyclic table at
  p = 8.

Both stages run at N <= 1024 where the single big bootstrap needs
N = 2048, so a size-32 lookup costs fewer int8 MACs than the native one
(``optimizer.bootstrap_cost_us`` of the two families vs the N = 2048 one).  The two parameter families share one master GLWE
secret (viewed as (k1, N1) and (k2, N2) polynomials with k1*N1 == k2*N2)
and one small LWE key: ``TFHEKeys.extracted_key`` is the flattened master
in natural order under BOTH views, so wires produced by either family
live under the same big LWE key and mix freely in lincombs.

Security note: the master secret is used under two ring structures
(standard circular-security-style assumption, same flavour TFHE already
makes by encrypting the bootstrap chain's keys under each other).

Noise contract: stage margins are q/(4m) and q/32; both stages are scored
by ``optimizer.noise.staged_p_errors`` and parameter sets are picked by
``optimizer.optimize_staged`` — see those modules for the exact budget.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from .encrypt import lwe_encrypt, encode
from .keys import TFHEKeys, generate_keys
from .numeric import I32
from .params import Q, TFHEParams

__all__ = ["StagedSplit", "split_node", "StagedKeys", "generate_staged_keys",
           "staged_tvs", "staged_functional_bootstrap", "encrypt_wires",
           "SELECT_P"]

# Stage-2 (branch select) always runs on the p=8 grid: z = G + 4*x_hi with
# G in [0,4) and x_hi in [0,4) spans [0,16) = one negacyclic length-16 table.
SELECT_P = 8


# ---------------------------------------------------------------------------
# Split detection (host-side, mapping/compile time)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StagedSplit:
    """Compile-time description of one staged size-p node."""

    p: int                     # original FBS size
    m: int                     # digit modulus = p // 2 (stage-1 FBS size)
    a_idx: tuple[int, ...]     # term indices feeding stage-1 (x_lo)
    b_idx: tuple[int, ...]     # term indices feeding stage-2 (x_hi)
    const_lo: int              # k0 % m (stage-1 constant, x_lo units)
    const_hi: int              # k0 // m (stage-2 constant, branch units)
    h_max: int                 # max branch index reached
    t1: tuple[int, ...]        # stage-1 packed table, values in [0, 4)
    t2: tuple[int, ...]        # stage-2 select table (negacyclic at p=8)


def split_node(coefs, const: int, table, p: int,
               bounds=None) -> StagedSplit | None:
    """Try to split a size-p bootstrap node; None -> run it natively.

    Requirements: p even and >= 8, binary table, and the
    non-multiples-of-m part of the lincomb must fit one digit [0, m).

    ``bounds``: per-term wire value upper bounds (default binary wires).
    Negative coefficients and constants are handled by the min-shift: the
    digit constant ``s ≡ const (mod m)`` is chosen so ``x_lo`` stays in
    [0, m) over the wire box, with the remaining ``(const - s)/m``
    absorbed by the branch index (r5; the r4 implementation rejected any
    negative coefficient, VERDICT r4 item 6).

    Why tables stay binary here: packing a V-valued pair needs
    ``G = f(x_lo) + V·f(x_lo+m) < V²`` and the select input
    ``z = G + V²·x_hi`` rides the wire grid only when the select family's
    grid satisfies ``p2 = 2·V²`` (the q/(2p) wire encoding contributes
    branch steps of q/4).  The family system has p2 = 8 ⇒ V = 2; the next
    square, V = 4 ⇒ p2 = 32, needs an N ≥ 2048 select family — the very
    cost the staged pipeline exists to avoid.  Multi-valued tables route
    to the single-family paths instead (``runtime/executor.py``
    ``can_single``).
    """
    coefs = [int(c) for c in coefs]
    table = [int(t) for t in table]
    const = int(const)
    if p % 2 or p < 8:
        return None
    m = p // 2
    tau = len(table)
    if tau > 2 * p or not table:
        return None
    if any(t not in (0, 1) for t in table):
        return None                       # binary tables only (see above)
    if bounds is None:
        bounds = [1] * len(coefs)
    bounds = [int(b) for b in bounds]
    a_idx = tuple(i for i, c in enumerate(coefs) if c % m)
    b_idx = tuple(i for i, c in enumerate(coefs) if not c % m)
    # x_lo term range over the wire box [0, bound] per wire
    lo_min = sum(min(0, coefs[i] * bounds[i]) for i in a_idx)
    lo_span = sum(max(0, coefs[i] * bounds[i]) for i in a_idx) - lo_min
    # min-shift: s ≡ const (mod m), smallest s with lo_min + s >= 0
    s = const % m
    if lo_min + s < 0:
        s += m * ((-(lo_min + s) + m - 1) // m)
    if lo_span + lo_min + s >= m:
        return None                       # x_lo would overflow the digit
    const_lo, const_hi = s, (const - s) // m
    lo_max = lo_span + lo_min + s
    h_min = sum(min(0, (coefs[i] // m) * bounds[i]) for i in b_idx) \
        + const_hi
    if h_min < 0:
        return None                       # branch index would go negative
    h_max = sum(max(0, (coefs[i] // m) * bounds[i]) for i in b_idx) \
        + const_hi
    if h_max < 1:
        return None                       # single branch: native (smaller p)
    if h_max > 3:
        return None                       # x beyond 2p: invalid node anyway
    c_neg = None
    if tau > p:
        c_neg = table[0] + table[p]
        if any(table[x] + table[x + p] != c_neg for x in range(tau - p)):
            return None                   # not negacyclic: native will raise
    if h_max >= 2 and c_neg is None:
        return None                       # branches 2-3 unreachable via C

    def f_ext(j: int) -> int:
        if j < tau:
            return table[j]
        if c_neg is not None and 0 <= j - p < tau:
            return c_neg - table[j - p]
        return table[tau - 1]             # unreachable: any in-range value

    t1 = tuple(f_ext(v) + 2 * f_ext(v + m) for v in range(lo_max + 1))
    t2 = []
    for z in range(4 * (h_max + 1)):
        g, h = z & 3, z >> 2
        base = g & 1 if h % 2 == 0 else (g >> 1) & 1
        t2.append(base if h < 2 else c_neg - base)
    return StagedSplit(p=p, m=m, a_idx=a_idx, b_idx=b_idx,
                       const_lo=const_lo, const_hi=const_hi, h_max=h_max,
                       t1=t1, t2=tuple(t2))


# ---------------------------------------------------------------------------
# Dual-family keys over one master secret
# ---------------------------------------------------------------------------

@dataclass
class StagedKeys:
    """Two TFHE families sharing extracted big key and small LWE key.

    ``keys1.params.p`` is the stage-1 FBS size m = p//2; ``keys2.params.p``
    is :data:`SELECT_P`.  ``p`` is the original (wire-level) FBS size: wires
    are encoded at the global ``delta_w = q / (2p)``.
    """

    p: int
    keys1: TFHEKeys
    keys2: TFHEKeys

    @property
    def wire_params(self) -> TFHEParams:
        """Params view for wire-level encode/decrypt (global grid)."""
        return self.keys1.params.with_p(self.p)

    @property
    def extracted_key(self) -> jnp.ndarray:
        return self.keys1.extracted_key


def generate_staged_keys(p: int, params1: TFHEParams, params2: TFHEParams,
                         seed: int = 0) -> StagedKeys:
    assert params1.big_dim == params2.big_dim, \
        "families must share the extracted key dimension"
    assert params1.lwe_dim == params2.lwe_dim, \
        "families must share the small LWE key"
    # fam1 on the p/2 grid enables two-stage splits (the p=32 design);
    # fam1 on the p grid covers every mapper-emitted table as one boot
    # while fam2 still takes the small ones (the p<=16 design).  fam2's
    # grid must be commensurable with the q/2p wire grid: p2 | p (the
    # select constant SELECT_P=8 when 8 | p, else p/2 — splits are only
    # wired for the SELECT_P grid).
    assert params1.p in (p // 2, p)
    assert params2.p == SELECT_P or p % params2.p == 0
    rng = np.random.default_rng(seed)
    master = rng.integers(0, 2, params1.big_dim, dtype=np.int64) \
        .astype(np.int32)
    lwe = rng.integers(0, 2, params1.lwe_dim, dtype=np.int64) \
        .astype(np.int32)
    keys1 = generate_keys(params1, rng=rng, lwe_key=lwe,
                          glwe_key=master.reshape(params1.glwe_dim, -1))
    keys2 = generate_keys(params2, rng=rng, lwe_key=lwe,
                          glwe_key=master.reshape(params2.glwe_dim, -1))
    return StagedKeys(p=p, keys1=keys1, keys2=keys2)


# ---------------------------------------------------------------------------
# Composition (generic exact path; the executor drives the fast kernels
# through the same two build_test_vector calls)
# ---------------------------------------------------------------------------

def staged_tvs(split: StagedSplit, skeys: StagedKeys,
               out_delta: int | None = None):
    """((tv1, post1), (tv2, post2)) for the two stages.

    Stage-1 emits G on the stage-2 grid (out_delta = q/16); stage-2 emits
    the final bit at ``out_delta`` (default: the global wire delta).
    """
    from .pbs import build_test_vector
    delta2 = skeys.keys2.params.delta          # q / 16
    if out_delta is None:
        out_delta = skeys.wire_params.delta    # q / (2p)
    tv1 = build_test_vector(split.t1, skeys.keys1.params, out_delta=delta2)
    tv2 = build_test_vector(split.t2, skeys.keys2.params, out_delta=out_delta)
    return tv1, tv2


def staged_functional_bootstrap(skeys: StagedKeys, split: StagedSplit,
                                cts: jnp.ndarray, coefs,
                                out_delta: int | None = None,
                                fast1=None, fast2=None) -> jnp.ndarray:
    """Evaluate one staged node on a batch.

    ``cts`` [T, B, kN+1]: the node's input wires at the global wire delta
    q/(2p); ``coefs`` the original lincomb coefficients.  Returns
    [B, kN+1] encrypting ``table[x]`` at ``out_delta``.

    ``fast1`` / ``fast2``: optional :class:`ops.blind_rotate.FastKeys` for
    the two families — when given, both stages run the MXU fast path.
    """
    from .pbs import functional_bootstrap
    coefs = [int(c) for c in coefs]
    batch = cts.shape[1]
    (tv1, post1), (tv2, post2) = staged_tvs(split, skeys, out_delta)

    def run(fast, keys, ct, tv, post):
        tvs = jnp.broadcast_to(jnp.asarray(tv),
                               (batch, keys.params.poly_size))
        posts = jnp.full((batch,), np.int32(post))
        if fast is not None:
            from ..ops.blind_rotate import functional_bootstrap_fast
            return functional_bootstrap_fast(fast, ct, tvs, posts)
        return functional_bootstrap(keys, ct, tvs, posts)

    # stage 1: x_lo re-gridded to q/p (multiplier 2c_i on q/(2p) wires)
    delta1 = skeys.keys1.params.delta          # q / p
    c1 = jnp.asarray([2 * coefs[i] for i in split.a_idx], dtype=I32)
    lin1 = jnp.einsum("t,tbd->bd", c1, cts[jnp.asarray(split.a_idx)],
                      preferred_element_type=I32) if split.a_idx else \
        jnp.zeros((batch, cts.shape[-1]), dtype=I32)
    k1 = np.int64(split.const_lo * delta1).astype(np.uint32).astype(np.int32)
    lin1 = lin1.at[:, -1].add(jnp.asarray(k1))
    g_ct = run(fast1, skeys.keys1, lin1, tv1, post1)

    # stage 2: z = G + 4*x_hi on the q/16 grid (multiplier c_i: (c_i/m)*m)
    c2 = jnp.asarray([coefs[i] for i in split.b_idx], dtype=I32)
    lin2 = g_ct
    if split.b_idx:
        lin2 = lin2 + jnp.einsum("t,tbd->bd", c2, cts[jnp.asarray(split.b_idx)],
                                 preferred_element_type=I32)
    delta2 = skeys.keys2.params.delta          # q / 16
    k2 = np.int64(4 * split.const_hi * delta2).astype(np.uint32) \
        .astype(np.int32)
    lin2 = lin2.at[:, -1].add(jnp.asarray(k2))
    return run(fast2, skeys.keys2, lin2, tv2, post2)


def encrypt_wires(skeys: StagedKeys, values, rng: np.random.Generator,
                  scale: int = 1) -> jnp.ndarray:
    """Encrypt wire values at ``scale * delta_w`` under the shared big key."""
    params = skeys.wire_params
    mus = encode(np.asarray(values) * scale, params)
    return lwe_encrypt(skeys.extracted_key, mus,
                       params.glwe_noise_std, rng)
