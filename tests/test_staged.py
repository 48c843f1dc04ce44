"""Staged (multi-digit) functional bootstrap: correctness on CPU.

Exhaustively checks the two-stage pipeline (tfhe/staged.py) against
cleartext table lookup for every reachable lincomb value, including the
negacyclic mode-C tables (length > p) the mapper emits — the staged path
must be a drop-in for the native size-p bootstrap it replaces."""

import numpy as np
import pytest

from tfhe_fbs_map_tpu.tfhe.encrypt import lwe_phase
from tfhe_fbs_map_tpu.tfhe.params import Q, TFHEParams
from tfhe_fbs_map_tpu.tfhe.staged import (StagedKeys, encrypt_wires,
                                          generate_staged_keys, split_node,
                                          staged_functional_bootstrap)

# Tiny, insecure families for exhaustive CPU checks: shared kN = 256, n = 16.
P32_F1 = TFHEParams(p=16, lwe_dim=16, glwe_dim=1, poly_size=256,
                    bsk_level=3, bsk_base_log=7, ksk_level=4, ksk_base_log=4,
                    lwe_noise_std=2.0, glwe_noise_std=2.0)
P32_F2 = TFHEParams(p=8, lwe_dim=16, glwe_dim=2, poly_size=128,
                    bsk_level=3, bsk_base_log=7, ksk_level=4, ksk_base_log=4,
                    lwe_noise_std=2.0, glwe_noise_std=2.0)


@pytest.fixture(scope="module")
def skeys32() -> StagedKeys:
    return generate_staged_keys(32, P32_F1, P32_F2, seed=7)


def decode_bits(skeys: StagedKeys, out, expect_len: int) -> np.ndarray:
    """Decode stage-2 outputs at the global wire delta, mod 2p."""
    params = skeys.wire_params
    phases = np.asarray(lwe_phase(skeys.extracted_key, out))
    u = phases.astype(np.uint32).astype(np.float64)
    vals = np.round(u / params.delta).astype(np.int64) % (2 * params.p)
    assert vals.shape == (expect_len,)
    return vals


def run_exhaustive(skeys, coefs, const, table, rng):
    """All input bit combinations; compare staged output to the table."""
    p = skeys.p
    split = split_node(coefs, const, table, p)
    assert split is not None, (coefs, const, len(table))
    t = len(coefs)
    combos = np.array([[(j >> i) & 1 for j in range(2 ** t)]
                       for i in range(t)])         # [T, 2^t]
    x = np.asarray(coefs) @ combos + const
    assert x.max() < len(table)
    cts = np.stack([np.asarray(encrypt_wires(skeys, combos[i], rng))
                    for i in range(t)])            # [T, B, kN+1]
    import jax.numpy as jnp
    out = staged_functional_bootstrap(skeys, split, jnp.asarray(cts), coefs)
    got = decode_bits(skeys, out, 2 ** t)
    want = np.asarray(table)[x] % (2 * p)
    np.testing.assert_array_equal(got, want)


def test_split_address_case():
    s = split_node([1, 2, 4, 8, 16], 0, [0, 1] * 16, 32)
    assert s is not None and s.m == 16
    assert s.a_idx == (0, 1, 2, 3) and s.b_idx == (4,)
    assert s.h_max == 1 and len(s.t1) == 16 and len(s.t2) == 8


def test_split_negacyclic_case():
    table = [0, 1, 1, 0] * 8 + [1, 0, 0, 1] * 8   # tau=64, C=1
    s = split_node([1, 2, 4, 8, 16, 32], 0, table, 32)
    assert s is not None and s.h_max == 3 and len(s.t2) == 16
    # stage-2 table is itself a valid length-16 negacyclic table at p=8
    assert all(s.t2[z] + s.t2[z + 8] == 1 for z in range(8))


def test_split_rejections():
    assert split_node([1] * 31, 0, [0, 1] * 16, 32) is None   # no 16| coefs
    assert split_node([1, 2, 4], 0, [0, 1] * 4, 7) is None    # odd p
    # negative coef whose min-shift (s ≡ 0 mod 16 ⇒ s = 16) overflows x_lo
    assert split_node([1, -2, 16], 0, [0, 1] * 16, 32) is None
    assert split_node([1, 2], 0, [0, 1, 1, 0], 32) is None    # single branch
    assert split_node([1, 2, 4, 8], 0, [0, 1, 0, 1], 32) is None  # h_max = 0
    # negative const: the w=0 corner forces a negative branch index
    assert split_node([1, 2, 16], -3, [0, 1] * 16, 32) is None


def test_split_negative_coef_min_shift():
    # x = 3a - 2b + 16c + 4 ∈ [2, 23]: shift s = 4 keeps x_lo in [2, 7]
    s = split_node([3, -2, 16], 4, [0, 1] * 12, 32)
    assert s is not None
    assert s.a_idx == (0, 1) and s.b_idx == (2,)
    assert s.const_lo == 4 and s.const_hi == 0 and s.h_max == 1
    # negative coef absorbed by the mod-m residue, branches ≥ 2 via the
    # negacyclic C: x = a - 3b + 16c + 19 reaches 36 > p
    table = [0, 1] * 16 + [1, 0] * 16                 # tau = 64, C = 1
    s = split_node([1, -3, 16], 19, table, 32)
    assert s is not None
    assert s.const_lo == 3 and s.const_hi == 1 and s.h_max == 2


def test_split_wire_bounds():
    # multi-valued wire (bound 2): 3*2 + 16 = 22 fits; binary assumption
    # (bound 1) also splits, but with the tighter lo_max
    s = split_node([3, 16], 0, [0, 1] * 12, 32, bounds=[2, 1])
    assert s is not None and len(s.t1) == 7
    # bound pushing x_lo over the digit is rejected
    assert split_node([9, 16], 0, [0, 1] * 16, 32, bounds=[2, 1]) is None


def test_split_const_folding():
    # const 17 -> const_lo 1, const_hi 1; x reaches 40 so tau = 48 with C
    table = [0, 1] * 16 + [1, 0] * 8                  # C = 1
    s = split_node([1, 2, 4, 16], 17, table, 32)
    assert s is not None and s.const_lo == 1 and s.const_hi == 1
    assert s.h_max == 2
    assert len(s.t2) == 12


def test_staged_address_lut(skeys32):
    rng = np.random.default_rng(3)
    table = rng.integers(0, 2, 32).tolist()
    run_exhaustive(skeys32, [1, 2, 4, 8, 16], 0, table, rng)


def test_staged_negacyclic_lut(skeys32):
    rng = np.random.default_rng(4)
    half = rng.integers(0, 2, 32)
    table = half.tolist() + (1 - half).tolist()        # tau=64, C=1
    run_exhaustive(skeys32, [1, 2, 4, 8, 16, 32], 0, table, rng)
    # C = 2 variant: table[x+32] = 2 - table[x] needs table[x] == 1 there
    table2 = [1] * 32 + [1] * 16
    s = split_node([1, 2, 4, 8, 16, 32], 0, table2, 32)
    assert s is not None


def test_staged_irregular_coefs(skeys32):
    rng = np.random.default_rng(5)
    table = rng.integers(0, 2, 28).tolist()
    run_exhaustive(skeys32, [3, 5, 16], 2, table, rng)  # A={3,5}, B={16}


def test_staged_const_hi(skeys32):
    rng = np.random.default_rng(6)
    table = rng.integers(0, 2, 32).tolist()
    table += [1 - t for t in table[:16]]               # tau=48, C=1
    run_exhaustive(skeys32, [1, 2, 4, 16], 17, table, rng)


def test_staged_negative_coefs(skeys32):
    # x = 3a - 2b + 16c + 4: the min-shift puts x_lo = 3a - 2b + 4 in
    # [2, 7]; end-to-end two-stage result must equal table[x]
    rng = np.random.default_rng(11)
    table = rng.integers(0, 2, 24).tolist()
    run_exhaustive(skeys32, [3, -2, 16], 4, table, rng)


def test_optimize_staged_beats_native_p32():
    from tfhe_fbs_map_tpu.optimizer.optimizer import optimize, optimize_staged
    staged = optimize_staged(32, sq_norm1=4.0, sq_norm2=2.0)
    assert staged is not None
    assert staged.params1.big_dim == staged.params2.big_dim
    assert staged.params1.lwe_dim == staged.params2.lwe_dim
    assert staged.params1.p == 16 and staged.params2.p == 8
    native = optimize(32, 2.0)
    assert native is not None
    assert staged.cost < 0.5 * native.cost   # the point of the exercise
    from tfhe_fbs_map_tpu.optimizer.noise import P_ERROR_4_SIGMA
    assert staged.p_error <= 2 * P_ERROR_4_SIGMA


def test_optimize_staged_f1_wire_variance():
    """r4 regression: wires produced by f1 *singles* carry fam1's
    fresh-bootstrap variance, not fam2's.  With the all-split default
    (``wires_from_stage2=True``) the Kreyvium-1152 probe mix (8754 f1
    singles, eff norms 27/25) picked an l=2/b=8 fam1 whose true stage-1
    error was 0.22/boot (9529/23040 wrong output bits in a run);
    the conservative flag must yield a self-consistent parameter set."""
    from tfhe_fbs_map_tpu.optimizer.noise import (P_ERROR_4_SIGMA,
                                                  staged_p_errors)
    from tfhe_fbs_map_tpu.optimizer.optimizer import optimize_staged

    def errors(sol, wfs2):
        p1, p2 = sol.params1, sol.params2
        return staged_p_errors(
            10, 27.0, 25.0, p1.lwe_dim, p1.glwe_dim, p1.poly_size,
            p1.bsk_level, p1.bsk_base_log, p1.ksk_level, p1.ksk_base_log,
            p2.glwe_dim, p2.poly_size, p2.bsk_level, p2.bsk_base_log,
            p2.ksk_level, p2.ksk_base_log, p1.lwe_noise_std,
            p1.glwe_noise_std, p2.glwe_noise_std, wires_from_stage2=wfs2)

    loose = optimize_staged(10, 27.0, 25.0, weight1=8754, weight2=93,
                            wires_from_stage2=True)
    tight = optimize_staged(10, 27.0, 25.0, weight1=8754, weight2=93,
                            wires_from_stage2=False)
    assert loose is not None and tight is not None
    # the bug class: the all-split bound accepts parameters that blow up
    # under the true (f1-single) wire variance ...
    assert max(errors(loose, False)) > 100 * P_ERROR_4_SIGMA
    # ... while the conservative flag is self-consistent under it
    e1, e2 = errors(tight, False)
    assert e1 <= P_ERROR_4_SIGMA and e2 <= P_ERROR_4_SIGMA


def test_out_delta_scaling(skeys32):
    """A bootstrap can emit T[x]*c*delta at no extra noise (scaled wires)."""
    rng = np.random.default_rng(8)
    table = rng.integers(0, 2, 32).tolist()
    split = split_node([1, 2, 4, 8, 16], 0, table, 32)
    combos = np.array([[(j >> i) & 1 for j in range(32)] for i in range(5)])
    x = np.asarray([1, 2, 4, 8, 16]) @ combos
    import jax.numpy as jnp
    cts = jnp.asarray(np.stack(
        [np.asarray(encrypt_wires(skeys32, combos[i], rng))
         for i in range(5)]))
    delta_w = skeys32.wire_params.delta
    out = staged_functional_bootstrap(skeys32, split, cts, [1, 2, 4, 8, 16],
                                      out_delta=6 * delta_w)
    got = decode_bits(skeys32, out, 32)
    want = (np.asarray(table)[x] * 6) % 64
    np.testing.assert_array_equal(got, want)
