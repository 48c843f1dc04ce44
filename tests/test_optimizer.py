import subprocess
import sys
from pathlib import Path

import pytest

from tfhe_fbs_map_tpu.optimizer import (P_ERROR_4_SIGMA, optimize,
                                        p_error_atomic)
from tfhe_fbs_map_tpu.optimizer.optimizer import bootstrap_cost_us
from tfhe_fbs_map_tpu.tfhe.params import (DEFAULT_PARAMS, min_noise_std_rel,
                                          Q)

REPO = Path(__file__).resolve().parents[1]


def test_security_curve_anchors():
    # classic TFHE points: (630, 2^-15), (1024, 2^-25)
    assert abs(min_noise_std_rel(630) / 2 ** -15.4 - 1) < 0.6
    assert abs(min_noise_std_rel(1024) / 2 ** -25.1 - 1) < 0.6


def test_security_curve_pinned_to_published_points():
    """Pin `min_noise_std_rel` against published ~128-bit lattice points so
    a curve regression can't silently trade security for throughput
    (VERDICT r2 weak #4).

    Published (n, relative std) choices at the 128-bit level:
      * TFHE library LWE key: n=630, std 2^-15 of q
      * TFHE library GLWE key: kN=1024, std 2^-25 of q
      * TFHE-rs PARAM_MESSAGE_2_CARRY_2 LWE: n=742, std 7.0698e-6 (~2^-17.1)
      * TFHE-rs PARAM_MESSAGE_2_CARRY_2 GLWE: kN=2048, std 2.9404e-16 (~2^-51.6)

    Two directions:
      1. our floor must ACCEPT each published choice (floor <= published):
         rejecting known-secure parameters would silently inflate cost;
      2. our floor must stay within ~1.5 bits BELOW the two classic points
         that were chosen essentially ON the estimator minimum — a flatter
         curve (e.g. coefficient -0.04) would demand far less noise at the
         same n and lose security.
    """
    published = [(630, 2.0 ** -15), (1024, 2.0 ** -25),
                 (742, 7.069849454709433e-6)]
    for n, std in published:
        assert min_noise_std_rel(n) <= std * 1.05, (n, std)
    # TFHE-rs kN=2048 GLWE (q=2^64, std ~2^-51.6) sits BELOW the q=2^32
    # representability clamp: our floor stays at the clamp, i.e. strictly
    # MORE noise than the estimator minimum requires (the safe direction).
    assert min_noise_std_rel(2048) == 2.0 ** -31 > 2.9403601535432533e-16
    # on-curve anchors (within 1.5 bits, floor strictly below published)
    import math
    for n, std in [(630, 2.0 ** -15), (1024, 2.0 ** -25)]:
        gap_bits = math.log2(std / min_noise_std_rel(n))
        assert 0.0 <= gap_bits <= 1.5, (n, gap_bits)
    # monotone non-increasing until the q=2^32 representability clamp,
    # which only ever RAISES noise (safe direction)
    xs = [min_noise_std_rel(n) for n in range(100, 2100, 100)]
    assert all(a >= b for a, b in zip(xs, xs[1:]))
    assert min_noise_std_rel(4096) == 2.0 ** -31


@pytest.mark.parametrize("p,norm2", [(2, 2), (4, 10), (8, 20), (16, 50)])
def test_optimize_meets_target(p, norm2):
    sol = optimize(p, norm2)
    assert sol is not None, (p, norm2)
    assert sol.p_error <= P_ERROR_4_SIGMA
    assert sol.params.bsk_base_log <= 8  # int8-digit constraint
    # security: noise at or above the 128-bit curve
    assert sol.params.lwe_noise_std >= \
        min_noise_std_rel(sol.params.lwe_dim) * Q * 0.99


def test_cost_monotone_in_precision():
    costs = [optimize(p, 4).cost for p in (2, 8, 32)]
    assert costs[0] <= costs[1] <= costs[2]


def test_higher_norm2_not_cheaper():
    a = optimize(4, 1)
    b = optimize(4, 100)
    assert a is not None and b is not None
    assert b.cost >= a.cost * 0.99


def test_default_params_close_to_model():
    # the hand-picked anchor set must satisfy its own error target at p=4
    pr = DEFAULT_PARAMS
    perr = p_error_atomic(4, 4, pr.lwe_dim, pr.glwe_dim, pr.poly_size,
                          pr.bsk_level, pr.bsk_base_log, pr.ksk_level,
                          pr.ksk_base_log, pr.lwe_noise_std,
                          pr.glwe_noise_std)
    assert perr < 1e-3


def test_bsk_quantization_predicts_r1_rejection():
    """The noise model must *predict* the empirical r1 result: 3-limb BSK
    at the matmul bench anchor (n=630, k=2, N=512, l=2, b=8) produced
    63/512 errors (p_error ≈ 0.123, PERF.md "rejected" row).  With the
    mask-amplified quantization term the model lands on ≈ 0.12; without
    dropped limbs the same parameters are comfortably under target."""
    kw = dict(p=4, sq_norm2=1, n=630, k=2, N=512, br_l=2, br_b=8,
              ks_l=5, ks_b=3, lwe_noise_std=2.0 ** 17,
              glwe_noise_std=2.0 ** 7)
    exact = p_error_atomic(**kw)
    quant = p_error_atomic(**kw, dropped_limbs=1)
    assert exact < P_ERROR_4_SIGMA
    assert quant > P_ERROR_4_SIGMA          # the optimizer must reject it
    assert 0.05 < quant < 0.25, quant       # and land near the observed rate


def test_optimize_quantized_bsk_only_when_safe():
    """optimize() may pick bsk_limbs=3 (cheaper) but only when the modeled
    p_error with the quantization term still meets the target."""
    for p, norm2 in ((2, 1), (4, 4), (8, 16)):
        sol = optimize(p, norm2)
        assert sol is not None
        assert sol.bsk_limbs in (3, 4)
        assert sol.p_error <= P_ERROR_4_SIGMA
        if sol.bsk_limbs == 3:
            pr = sol.params
            full = bootstrap_cost_us(pr.lwe_dim, pr.glwe_dim, pr.poly_size,
                                     pr.bsk_level, pr.ksk_level, 4)
            assert sol.cost < full


def test_cost_model_matches_measured_anchors():
    """The cost model is the H100 int8 roofline computed from shapes:
    n·(k+1)²·l·N²·L blind-rotate MACs plus kN·l_ks·(n+1)·4 key-switch MACs,
    2 ops each, at 1,979 TOP/s — against the accumulator's HBM time."""
    from tfhe_fbs_map_tpu.optimizer.device import H100_SXM
    n, k, N, l, ks_l = 546, 2, 512, 2, 4          # the bench anchor
    macs = n * 9 * l * N * N * 4 + k * N * ks_l * (n + 1) * 4
    want = 2 * macs / H100_SXM["int8_ops"] * 1e6
    assert bootstrap_cost_us(n, k, N, l, ks_l) == pytest.approx(want)
    assert 10.0 < want < 11.0                      # ~10.4 µs per bootstrap
    # quantized BSK: three limbs' blind-rotate MACs
    q = bootstrap_cost_us(n, k, N, l, ks_l, bsk_limbs=3)
    assert q == pytest.approx(want - 2 * n * 9 * l * N * N
                              / H100_SXM["int8_ops"] * 1e6)
    # a tiny ring is bound by the accumulator traffic, not the MACs
    acc_us = 16 * 3 * 2 * 64 * 4 / H100_SXM["hbm_bytes_per_s"] * 1e6
    assert bootstrap_cost_us(16, 1, 64, 1, 1) == pytest.approx(acc_us)


def test_cli_contract():
    res = subprocess.run(
        [sys.executable, "-m", "tfhe_fbs_map_tpu.optimizer",
         "--precision", "9", "--sq-norm2", "14"],
        capture_output=True, text=True, cwd=REPO)
    assert res.returncode == 0, res.stderr
    line = res.stdout.strip().splitlines()[-1]
    # the estimate pipeline parses the 2nd-to-last comma field as cost
    cost = int(line.split(",")[-2].strip())
    assert cost > 0
