"""TFHE parameter optimizer: (precision p, sq_norm2) → (params, cost, p_error).

Drop-in for the role of the patched concrete-optimizer in the reference
pipeline (``experiments/add_exec_estimates.py:9-16`` invokes
``optimizer --precision=<p> --sq-norm2=<norm2>`` and parses the
second-to-last comma field as the bootstrap cost).  Differences by design:

* the cost model is an **H100 roofline** (int8 tensor-core MACs + HBM
  traffic at large ciphertext batch, :mod:`.device`), not a CPU FFT
  model — costs are microseconds per bootstrap at batch saturation;
* security is enforced via the 128-bit curve ``min_noise_std_rel``
  (tfhe/params.py) for both the LWE and GLWE keys;
* candidates are restricted to the int8 fast path by default: gadget
  base_log ≤ 8 (digits must fit int8).

A C++ implementation of the same grid search lives in
``native/optimizer.cpp`` (built via ctypes) for harness-scale sweeps; this
module is the reference implementation and fallback.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..tfhe.params import TFHEParams, min_noise_std_rel, Q
from .noise import P_ERROR_4_SIGMA, p_error_atomic

__all__ = ["Solution", "optimize", "bootstrap_cost_us", "bootstrap_int8_ops",
           "StagedSolution", "optimize_staged"]

from ..tfhe.staged import SELECT_P

from .device import H100_SXM

# roofline constants of one NVIDIA H100 SXM (optimizer/device.py for the
# source; mirrored in native/optimizer.cpp)
INT8_OPS = H100_SXM["int8_ops"]
HBM_BYTES = H100_SXM["hbm_bytes_per_s"]
# generic tfhe/pbs.py path over the int8 fast path, measured in one run at
# the anchor (n=546, k=2, N=512, l=2), batch 512, on an H100 80GB HBM3 at
# 400 W: 1,231.593 vs 67.820 µs per bootstrap (compact keys; PERF.md)
GENERIC_PATH_SLOWDOWN = 1231.593 / 67.820


@dataclass(frozen=True)
class Solution:
    params: TFHEParams
    cost: float                # microseconds per bootstrap (batch-amortized)
    p_error: float
    bsk_limbs: int = 4         # < 4: limb-dropped (quantized) BSK matrices


def bootstrap_int8_ops(n: int, k: int, N: int, br_l: int, ks_l: int,
                       bsk_limbs: int = 4) -> float:
    """int8 tensor-core operations (2 per MAC) of one bootstrap."""
    # blind rotate: n steps of rows·N × (k+1)·N MACs per kept key limb
    br_macs = n * (k + 1) ** 2 * br_l * N * N * bsk_limbs
    # keyswitch: kN·l × (n+1) matmul × 4 limbs
    ks_macs = k * N * ks_l * (n + 1) * 4
    return 2.0 * (br_macs + ks_macs)


def bootstrap_cost_us(n: int, k: int, N: int, br_l: int, ks_l: int,
                      bsk_limbs: int = 4) -> float:
    """Roofline model: µs per bootstrap at large batch.

    The larger of the int8 tensor-core time of the blind rotation and key
    switch and the HBM time of the accumulator traffic.  ``bsk_limbs`` < 4
    (quantized BSK) removes the dropped limbs' MACs.
    """
    compute_s = bootstrap_int8_ops(n, k, N, br_l, ks_l,
                                   bsk_limbs) / INT8_OPS
    # per-ct HBM traffic: ACC read+write+rotate per step (batch >> 1 keeps
    # key streaming amortized)
    acc_bytes = n * 3 * (k + 1) * N * 4
    mem_s = acc_bytes / HBM_BYTES
    return max(compute_s, mem_s) * 1e6


def optimize(p: int, sq_norm2: float,
             max_p_error: float = P_ERROR_4_SIGMA,
             fast_path_only: bool = True,
             security_bits: int = 128) -> Solution | None:
    """Grid-search the cheapest parameter set meeting the error target.

    ``fast_path_only=True`` restricts to the int8 fast path (gadget base
    ≤ 2^8 so digits fit int8); the generic fallback only triggers for
    parameter regimes outside the int8-digit envelope, priced at
    ``GENERIC_PATH_SLOWDOWN`` × the int8 roofline.
    """
    best = _optimize_inner(p, sq_norm2, max_p_error, True)
    if best is None:
        best = _optimize_inner(p, sq_norm2, max_p_error, False)
        if best is not None:
            best = Solution(best.params,
                            best.cost * GENERIC_PATH_SLOWDOWN,
                            best.p_error)
    return best


def _optimize_inner(p: int, sq_norm2: float, max_p_error: float,
                    fast_path_only: bool) -> Solution | None:
    best: Solution | None = None

    glwe_shapes = [(1, 1024), (2, 512), (1, 2048), (2, 1024), (3, 512),
                   (4, 512), (2, 2048), (1, 4096)]
    # int8 digits (the tensor-core fast path) need base ≤ 2^8; the generic
    # gather-based fallback can use wider digits
    max_base = 8 if fast_path_only else 12

    # BSK limb-drop quantization is a fast-path key layout
    # knob: the generic gather path always uses exact keys
    drops = (0, 1) if fast_path_only else (0,)

    for k, N in glwe_shapes:
        if N < 2 * p:        # need at least one poly coeff per half-window
            continue
        glwe_std = min_noise_std_rel(k * N) * Q
        for n in range(450, 1100, 32):
            lwe_std = min_noise_std_rel(n) * Q
            for br_b in range(4, max_base + 1):
                for br_l in range(1, 5):
                    if br_b * br_l > 32:
                        continue
                    for ks_b in range(2, max_base + 1):
                        for ks_l in range(1, 9):
                            if ks_b * ks_l > 32:
                                continue
                            for drop in drops:
                                cost = bootstrap_cost_us(n, k, N, br_l,
                                                         ks_l, 4 - drop)
                                if best is not None and cost >= best.cost:
                                    continue
                                perr = p_error_atomic(
                                    p, sq_norm2, n, k, N, br_l, br_b, ks_l,
                                    ks_b, lwe_std, glwe_std,
                                    dropped_limbs=drop)
                                if perr > max_p_error:
                                    continue
                                params = TFHEParams(
                                    p=p, lwe_dim=n, glwe_dim=k, poly_size=N,
                                    bsk_level=br_l, bsk_base_log=br_b,
                                    ksk_level=ks_l, ksk_base_log=ks_b,
                                    lwe_noise_std=lwe_std,
                                    glwe_noise_std=glwe_std)
                                best = Solution(params, cost, perr, 4 - drop)
    return best


@dataclass(frozen=True)
class StagedSolution:
    """Joint parameter pick for the staged multi-digit bootstrap
    (tfhe/staged.py): two families sharing n and the extracted dimension."""

    params1: TFHEParams        # stage-1 family (p//2 or p grid)
    params2: TFHEParams        # stage-2 family (p field = 8)
    cost: float                # total microseconds per staged bootstrap
    p_error: float             # sum of the two stage error probabilities


def optimize_staged(p: int, sq_norm1: float = 4.0, sq_norm2: float = 2.0,
                    max_p_error: float = P_ERROR_4_SIGMA,
                    big_dim: int = 1024,
                    wires_from_stage2: bool = True,
                    weight1: float = 1.0,
                    weight2: float = 1.0) -> StagedSolution | None:
    """Cheapest staged-pipeline parameters for a size-p node.

    ``weight1``/``weight2``: per-family boot counts of the target program
    (runtime/executor.py routing mix) — the objective is the
    whole-program cost ``w1*cost1 + w2*cost2``, so a mostly-select-family
    program optimizes the select family hardest.  ``Solution.cost`` is
    that weighted objective.

    Default norms assume scaled wire encodings (every wire pre-scaled to
    its consumer coefficient: stage-1 eats |A| unit-multiplier wires,
    stage-2 eats G plus |B| unit-multiplier wires).  The two families
    share the small LWE dimension n and the extracted key dimension
    ``big_dim`` (one master GLWE secret), so the search is joint.  Each
    stage must meet ``max_p_error`` on its own (same contract as the
    reference pipeline's per-bootstrap `_4_SIGMA`).
    """
    from .noise import (p_error_from_var, var_blind_rotate, var_keyswitch,
                        var_modswitch)
    if p % 2 or p < 8:
        return None
    # fam1 grid: p/2 when two-stage splits apply (p >= 32); the p grid
    # itself for p <= 16, where fam1 is the catch-all single-boot family
    # and fam2 still takes the small tables (runtime/executor.py routing)
    stage1_p = p // 2 if p >= 2 * SELECT_P * 2 else p
    # select-family grid: SELECT_P when commensurable with the wire grid,
    # else p/2 (runtime/executor.py routing; splits need SELECT_P exactly)
    select_p = SELECT_P if p % SELECT_P == 0 else p // 2
    # k restricted to {1, 2}: the GLWE shapes (1,1024)/(2,512)/(1,2048)/
    # (2,1024) the staged executor is tested at
    shapes = [(k, big_dim // k) for k in (1, 2)
              if big_dim % k == 0 and big_dim // k >= 2 * select_p]

    def candidates(n: int, min_N: int) -> list:
        """(cost, v_wire, ks_var, ms_var, k, N, bl, bb, kl, kb), cost-sorted.

        Per-(k,N,bl,kl) cost cell, only the noise-minimal (bb, kb) matter:
        keep the best v_wire per (k,N,bl) x bb and best ks_var per (kl,kb)."""
        lwe_std = min_noise_std_rel(n) * Q
        out = []
        for k, N in shapes:
            if N < min_N:
                continue
            g = min_noise_std_rel(k * N) * Q
            ms = var_modswitch(n, N)
            ks_best = {}
            for kb in range(2, 9):
                for kl in range(1, 9):
                    if kb * kl > 32:
                        continue
                    v = var_keyswitch(k, N, kl, kb, lwe_std)
                    if kl not in ks_best or v < ks_best[kl][0]:
                        ks_best[kl] = (v, kb)
            for bb in range(4, 9):
                for bl in range(1, 6):
                    vw = var_blind_rotate(n, k, N, bl, bb, g)
                    for kl, (ksv, kb) in ks_best.items():
                        out.append((bootstrap_cost_us(n, k, N, bl, kl),
                                    vw, ksv, ms, k, N, bl, bb, kl, kb))
        out.sort(key=lambda t: t[0])
        return out

    best: StagedSolution | None = None
    for n in range(450, 1100, 32):
        lwe_std = min_noise_std_rel(n) * Q
        c2s = candidates(n, 2 * select_p)
        c1s = candidates(n, 2 * stage1_p)
        if not c2s or not c1s:
            continue
        min_c1 = c1s[0][0]
        for cost2, v2, ks2, ms2, k2, N2, bl2, bb2, kl2, kb2 in c2s:
            if best is not None \
                    and weight2 * cost2 + weight1 * min_c1 >= best.cost:
                break
            for cost1, v1, ks1, ms1, k1, N1, bl1, bb1, kl1, kb1 in c1s:
                tot = weight1 * cost1 + weight2 * cost2
                if best is not None and tot >= best.cost:
                    break
                # In the all-staged regime every circuit wire is a stage-2
                # output, so wire variance is v2; a mixed executor passes
                # wires_from_stage2=False for the conservative bound.
                vw = v2 if wires_from_stage2 else max(v1, v2)
                e1 = p_error_from_var(stage1_p,
                                      sq_norm1 * vw + ks1 + ms1)
                if e1 > max_p_error:
                    continue
                e2 = p_error_from_var(select_p,
                                      v1 + sq_norm2 * vw + ks2 + ms2)
                if e2 > max_p_error:
                    continue
                pr1 = TFHEParams(p=stage1_p, lwe_dim=n, glwe_dim=k1,
                                 poly_size=N1, bsk_level=bl1, bsk_base_log=bb1,
                                 ksk_level=kl1, ksk_base_log=kb1,
                                 lwe_noise_std=lwe_std,
                                 glwe_noise_std=min_noise_std_rel(k1 * N1) * Q)
                pr2 = TFHEParams(p=select_p, lwe_dim=n, glwe_dim=k2,
                                 poly_size=N2, bsk_level=bl2, bsk_base_log=bb2,
                                 ksk_level=kl2, ksk_base_log=kb2,
                                 lwe_noise_std=lwe_std,
                                 glwe_noise_std=min_noise_std_rel(k2 * N2) * Q)
                best = StagedSolution(pr1, pr2, tot, e1 + e2)
                break       # c1s is cost-sorted: first feasible is best here
    return best


def format_solution_line(sol: Solution) -> str:
    """Concrete-optimizer-compatible output row: the estimate pipeline
    parses ``split(',')[-2]`` as the cost (add_exec_estimates.py:14-16)."""
    pr = sol.params
    return (f"  {pr.glwe_dim}, {pr.poly_size}, {pr.lwe_dim}, "
            f"{pr.bsk_level},{pr.bsk_base_log}, "
            f"{pr.ksk_level},{pr.ksk_base_log}, "
            f"{int(round(sol.cost))}, {sol.p_error:.1e}")
