"""Launch-aware program-level runtime predictor.

The per-boot roofline (:func:`optimizer.bootstrap_cost_us`) prices
kernel-batch saturation but ignores three program-level terms (PERF.md
lesson 21: two plans at equal modeled per-boot cost can differ several-fold
end to end, all of it program-level):

* **per-level-call fixed cost** — one jitted level step is one dispatch,
  then ``n`` scan steps whose kernel launches and key traffic (the
  streamed key matrices, or their per-step Toeplitz rebuild on the compact
  path) do not scale with batch;
* **level padding** — per-level bootstrap counts are bucketed to powers of
  two so level shapes share compiled kernels
  (``runtime/executor.py``);
* **two calls per level** for the staged dual-family pipeline.

:func:`predict_native_us` / :func:`predict_staged_us` price a whole
program at a given evaluation batch; the runtime CLI routes
staged-vs-native on this prediction (``runtime/cli.py``).  Constants can
be fitted on the card by ``experiments/calibrate_runtime.py``, which
writes ``optimizer/calibration.json``; without that file the defaults
below apply.

Role in the reference pipeline: the reference's estimate contract is
``(precision, sq_norm2) → cost`` per bootstrap
(``/root/reference/experiments/add_exec_estimates.py:9-16``); this module
is the program-level extension that makes the estimate trustworthy as a
*routing decision*, not only as a per-boot readout.
"""

from __future__ import annotations

import json
from pathlib import Path

from ..ops.blind_rotate import key_bytes, pick_orientation
from ..tfhe.params import TFHEParams
from .device import H100_SXM
from .optimizer import (HBM_BYTES, Solution, StagedSolution,
                        bootstrap_cost_us)

__all__ = ["predict_native_us", "predict_staged_us", "call_fixed_us",
           "slope_us", "load_calibration", "bucket"]

# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

_CAL_PATH = Path(__file__).with_name("calibration.json")

# Defaults when calibration.json has no entry, from the path timings on
# one H100 80GB HBM3 at a 400 W power limit (PERF.md, PR 1):
# * the fixed cost of one blind-rotate scan step besides its key traffic
#   (kernel launches and small fusions): anchor, batch 8, matmul keys,
#   19.089 ms per call over 546 steps less 3 key passes at HBM peak;
# * the rate at which XLA's Toeplitz rebuild fusion writes a compact-key
#   step's matrix (1.02, 1.05 and 0.88 TB/s at N = 512, 1024, 2048).
# Host dispatch of the level step is not measured apart; it is folded
# into the per-step term.
DEFAULT_STEP_US = 18.1
REBUILD_BYTES_PER_S = 1.0e12

# device memory JAX hands the program (its default 75% preallocation)
MODEL_MEMORY_BYTES = 0.75 * H100_SXM["memory_bytes"]


def load_calibration() -> dict:
    if _CAL_PATH.is_file():
        with open(_CAL_PATH) as f:
            return json.load(f)
    return {}


_CAL = load_calibration()


def _fam_key(params: TFHEParams) -> str:
    return f"{params.glwe_dim},{params.poly_size},{params.bsk_level}"


def bucket(nb: int) -> int:
    """Power-of-two level padding (``CircuitExecutor`` shape bucketing)."""
    b = 1
    while b < nb:
        b *= 2
    return b


def call_fixed_us(params: TFHEParams, rows: int,
                  orientation: str | None = None) -> float:
    """Fixed (batch-independent) cost of one level's bootstrap call, µs.

    ``rows`` (the kernel batch) does not enter: the fixed work is ``n``
    scan steps, each with its launches and one step's key matrix of
    traffic — sliced out of the stacked keys (a copy) and read by the GEMM
    on the matmul path, rebuilt by the Toeplitz fusion and read by the
    GEMM on the compact path.
    """
    del rows
    if orientation is None:
        orientation = pick_orientation([params], "gpu", MODEL_MEMORY_BYTES)
    dispatch = float(_CAL.get("dispatch_us", 0.0))
    step = float(_CAL.get("step_us", DEFAULT_STEP_US))
    mat = key_bytes(params, "matmul")
    traffic_s = 3 * mat / HBM_BYTES if orientation == "matmul" \
        else mat / REBUILD_BYTES_PER_S + mat / HBM_BYTES
    return dispatch + params.lwe_dim * step + traffic_s * 1e6


def slope_us(params: TFHEParams, cost_us: float | None = None) -> float:
    """Per-boot marginal cost (µs): the roofline estimate scaled by the
    family's measured calibration factor when one exists."""
    if cost_us is None:
        cost_us = bootstrap_cost_us(params.lwe_dim, params.glwe_dim,
                                    params.poly_size, params.bsk_level,
                                    params.ksk_level)
    cal = _CAL.get("families", {}).get(_fam_key(params))
    if cal is not None and "slope_scale" in cal:
        return cost_us * float(cal["slope_scale"])
    return cost_us


def predict_native_us(sol: Solution, level_nbs: list[int],
                      batch: int) -> float:
    """Per-evaluation runtime (µs) of the native single-family plan."""
    s = slope_us(sol.params, sol.cost)
    total = 0.0
    for nb in level_nbs:
        nbp = bucket(nb)
        total += nbp * s + call_fixed_us(sol.params, nbp * batch) / batch
    return total


def predict_staged_us(ssol: StagedSolution,
                      level_routes: list[tuple[int, int, int]],
                      batch: int) -> float:
    """Per-evaluation runtime (µs) of the staged dual-family plan.

    ``level_routes``: per-level (n_split, n_f1, n_f2) from
    :func:`runtime.executor.staged_level_routes` — each level runs one
    fam1 call batched ``bucket(ns + nf1)`` and one fam2 call batched
    ``bucket(ns + nf2)`` (``_staged_level_step``).
    """
    s1 = slope_us(ssol.params1)
    s2 = slope_us(ssol.params2)
    total = 0.0
    for ns, nf1, nf2 in level_routes:
        if ns + nf1:
            nbp = bucket(ns + nf1)
            total += nbp * s1 + call_fixed_us(ssol.params1,
                                              nbp * batch) / batch
        if ns + nf2:
            nbp = bucket(ns + nf2)
            total += nbp * s2 + call_fixed_us(ssol.params2,
                                              nbp * batch) / batch
    return total
