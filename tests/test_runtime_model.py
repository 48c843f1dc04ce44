"""Launch-aware runtime predictor (optimizer/runtime_model.py) and the
level-profile probes that feed it."""

import numpy as np
import pytest

from tfhe_fbs_map_tpu.frontend.lut_program import LutProgram
from tfhe_fbs_map_tpu.optimizer.optimizer import (Solution, StagedSolution,
                                                  optimize)
from tfhe_fbs_map_tpu.optimizer.runtime_model import (bucket, call_fixed_us,
                                                      predict_native_us,
                                                      predict_staged_us)
from tfhe_fbs_map_tpu.runtime.executor import (native_level_boots,
                                               staged_level_routes,
                                               staged_probe)


def _chain_program(levels=3, width=4, p=4):
    """`levels` levels of `width` distinct bootstraps each."""
    prog = LutProgram()
    wires = [prog.input(f"x{i}") for i in range(width)]
    for lv in range(levels):
        nxt = []
        for i in range(width):
            lin = prog.linear([1, 2], [wires[i], wires[(i + 1) % width]],
                              const_coef=lv % 2)
            table = [(v + i) % 2 for v in range(3 + lv % 2 + 1)]
            nxt.append(prog.bootstrap(lin, table))
        wires = nxt
    for i, w in enumerate(wires):
        prog.output(f"o{i}", w)
    return prog


def test_native_level_boots_matches_executor_plan():
    from tfhe_fbs_map_tpu.runtime.executor import CircuitExecutor
    from tfhe_fbs_map_tpu.tfhe import TEST_PARAMS, generate_keys

    prog = _chain_program(levels=3, width=3)
    nlb = native_level_boots(prog)
    keys = generate_keys(TEST_PARAMS.with_p(8), seed=0)
    ex = CircuitExecutor(prog, keys)
    assert len(nlb) == len(ex.levels)
    assert sum(nlb) == ex.num_bootstraps
    # executor plans are padded to bucket(nb)
    for nb, plan in zip(nlb, ex.levels):
        assert plan.wire_idx.shape[0] == bucket(nb)


def test_staged_level_routes_consistent_with_probe():
    prog = _chain_program(levels=4, width=3)
    eff1, eff2, routes = staged_probe(prog, 16)
    lr = staged_level_routes(prog, 16)
    assert len(lr) == 4
    assert sum(ns for ns, _, _ in lr) == routes["split"]
    assert sum(f1 for _, f1, _ in lr) == routes["f1"]
    assert sum(f2 for _, _, f2 in lr) == routes["f2"]


def test_bucket():
    assert [bucket(x) for x in (1, 2, 3, 4, 5, 511, 512, 513)] == \
        [1, 2, 4, 4, 8, 512, 512, 1024]


def test_predict_native_amortizes_with_batch():
    sol = optimize(4, 2)
    assert sol is not None
    nlb = [3, 5, 1]
    small = predict_native_us(sol, nlb, 1)
    big = predict_native_us(sol, nlb, 256)
    # fixed per-level cost amortizes with batch
    assert big < small
    # floor: padded boots x per-boot slope (the slope may sit below the
    # roofline sol.cost once hardware calibration applies a family scale)
    from tfhe_fbs_map_tpu.optimizer.runtime_model import slope_us
    assert big >= sum(bucket(x) for x in nlb) * slope_us(sol.params,
                                                         sol.cost)


def test_predict_staged_two_calls_per_level():
    sol = optimize(4, 2)
    ssol = StagedSolution(params1=sol.params, params2=sol.params,
                          cost=0.0, p_error=0.0)
    one_call = predict_staged_us(ssol, [(0, 4, 0)], 16)
    two_calls = predict_staged_us(ssol, [(2, 2, 2)], 16)
    # same padded boots per family call, but the dual-family level pays
    # a second launch
    assert two_calls > one_call
    empty = predict_staged_us(ssol, [(0, 0, 0)], 16)
    assert empty == 0.0


def test_call_fixed_positive_and_scales_with_family():
    small = optimize(4, 2)
    big = optimize(16, 2)
    assert call_fixed_us(small.params, 64) > 0
    # at a fixed key form, larger families move more key bytes per call
    for orientation in ("matmul", "compact"):
        assert call_fixed_us(big.params, 64, orientation) > \
            call_fixed_us(small.params, 64, orientation)
    # the compact path rebuilds (writes and reads) every step's matrix
    assert call_fixed_us(small.params, 64, "compact") > \
        call_fixed_us(small.params, 64, "matmul")


def test_cli_routing_uses_runtime_model(tmp_path, monkeypatch):
    """The CLI prints the runtime-model decision line for staged-eligible
    programs (p >= 10), exercising the probe + both predictors."""
    from tfhe_fbs_map_tpu.optimizer.runtime_model import predict_native_us
    prog = _chain_program(levels=2, width=2)
    nlb = native_level_boots(prog)
    sol = optimize(10, 4)
    # the prediction is finite and larger than the pure per-boot total
    rt = predict_native_us(sol, nlb, 16)
    assert np.isfinite(rt)
    assert rt > sum(nlb) * sol.cost
