"""End-to-end differential test: homomorphic execution of mapped circuits
decrypts bit-exactly to the cleartext oracle (the framework's load-bearing
correctness statement — reference map_circuit.py:174-180 extended to TFHE)."""

import numpy as np
import pytest

from tfhe_fbs_map_tpu.frontend import BasicMapper, HeuristicMapper
from tfhe_fbs_map_tpu.frontend.circuits import build_bench
from tfhe_fbs_map_tpu.runtime.executor import CircuitExecutor
from tfhe_fbs_map_tpu.tfhe import TEST_PARAMS, generate_keys


@pytest.fixture(scope="module")
def keys():
    return generate_keys(TEST_PARAMS, seed=11)


def run_both(circ, mapper, keys, n_vectors=8, seed=3):
    rng = np.random.default_rng(seed)
    vals = {i.name: rng.integers(0, 2, n_vectors) for i in circ.inputs}
    want = circ.eval(vals)

    prog = mapper.map(circ)
    prog.remove_dangling_nodes()
    oracle = prog.eval(vals)
    for k in want:
        assert np.all(want[k] == oracle[k])

    ex = CircuitExecutor(prog, keys)
    got = ex.run_cleartext(vals, seed=seed + 1)
    for k in want:
        assert np.all(np.asarray(want[k]) == got[k]), (
            k, np.asarray(want[k]), got[k])
    return ex


def test_full_adder_homomorphic(keys):
    circ = build_bench("full_adder")
    mapper = HeuristicMapper(cone_merger="search", fbs_size=TEST_PARAMS.p)
    ex = run_both(circ, mapper, keys)
    assert ex.num_bootstraps >= 1
    assert len(ex.levels) >= 1


def test_full_adder_basic_mapper(keys):
    circ = build_bench("full_adder")
    ex = run_both(circ, BasicMapper(), keys)
    # basic: one bootstrap per multi-input gate
    assert ex.num_bootstraps == 5


def test_ascon_lut_homomorphic(keys):
    circ = build_bench("ascon_lut")
    mapper = HeuristicMapper(cone_merger="search", fbs_size=TEST_PARAMS.p)
    run_both(circ, mapper, keys, n_vectors=4)


def test_output_shapes_and_consts(keys):
    from tfhe_fbs_map_tpu.frontend import BitCircuit, CONST0
    c = BitCircuit()
    a = c.add_input("a")
    b = c.add_input("b")
    c.set_output("z", c.and_(a, CONST0))       # const output
    c.set_output("pass", a)                     # passthrough output
    c.set_output("n", c.not_(a))                # lincomb output
    c.set_output("g", c.and_(a, b))             # bootstrap output
    mapper = HeuristicMapper(cone_merger="search", fbs_size=TEST_PARAMS.p)
    run_both(c, mapper, keys)


def test_checkpoint_resume(tmp_path):
    """Interrupted runs resume from the last level snapshot bit-exactly."""
    import jax.numpy as jnp

    from tfhe_fbs_map_tpu.frontend import HeuristicMapper
    from tfhe_fbs_map_tpu.frontend.circuits import build_bench
    from tfhe_fbs_map_tpu.runtime.executor import CircuitExecutor
    from tfhe_fbs_map_tpu.tfhe import TEST_PARAMS, generate_keys

    circ = build_bench("ascon_lut")
    prog = HeuristicMapper(cone_merger="search", fbs_size=4).map(circ)
    prog.remove_dangling_nodes()
    keys = generate_keys(TEST_PARAMS.with_p(4), seed=3)
    ex = CircuitExecutor(prog, keys)
    assert len(ex.levels) >= 2

    rng = np.random.default_rng(0)
    values = {i.name: rng.integers(0, 2, 4) for i in circ.inputs}
    buf0 = ex.encrypt_inputs(values, rng)
    want = ex.decrypt_outputs(ex.run(buf0))

    ckpt = str(tmp_path / "run.npz")
    # simulate a crash: checkpoint after every level, run only level 0
    ex.run(buf0, checkpoint=ckpt, checkpoint_every=1)
    # wipe and resume in a FRESH executor from the snapshot
    ex2 = CircuitExecutor(prog, keys)
    got = ex2.decrypt_outputs(ex2.run(buf0, checkpoint=ckpt,
                                      checkpoint_every=1))
    assert all(np.array_equal(want[k], got[k]) for k in want)


def test_checkpoint_adaptive_budget(tmp_path):
    """Adaptive checkpointing keeps snapshot cost within the budget: a
    zero budget never snapshots (fast circuits skip the host readback
    entirely), a generous one does."""
    import os

    from tfhe_fbs_map_tpu.frontend.circuits import build_bench
    from tfhe_fbs_map_tpu.frontend.mapping.heuristic import HeuristicMapper
    from tfhe_fbs_map_tpu.runtime.executor import CircuitExecutor
    from tfhe_fbs_map_tpu.tfhe import TEST_PARAMS, generate_keys

    prog = HeuristicMapper(cone_merger="search",
                           fbs_size=4).map(build_bench("full_adder"))
    prog.remove_dangling_nodes()
    keys = generate_keys(TEST_PARAMS, seed=1)
    ex = CircuitExecutor(prog, keys)
    rng = np.random.default_rng(0)
    values = {n.name: rng.integers(0, 2, 4)
              for n in prog.nodes if n.kind == "input"}
    buf = ex.encrypt_inputs(values, rng)
    ck = tmp_path / "never.npz"
    ex.run(buf, checkpoint=str(ck), checkpoint_budget=0.0)
    assert not os.path.exists(ck)
    ck2 = tmp_path / "always.npz"
    ex.run(buf, checkpoint=str(ck2), checkpoint_budget=1e9)
    assert os.path.exists(ck2) or len(ex.levels) < 2
