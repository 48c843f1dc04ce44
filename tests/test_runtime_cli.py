import io

import numpy as np
import pytest

from tfhe_fbs_map_tpu.frontend import HeuristicMapper
from tfhe_fbs_map_tpu.frontend.circuits import build_bench
from tfhe_fbs_map_tpu.runtime.cli import main as run_main
from tfhe_fbs_map_tpu.runtime.executor import CircuitExecutor
from tfhe_fbs_map_tpu.tfhe import TEST_PARAMS, generate_keys
from tfhe_fbs_map_tpu.tfhe.keys import load_keys, save_keys


def test_runner_lbf_end_to_end(tmp_path):
    circ = build_bench("half_adder")
    prog = HeuristicMapper(cone_merger="search", fbs_size=4).map(circ)
    prog.remove_dangling_nodes()
    lbf = tmp_path / "ha.lbf"
    with open(lbf, "w") as f:
        prog.write_lbf(f)
    rc = run_main([str(lbf), "--batch", "4", "--test-params"])
    assert rc == 0


def test_runner_map_inline(tmp_path):
    circ = build_bench("half_adder")
    blif = tmp_path / "ha.blif"
    with open(blif, "w") as f:
        circ.to_blif(f, model_name="ha")
    rc = run_main([str(blif), "--map", "--fbs_size", "4", "--batch", "2",
                   "--test-params"])
    assert rc == 0


def test_runner_mesh(tmp_path):
    """--mesh dp,tp runs the executor mesh-parallel (VERDICT r1 item 1)."""
    circ = build_bench("half_adder")
    prog = HeuristicMapper(cone_merger="search", fbs_size=4).map(circ)
    prog.remove_dangling_nodes()
    lbf = tmp_path / "ha.lbf"
    with open(lbf, "w") as f:
        prog.write_lbf(f)
    rc = run_main([str(lbf), "--batch", "8", "--test-params",
                   "--mesh", "4,2", "--orientation", "generic"])
    assert rc == 0


def test_runner_saves_output_ciphertexts(tmp_path):
    """--save-outputs writes [outputs, batch, kN+1] ciphertexts that decrypt
    to the oracle (the four-card check compares these buffers)."""
    from tfhe_fbs_map_tpu.frontend import parse_lbf
    from tfhe_fbs_map_tpu.tfhe.encrypt import decode, lwe_phase
    circ = build_bench("half_adder")
    prog = HeuristicMapper(cone_merger="search", fbs_size=4).map(circ)
    prog.remove_dangling_nodes()
    lbf = tmp_path / "ha.lbf"
    with open(lbf, "w") as f:
        prog.write_lbf(f)
    out = tmp_path / "out.npy"
    assert run_main([str(lbf), "--batch", "4", "--test-params",
                     "--save-outputs", str(out)]) == 0
    cts = np.load(out)
    prog = parse_lbf(lbf.read_text())
    keys = generate_keys(TEST_PARAMS.with_p(max(prog.min_fbs_size(),
                                                 TEST_PARAMS.p)), seed=42)
    assert cts.shape == (2, 4, keys.params.big_dim + 1)
    bits = decode(np.asarray(lwe_phase(keys.extracted_key,
                                       cts.reshape(-1, cts.shape[-1]))),
                  keys.params).reshape(2, 4)
    # the runner's inputs: default_rng(seed) draws, one per input in order
    rng = np.random.default_rng(42)
    values = {n.name: rng.integers(0, 2, 4) for n in prog.nodes
              if n.kind == "input"}
    want = prog.eval(values)
    assert [np.array_equal(bits[o], np.asarray(want[name]))
            for o, name in enumerate(prog.outputs)] == [True, True]


def test_key_serialization(tmp_path):
    keys = generate_keys(TEST_PARAMS, seed=3)
    path = tmp_path / "keys.npz"
    save_keys(str(path), keys)
    loaded = load_keys(str(path))
    assert loaded.params == keys.params
    assert np.array_equal(np.asarray(loaded.bsk), np.asarray(keys.bsk))
    assert np.array_equal(np.asarray(loaded.ksk), np.asarray(keys.ksk))


def test_executor_fast_path_matches_generic():
    from tfhe_fbs_map_tpu.ops.blind_rotate import prepare_fast_keys
    keys = generate_keys(TEST_PARAMS, seed=5)
    circ = build_bench("half_adder")
    prog = HeuristicMapper(cone_merger="search",
                           fbs_size=TEST_PARAMS.p).map(circ)
    prog.remove_dangling_nodes()
    rng = np.random.default_rng(1)
    vals = {i.name: rng.integers(0, 2, 4) for i in circ.inputs}
    want = circ.eval(vals)

    fast = prepare_fast_keys(keys, orientation="matmul")
    ex = CircuitExecutor(prog, keys, fast_keys=fast)
    got = ex.run_cleartext(vals, seed=2)
    for k in want:
        assert np.all(np.asarray(want[k]) == got[k]), k


def test_runner_json_noise_accounting(tmp_path, capsys):
    """The runner reports wrong-bit counts and the noise model's expected
    flips (bit_exact=false on a 4-sigma run is statistics, not a bug)."""
    import json

    circ = build_bench("half_adder")
    prog = HeuristicMapper(cone_merger="search", fbs_size=4).map(circ)
    prog.remove_dangling_nodes()
    lbf = tmp_path / "ha.lbf"
    with open(lbf, "w") as f:
        prog.write_lbf(f)
    rc = run_main([str(lbf), "--batch", "4", "--test-params"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["bit_exact"] is True
    assert out["wrong_bits"] == 0
    assert out["total_output_bits"] == out["outputs"] * 4
    assert out["expected_flips"] is None      # test params: no optimizer sol


def test_p_error_flag_tightens_params():
    """--p-error 1e-9 must pick a parameter set whose model p_error is
    below the target (used for bit-exactness claims on deep circuits)."""
    from tfhe_fbs_map_tpu.optimizer import optimize

    four_sigma = optimize(5, 14)
    strict = optimize(5, 14, max_p_error=1e-9)
    assert strict is not None and strict.p_error <= 1e-9
    assert strict.cost >= four_sigma.cost
