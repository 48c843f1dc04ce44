import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tfhe_fbs_map_tpu.frontend import BasicMapper, HeuristicMapper
from tfhe_fbs_map_tpu.frontend.circuits import BENCH_GENERATORS, build_bench
from tfhe_fbs_map_tpu.frontend.parsers import parse_blif

REPO = Path(__file__).resolve().parents[1]

SMALL_BENCHES = ["full_adder", "half_adder", "ascon_lut", "simon_iter",
                 "_2_input_gates", "aoi21", "oai21",
                 "trivium_iter_v1", "trivium_iter_v2", "trivium_iter_v3",
                 "kreyvium_iter_v1", "kreyvium_iter_v2", "kreyvium_iter_v3"]


@pytest.mark.parametrize("name", SMALL_BENCHES)
def test_generated_bench_maps_bit_exact(name):
    circ = build_bench(name)
    rng = np.random.default_rng(42)
    vals = {i.name: rng.integers(0, 2, 200) for i in circ.inputs}
    want = circ.eval(vals)
    for mapper in (BasicMapper(),
                   HeuristicMapper(cone_merger="search", fbs_size=8)):
        prog = mapper.map(circ)
        prog.remove_dangling_nodes()
        got = prog.eval(vals)
        for k in want:
            assert np.all(want[k] == got[k]), (name, k)


def test_full_adder_semantics():
    circ = build_bench("full_adder")
    vals = {"a": [0, 1, 1, 1], "b": [0, 1, 0, 1], "cin": [0, 0, 1, 1]}
    out = circ.eval(vals)
    total = np.asarray(vals["a"]) + np.asarray(vals["b"]) + np.asarray(vals["cin"])
    assert np.array_equal(out["out"], total % 2)
    assert np.array_equal(out["cout"], total // 2)


def test_simon_known_mapping():
    # Bon et al. comparison target: SIMON round maps to 1 FBS at p=9
    # (reference analyse_results.py:342-353).
    circ = build_bench("simon_iter")
    prog = HeuristicMapper(cone_merger="search", fbs_size=9).map(circ)
    prog.remove_dangling_nodes()
    assert prog.stats()["nb_bootstrap"] == 1


def test_aes_sbox_shape():
    circ = build_bench("aes_sbox")
    s = circ.stats()
    assert s["nb_inp"] == 22 and s["nb_out"] == 18


def test_bench_blif_roundtrip():
    circ = build_bench("ascon_lut")
    buf = io.StringIO()
    circ.to_blif(buf, model_name="ascon")
    circ2 = parse_blif(buf.getvalue())
    rng = np.random.default_rng(0)
    vals = {i.name: rng.integers(0, 2, 128) for i in circ.inputs}
    o1, o2 = circ.eval(vals), circ2.eval(vals)
    for k in o1:
        assert np.all(o1[k] == o2[k])


def test_trivium_stream_builds():
    circ = build_bench("trivium_stream_v1")
    s = circ.stats()
    assert s["nb_out"] == 288 * 4 + 288
    assert s["nb_inp"] == 288


def test_cli_end_to_end(tmp_path):
    blif = tmp_path / "fa.blif"
    with open(blif, "w") as f:
        build_bench("full_adder").to_blif(f, model_name="fa")
    fbs = tmp_path / "fa.fbs"
    lbf = tmp_path / "fa.lbf"
    res = subprocess.run(
        [sys.executable, "-m", "tfhe_fbs_map_tpu.frontend.cli", str(blif),
         "--fbs_size", "8", "--mapper", "search",
         "--output", str(fbs), "--output_lbf", str(lbf)],
        capture_output=True, text=True, cwd=REPO)
    assert res.returncode == 0, res.stderr
    last = res.stdout.strip().splitlines()[-1]
    stats = eval(last, {"__builtins__": {}})  # stats dict literal
    assert stats["nb_bootstrap"] >= 1
    assert stats["mapper"] == "search"
    assert fbs.exists() and lbf.exists()

    from tfhe_fbs_map_tpu.frontend import parse_lbf
    prog = parse_lbf(lbf.read_text())
    assert prog.stats()["nb_bootstrap"] == stats["nb_bootstrap"]
