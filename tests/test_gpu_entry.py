"""Entry points on a machine without a GPU, the compile cache, and the
device peak table."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def test_compile_cache_uses_the_environment_when_set(monkeypatch, tmp_path):
    import jax

    from tfhe_fbs_map_tpu.utils.cache import enable_compile_cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: no other directory is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_a_fixed_repo_dir(monkeypatch):
    import jax

    from tfhe_fbs_map_tpu.utils.cache import enable_compile_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        first = enable_compile_cache()
        assert first == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == first
        assert enable_compile_cache() == first        # stable across calls
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_h100_peaks_by_device_kind():
    from tfhe_fbs_map_tpu.optimizer.device import H100_SXM, peaks
    assert peaks("NVIDIA H100 80GB HBM3") is H100_SXM
    assert H100_SXM["int8_ops"] == 1979e12
    assert H100_SXM["hbm_bytes_per_s"] == 3.35e12
    assert H100_SXM["memory_bytes"] == 80e9


@pytest.mark.parametrize("kind", ["NVIDIA A100-SXM4-40GB", "cpu", ""])
def test_unknown_device_kind_raises(kind):
    from tfhe_fbs_map_tpu.optimizer.device import peaks
    with pytest.raises(KeyError, match="no peak rates"):
        peaks(kind)


def test_cpp_roofline_constants_match_the_table():
    """native/optimizer.cpp mirrors optimizer/device.py."""
    from tfhe_fbs_map_tpu.optimizer.device import H100_SXM
    src = (REPO / "native" / "optimizer.cpp").read_text()

    def const(name):
        return float(re.search(rf"constexpr double {name} = ([0-9.e]+);",
                               src).group(1))
    assert const("INT8_OPS") == H100_SXM["int8_ops"]
    assert const("HBM_BYTES") == H100_SXM["hbm_bytes_per_s"]


def _no_gpu_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def test_chip_smoke_fails_without_a_gpu():
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=_no_gpu_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no GPU" in res.stderr


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = _no_gpu_env()
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_bench_refuses_to_measure_without_a_gpu(capsys):
    sys.path.insert(0, str(REPO))
    import bench
    assert bench.main(["--iters", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no GPU" in out.err
