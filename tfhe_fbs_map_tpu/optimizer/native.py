"""ctypes binding of the native (C++) optimizer core.

Builds ``native/optimizer.cpp`` with g++ on first use (cached as the
untracked ``native/liboptimizer.so``, rebuilt when the source is newer)
and exposes :func:`optimize_native` with the
same signature/result as :func:`tfhe_fbs_map_tpu.optimizer.optimize`.
Falls back to ``None`` availability when no toolchain is present; callers
use the pure-Python search then.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

from ..tfhe.params import TFHEParams
from .optimizer import Solution

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_SRC = _NATIVE_DIR / "optimizer.cpp"
_LIB = _NATIVE_DIR / "liboptimizer.so"

_lib = None


class _CSolution(ctypes.Structure):
    _fields_ = [
        ("lwe_dim", ctypes.c_int32), ("glwe_dim", ctypes.c_int32),
        ("poly_size", ctypes.c_int32), ("bsk_level", ctypes.c_int32),
        ("bsk_base_log", ctypes.c_int32), ("ksk_level", ctypes.c_int32),
        ("ksk_base_log", ctypes.c_int32),
        ("lwe_noise_std", ctypes.c_double),
        ("glwe_noise_std", ctypes.c_double),
        ("cost_us", ctypes.c_double), ("p_error", ctypes.c_double),
        ("bsk_limbs", ctypes.c_int32),
    ]


class _CStagedSolution(ctypes.Structure):
    _fields_ = [
        ("p1", ctypes.c_int32), ("n", ctypes.c_int32),
        ("k1", ctypes.c_int32), ("N1", ctypes.c_int32),
        ("bl1", ctypes.c_int32), ("bb1", ctypes.c_int32),
        ("kl1", ctypes.c_int32), ("kb1", ctypes.c_int32),
        ("p2", ctypes.c_int32),
        ("k2", ctypes.c_int32), ("N2", ctypes.c_int32),
        ("bl2", ctypes.c_int32), ("bb2", ctypes.c_int32),
        ("kl2", ctypes.c_int32), ("kb2", ctypes.c_int32),
        ("lwe_noise_std", ctypes.c_double),
        ("glwe1_noise_std", ctypes.c_double),
        ("glwe2_noise_std", ctypes.c_double),
        ("cost_us", ctypes.c_double), ("p_error", ctypes.c_double),
    ]


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
        # build beside the target, then rename: concurrent processes never
        # load a half-written library
        tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}")
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
            check=True, capture_output=True)
        os.replace(tmp, _LIB)
    _lib = ctypes.CDLL(str(_LIB))
    _lib.optimize_params.restype = ctypes.c_int32
    _lib.optimize_params.argtypes = [
        ctypes.c_int32, ctypes.c_double, ctypes.c_double, ctypes.c_int32,
        ctypes.POINTER(_CSolution)]
    _lib.optimize_staged_params.restype = ctypes.c_int32
    _lib.optimize_staged_params.argtypes = [
        ctypes.c_int32, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(_CStagedSolution)]
    i32, f64 = ctypes.c_int32, ctypes.c_double
    for name, argtypes in {
        "nv_var_blind_rotate": [i32, i32, i32, i32, i32, f64],
        "nv_var_keyswitch": [i32, i32, i32, i32, f64],
        "nv_var_modswitch": [i32, i32],
        "nv_var_bsk_quantization": [i32, i32, i32, i32, i32, i32],
        "nv_p_error_atomic": [i32, f64, i32, i32, i32, i32, i32, i32, i32,
                              f64, f64, i32],
        "nv_bootstrap_cost_us": [i32, i32, i32, i32, i32, i32],
    }.items():
        fn = getattr(_lib, name)
        fn.restype = f64
        fn.argtypes = argtypes
    return _lib


def native_model_fns():
    """The individual native model functions (for the lockstep tests)."""
    lib = _load()
    return {n: getattr(lib, n) for n in (
        "nv_var_blind_rotate", "nv_var_keyswitch", "nv_var_modswitch",
        "nv_var_bsk_quantization", "nv_p_error_atomic",
        "nv_bootstrap_cost_us")}


def native_available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def optimize_native(p: int, sq_norm2: float, max_p_error: float,
                    fast_path_only: bool = True) -> Solution | None:
    from .optimizer import GENERIC_PATH_SLOWDOWN
    lib = _load()
    out = _CSolution()
    slowdown = 1.0
    ok = lib.optimize_params(p, float(sq_norm2), float(max_p_error),
                             1 if fast_path_only else 0, ctypes.byref(out))
    if not ok and fast_path_only:
        # same fallback as the Python search: generic path, scaled cost
        ok = lib.optimize_params(p, float(sq_norm2), float(max_p_error), 0,
                                 ctypes.byref(out))
        slowdown = GENERIC_PATH_SLOWDOWN
    if not ok:
        return None
    params = TFHEParams(
        p=p, lwe_dim=out.lwe_dim, glwe_dim=out.glwe_dim,
        poly_size=out.poly_size, bsk_level=out.bsk_level,
        bsk_base_log=out.bsk_base_log, ksk_level=out.ksk_level,
        ksk_base_log=out.ksk_base_log, lwe_noise_std=out.lwe_noise_std,
        glwe_noise_std=out.glwe_noise_std)
    return Solution(params, out.cost_us * slowdown, out.p_error,
                    out.bsk_limbs)


def optimize_staged_native(p: int, sq_norm1: float = 4.0,
                           sq_norm2: float = 2.0,
                           max_p_error: float | None = None,
                           big_dim: int = 1024,
                           wires_from_stage2: bool = True,
                           weight1: float = 1.0, weight2: float = 1.0):
    """Native mirror of :func:`optimizer.optimize_staged` (bit-identical
    enumeration; the lockstep test compares full solutions)."""
    from .noise import P_ERROR_4_SIGMA
    from .optimizer import StagedSolution
    lib = _load()
    out = _CStagedSolution()
    ok = lib.optimize_staged_params(
        p, float(sq_norm1), float(sq_norm2),
        float(P_ERROR_4_SIGMA if max_p_error is None else max_p_error),
        big_dim, 1 if wires_from_stage2 else 0, float(weight1),
        float(weight2), ctypes.byref(out))
    if not ok:
        return None
    pr1 = TFHEParams(p=out.p1, lwe_dim=out.n, glwe_dim=out.k1,
                     poly_size=out.N1, bsk_level=out.bl1,
                     bsk_base_log=out.bb1, ksk_level=out.kl1,
                     ksk_base_log=out.kb1, lwe_noise_std=out.lwe_noise_std,
                     glwe_noise_std=out.glwe1_noise_std)
    pr2 = TFHEParams(p=out.p2, lwe_dim=out.n, glwe_dim=out.k2,
                     poly_size=out.N2, bsk_level=out.bl2,
                     bsk_base_log=out.bb2, ksk_level=out.kl2,
                     ksk_base_log=out.kb2, lwe_noise_std=out.lwe_noise_std,
                     glwe_noise_std=out.glwe2_noise_std)
    return StagedSolution(pr1, pr2, out.cost_us, out.p_error)
