"""Calibrate the launch-aware runtime model on the card.

For each parameter family that occurs in the measured workloads (the
anchor/p8/p16/p32 bench presets plus the Kreyvium (2,512,l=4) family and
the s9234r p=22 pick), this script times the executor's jitted level step
at several kernel-batch sizes, fits ``t(rows) = F + rows * s`` per family,
then regresses the fixed terms ``F − key_traffic / HBM = dispatch +
n · step`` across families.  Writes:

* ``outputs/calibration_raw.json`` — every timed point (provenance);
* ``tfhe_fbs_map_tpu/optimizer/calibration.json`` — the model constants
  ``dispatch_us``, ``step_us`` and per-family ``slope_scale``
  (measured slope / roofline slope), loaded by
  ``optimizer/runtime_model.py``.

Needs a GPU::

    python experiments/calibrate_runtime.py [--families anchor p8 ...]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# (name, p, k, N, bsk_level, bsk_base_log, ksk_level, ksk_base_log, n) —
# the bench.py pinned preset shapes plus the Kreyvium-p10 family
# ((2,512,l=4): the optimize(10, 30) pick both pipelines use)
FAMILIES = {
    "anchor": (4, 2, 512, 2, 8, 4, 3, 546),
    "p8": (8, 2, 512, 2, 8, 6, 2, 642),
    "krey10": (10, 2, 512, 4, 5, 7, 2, 642),
    "p16": (16, 1, 1024, 3, 6, 6, 2, 642),
    "p32": (32, 1, 2048, 3, 7, 7, 2, 706),
    # the optimize(22, 26) pick measured on s9234r (kN = 2048, heavy)
    "p22": (22, 2, 1024, 3, 8, 8, 2, 738),
}


def _params(spec):
    from tfhe_fbs_map_tpu.tfhe.params import TFHEParams, min_noise_std_rel, Q
    p, k, N, bl, bb, kl, kb, n = spec
    return TFHEParams(p=p, lwe_dim=n, glwe_dim=k, poly_size=N,
                      bsk_level=bl, bsk_base_log=bb, ksk_level=kl,
                      ksk_base_log=kb,
                      lwe_noise_std=min_noise_std_rel(n) * Q,
                      glwe_noise_std=min_noise_std_rel(k * N) * Q)


def build_executor(name: str, batch: int):
    from tfhe_fbs_map_tpu.frontend.lut_program import LutProgram
    from tfhe_fbs_map_tpu.ops.blind_rotate import (pick_orientation,
                                                   prepare_fast_keys)
    from tfhe_fbs_map_tpu.optimizer.runtime_model import MODEL_MEMORY_BYTES
    from tfhe_fbs_map_tpu.runtime.executor import CircuitExecutor
    from tfhe_fbs_map_tpu.tfhe import generate_keys

    params = _params(FAMILIES[name])
    t0 = time.time()
    keys = generate_keys(params, seed=7)
    orient = pick_orientation([params], "gpu", MODEL_MEMORY_BYTES)
    fast = prepare_fast_keys(keys, orientation=orient)
    fast.bsk_kernels.block_until_ready()
    print(f"# {name}: keygen+fast ({orient}) {time.time() - t0:.1f}s",
          file=sys.stderr)

    prog = LutProgram()
    x = prog.input("x")
    b = prog.bootstrap(x, [0, 1])
    prog.output("o", b)
    ex = CircuitExecutor(prog, keys, fast_keys=fast)
    return ex, params, orient


def synth_plan(ex, params, nb: int):
    """One synthetic level of ``nb`` identity bootstraps reading wire 0."""
    import jax.numpy as jnp
    from tfhe_fbs_map_tpu.tfhe.pbs import build_test_vector
    tv, post = build_test_vector([0, 1], params)
    wire_idx = np.zeros((nb, 1), np.int32)
    coefs = np.ones((nb, 1), np.int32)
    consts = np.zeros(nb, np.int32)
    tvs = np.tile(np.asarray(tv, np.int32), (nb, 1))
    posts = np.full(nb, np.int64(post).astype(np.uint32).astype(np.int32))
    out_rows = np.full(nb, 1, np.int32)   # overwrite a scratch row
    return tuple(jnp.asarray(a) for a in (wire_idx, coefs, consts, tvs,
                                          posts, out_rows))


def time_family(name: str, nbs, v: int, iters: int) -> list[dict]:
    import jax.numpy as jnp

    ex, params, orient = build_executor(name, v)
    step = ex._build_local_step()
    d = params.big_dim + 1
    buf = jnp.zeros((3, v, d), dtype=np.int32)
    out = []
    for nb in nbs:
        rows = nb * v
        plan = synth_plan(ex, params, nb)
        step(buf, *plan).block_until_ready()     # compile + settle
        # PIPELINED timing: the executor's run loop dispatches level steps
        # back-to-back and waits once at the end, so per-call dispatch
        # overlaps execution; K chained calls with one wait measure that.
        ts = []
        for _i in range(3):
            t0 = time.time()
            r = buf
            for _k in range(iters):
                r = step(r, *plan)
            r.block_until_ready()
            ts.append((time.time() - t0) / iters)
        t_med = sorted(ts)[len(ts) // 2]
        out.append(dict(family=name, orientation=orient, nb=nb, v=v,
                        rows=rows,
                        t_ms=round(t_med * 1e3, 3),
                        all_ms=[round(t * 1e3, 2) for t in ts]))
        print(f"# {name} rows={rows}: {t_med * 1e3:.2f} ms", file=sys.stderr)
    return out


def fit(points: list[dict]) -> dict:
    from tfhe_fbs_map_tpu.ops.blind_rotate import key_bytes
    from tfhe_fbs_map_tpu.optimizer.optimizer import (HBM_BYTES,
                                                      bootstrap_cost_us)
    fams = {}
    for name, spec in FAMILIES.items():
        pts = [p for p in points if p["family"] == name]
        if len(pts) < 2:
            continue
        rows = np.array([p["rows"] for p in pts], float)
        t_us = np.array([p["t_ms"] for p in pts], float) * 1e3
        A = np.stack([np.ones_like(rows), rows], 1)
        (F, s), *_ = np.linalg.lstsq(A, t_us, rcond=None)
        p_, k, N, bl, bb, kl, kb, n = spec
        roof = bootstrap_cost_us(n, k, N, bl, kl)
        params = _params(spec)
        mat = key_bytes(params, "matmul")
        traffic = mat if pts[0]["orientation"] == "matmul" \
            else 2 * mat + key_bytes(params, "compact")
        fams[name] = dict(key=f"{k},{N},{bl}", fixed_us=float(F),
                          slope_us=float(s), roofline_us=roof,
                          slope_scale=float(s) / roof, n=n,
                          traffic_us=traffic / HBM_BYTES * 1e6)
    # regress fixed − key traffic = dispatch + n · step across families
    D, step = None, None
    if len(fams) >= 2:
        n = np.array([f["n"] for f in fams.values()], float)
        F = np.array([f["fixed_us"] - f["traffic_us"]
                      for f in fams.values()], float)
        A = np.stack([np.ones_like(n), n], 1)
        (D, step), *_ = np.linalg.lstsq(A, F, rcond=None)
        D, step = max(0.0, float(D)), max(0.0, float(step))
    cal = dict(families={f["key"]: dict(slope_scale=f["slope_scale"],
                                        fixed_us=f["fixed_us"],
                                        slope_us=f["slope_us"])
                         for f in fams.values()},
               points=len(points))
    if D is not None:
        cal.update(dispatch_us=D, step_us=step)
    return cal


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--families", nargs="*", default=list(FAMILIES))
    ap.add_argument("--nbs", default="1,4,16,32",
                    help="bootstraps per synthetic level")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=7)
    ap.add_argument("--dry", action="store_true",
                    help="fit from an existing outputs/calibration_raw.json")
    args = ap.parse_args()

    from tfhe_fbs_map_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    import jax
    if jax.devices()[0].platform != "gpu" and not args.dry:
        print("calibrate_runtime.py needs a GPU", file=sys.stderr)
        return 2
    raw_path = REPO / "outputs" / "calibration_raw.json"
    if args.dry:
        points = json.loads(raw_path.read_text())["points"]
    else:
        nbs = [int(x) for x in args.nbs.split(",")]
        # merge with prior sessions: re-timed families replace their old
        # points, others keep them (incremental family top-ups)
        points = []
        if raw_path.is_file():
            points = [p for p in json.loads(raw_path.read_text())["points"]
                      if p["family"] not in args.families]
        for name in args.families:
            points.extend(time_family(name, nbs, args.batch, args.iters))
            raw_path.write_text(json.dumps(dict(points=points), indent=1))
    cal = fit(points)
    cal_path = REPO / "tfhe_fbs_map_tpu" / "optimizer" / "calibration.json"
    cal_path.write_text(json.dumps(cal, indent=1) + "\n")
    print(json.dumps(cal))
    return 0


if __name__ == "__main__":
    sys.exit(main())
