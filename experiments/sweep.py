"""Benchmark sweep orchestrator.

Parity with the reference harness (``run_benchmarks.sh`` + the five
``gen_makefile_*.bash`` generators + ``build_csv.py`` +
``add_exec_estimates.py``), redesigned as one resumable Python driver:

* generates the in-repo benchmark suite (no network needed), and picks up
  EPFL/ISCAS/Bristol files from ``benchmarks/<suite>/`` if present (use
  ``fetch_benchmarks.sh`` on a machine with egress);
* runs one mapper process per (bench, fbs_size, mapper) config with a
  process pool (the reference uses ``make -j4``); finished ``.log`` files
  are skipped on re-run — the same file-existence resume mechanism;
* aggregates the stats dict printed as each log's last line into
  ``<suite>_agg.csv`` and appends ``boot_cost`` from the parameter
  optimizer (memoized per (fbs_size, norm2)) into ``<suite>_agg_est.csv``.

Usage::

    python experiments/sweep.py --suite generated --jobs 4
"""

from __future__ import annotations

import argparse
import ast
import csv
import multiprocessing as mp
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SWEEPS = {
    # suite: (fbs sizes for naive+search, include basic baseline)
    "generated": (range(2, 17), True),
    "epfl": (range(3, 17), True),
    "iscas85": (range(2, 33), True),
    "iscas89": (range(2, 33), True),
    "bristol": (range(2, 17), True),
}
SUITE_FORMAT = {"generated": "blif", "epfl": "blif", "iscas85": "bench",
                "iscas89": "bench", "bristol": "bristol"}
# The reference preprocesses ISCAS85 with abc genlib map/unmap into an
# optimized XAG (gen_makefile_iscas85.bash:41); the equivalent here is the
# in-repo AIG pass (frontend/opt.py) via the CLI --opt flag.
SUITE_OPT = {"iscas85"}


def ensure_generated(bench_dir: Path) -> None:
    from tfhe_fbs_map_tpu.frontend.circuits import BENCH_GENERATORS, build_bench
    bench_dir.mkdir(parents=True, exist_ok=True)
    for name in BENCH_GENERATORS:
        if name.startswith("trivium_state"):
            continue
        out = bench_dir / f"{name}.blif"
        if out.exists():
            continue
        circ = build_bench(name)
        with open(out, "w") as f:
            circ.to_blif(fs=f, model_name=name)


def ensure_epfl(bench_dir: Path) -> None:
    """Regenerate the arithmetic EPFL members from their functional specs
    when the original netlists are not vendored (no egress) — see
    circuits/generators.py EPFL_GENERATORS for the caveats."""
    from tfhe_fbs_map_tpu.frontend.circuits import EPFL_GENERATORS
    bench_dir.mkdir(parents=True, exist_ok=True)
    for name, gen in EPFL_GENERATORS.items():
        out = bench_dir / f"{name}.blif"
        if out.exists():
            continue  # real (fetched) or previously regenerated files win
        circ = gen()
        circ.remove_dangling_nodes()
        with open(out, "w") as f:
            circ.to_blif(fs=f, model_name=name)


def configs_for(suite: str, bench_files: list[Path], out_dir: Path,
                timeout: float = 3600, mappers: list[str] | None = None):
    sizes, with_basic = SWEEPS[suite]
    fmt = SUITE_FORMAT[suite]
    opt = suite in SUITE_OPT
    for bench in bench_files:
        stem = bench.stem
        if with_basic and not mappers:
            yield (bench, fmt, 2, "basic",
                   out_dir / f"{stem}_2_basic.log", timeout, opt)
        for p in sizes:
            for mapper in mappers or (("naive", "search") if suite == "epfl"
                                      else ("search",)):
                yield (bench, fmt, p, mapper,
                       out_dir / f"{stem}_{p}_{mapper}.log", timeout, opt)


def run_one(cfg) -> str:
    bench, fmt, p, mapper, log, timeout, opt = cfg
    if log.exists():
        return f"skip {log.name}"
    cmd = [sys.executable, "-m", "tfhe_fbs_map_tpu.frontend.cli",
           str(bench), "--type", fmt, "--fbs_size", str(p),
           "--mapper", mapper,
           "--output", str(log.with_suffix(".fbs")),
           "--output_lbf", str(log.with_suffix(".lbf"))]
    if opt:
        cmd.append("--opt")
    with open(log, "w") as f:
        try:
            subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT,
                           cwd=str(REPO), timeout=timeout)
        except subprocess.TimeoutExpired:
            # leave the partial log (aggregate() skips unparseable logs,
            # mirroring the reference's tolerant build_csv.py) and keep
            # the pool running
            f.write(f"\n# TIMEOUT after {timeout}s\n")
            return f"timeout {log.name}"
    return f"done {log.name}"


def aggregate(out_dir: Path, csv_path: Path) -> list[dict]:
    rows = []
    for log in sorted(out_dir.glob("*.log")):
        try:
            last = log.read_text().strip().splitlines()[-1]
            d = ast.literal_eval(last)
            d["bench"] = Path(d["filename"]).stem
            rows.append(d)
        except Exception as e:  # tolerate failed runs, like build_csv.py:28
            print(f"cannot parse {log}: {e}", file=sys.stderr)
    # Merge with the existing aggregate: per-config artifacts are routinely
    # pruned (they are regenerable), so a partial re-run must not lose the
    # rows whose logs are gone.  Fresh logs win on (bench, mapper, fbs_size).
    if csv_path.exists():
        import pandas as pd
        old = pd.read_csv(csv_path)
        have = {(r["bench"], r["mapper"], int(r["fbs_size"])) for r in rows}
        for _, r in old.iterrows():
            if (r["bench"], r["mapper"], int(r["fbs_size"])) not in have:
                rows.append({k: v for k, v in r.items()
                             if v == v and k not in ("boot_cost",
                                                     "total_cost")})
    rows.sort(key=lambda d: (d["bench"], d["mapper"], d["fbs_size"]))
    if rows:
        keys = sorted({k for r in rows for k in r})
        with open(csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(rows)
    return rows


_SMEMO: dict[tuple, object] = {}


def staged_solution(prog, p: int):
    """Memoized staged parameter solution for ``prog`` (or None).

    The single implementation of the probe → optimize_staged pipeline
    (routing-mix weights, f1-wire-variance flag, kN=2048 fallback) shared
    by :func:`add_estimates` and ``experiments/reestimate_staged.py`` —
    previously duplicated verbatim (r4 advisor finding).  Raises
    ValueError when ``prog`` is not staged-realizable.
    """
    from tfhe_fbs_map_tpu.optimizer.optimizer import optimize_staged
    from tfhe_fbs_map_tpu.runtime.executor import staged_probe
    eff1, eff2, routes = staged_probe(prog, p)
    w1 = routes["f1"] + routes["split"]
    w2 = routes["f2"] + routes["split"]
    # f1-single wires carry fam1's fresh-bootstrap variance: conservative
    # wire bound unless everything is split/f2 (runtime/cli.py passes the
    # same flag)
    wfs2 = routes["f1"] == 0
    skey = (p, eff1, eff2, w1, w2, wfs2)
    if skey not in _SMEMO:
        ssol = optimize_staged(p, eff1, eff2, weight1=w1, weight2=w2,
                               wires_from_stage2=wfs2)
        if ssol is None:        # kN=2048 fallback (cleaner keys)
            ssol = optimize_staged(p, eff1, eff2, weight1=w1, weight2=w2,
                                   big_dim=2048, wires_from_stage2=wfs2)
        _SMEMO[skey] = ssol
    return _SMEMO[skey]


def staged_estimate(prog, p: int) -> float:
    """Whole-program staged per-boot-model cost estimate (µs), or NaN."""
    ssol = staged_solution(prog, p)
    return round(ssol.cost, 1) if ssol else float("nan")


def staged_rt_estimate(prog, p: int) -> float:
    """Launch-aware staged runtime estimate (µs/eval at RT_BATCH), NaN if
    not staged-realizable."""
    from tfhe_fbs_map_tpu.optimizer.runtime_model import predict_staged_us
    from tfhe_fbs_map_tpu.runtime.executor import staged_level_routes
    ssol = staged_solution(prog, p)
    if ssol is None:
        return float("nan")
    return predict_staged_us(ssol, staged_level_routes(prog, p), RT_BATCH)


# evaluation batch at which the launch-aware runtime columns are priced
# (the README circuit-table convention)
RT_BATCH = 16


def add_estimates(rows: list[dict], csv_path: Path) -> None:
    from tfhe_fbs_map_tpu.frontend.lut_program import parse_lbf
    from tfhe_fbs_map_tpu.optimizer import optimize
    from tfhe_fbs_map_tpu.optimizer.runtime_model import predict_native_us
    from tfhe_fbs_map_tpu.runtime.executor import native_level_boots
    memo: dict[tuple, object] = {}
    for r in rows:
        key = (r["fbs_size"], r["norm2_linprod"])
        if key not in memo:
            memo[key] = optimize(int(key[0]), float(key[1]))
        sol = memo[key]
        r["boot_cost"] = round(sol.cost, 1) if sol else float("nan")
        nb = r.get("nb_bootstrap", 0)
        r["total_cost"] = round(nb * sol.cost, 1) if sol else float("nan")
        # staged-pipeline estimate (runtime/executor.py dual-family plan):
        # probe the mapped program for realizability, post-scaling norms,
        # and the node routing mix; the search objective is the
        # whole-program cost under that mix.  The *_rt_est columns price
        # the per-level launches and power-of-two level padding on top
        # (optimizer/runtime_model.py, batch RT_BATCH) — the routing-
        # decision numbers, where total_cost/staged_total keep the
        # reference estimate contract (pure per-boot model).
        r["staged_boot_cost"] = r["staged_total"] = ""
        r["native_rt_est"] = r["staged_rt_est"] = ""
        p = int(r["fbs_size"])
        lbf = Path(str(r.get("output_lbf", "")))
        if lbf.is_file():
            try:
                prog = parse_lbf(lbf.read_text())
            except Exception:
                prog = None
            if prog is not None:
                n_boots = max(1, prog.stats()["nb_bootstrap"])
                if sol is not None:
                    r["native_rt_est"] = round(predict_native_us(
                        sol, native_level_boots(prog), RT_BATCH), 1)
                if p >= 10 and p % 2 == 0:
                    try:
                        st = staged_estimate(prog, p)
                        if st == st:
                            r["staged_total"] = st
                            r["staged_boot_cost"] = round(st / n_boots, 1)
                            srt = staged_rt_estimate(prog, p)
                            if srt == srt:
                                r["staged_rt_est"] = round(srt, 1)
                    except (ValueError, AssertionError):
                        pass    # not staged-realizable: native only
    keys = sorted({k for r in rows for k in r})
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--suite", default="generated", choices=list(SWEEPS))
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=3600,
                    help="per-config mapper budget (s); slower configs are "
                         "logged as timeouts and skipped by aggregation")
    ap.add_argument("--out", default=None)
    ap.add_argument("--bench", nargs="*", default=None,
                    help="restrict to these benchmark stems")
    ap.add_argument("--sizes", default=None,
                    help="fbs sizes, e.g. 2-8 or 3,5,9")
    ap.add_argument("--mappers", nargs="*", default=None,
                    help="override the suite's mapper list (e.g. 'best' to "
                         "sweep the beyond-parity racing mapper; rows merge "
                         "into the same aggregate, keyed by the mapper "
                         "column)")
    ap.add_argument("--reestimate", action="store_true",
                    help="map nothing: re-price the existing aggregate "
                         "(after a cost-model change).  Program-level "
                         "columns are filled only where the config's .lbf "
                         "is still on disk")
    args = ap.parse_args()

    if args.sizes:
        if "-" in args.sizes:
            lo, hi = args.sizes.split("-")
            SWEEPS[args.suite] = (range(int(lo), int(hi) + 1),
                                  SWEEPS[args.suite][1])
        else:
            SWEEPS[args.suite] = ([int(x) for x in args.sizes.split(",")],
                                  SWEEPS[args.suite][1])

    bench_dir = REPO / "benchmarks" / args.suite
    out_dir = Path(args.out) if args.out else REPO / "outputs" / args.suite
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.suite == "generated":
        ensure_generated(bench_dir)
    if args.suite == "epfl":
        ensure_epfl(bench_dir)
    if not bench_dir.exists():
        print(f"no benchmarks at {bench_dir}; run "
              f"experiments/fetch_benchmarks.sh first", file=sys.stderr)
        return 1

    exts = {"blif": "*.blif", "bench": "*.bench", "bristol": "*.txt"}
    bench_files = sorted(bench_dir.glob(exts[SUITE_FORMAT[args.suite]]))
    if args.bench:
        bench_files = [b for b in bench_files if b.stem in args.bench]
    cfgs = list(configs_for(args.suite, bench_files, out_dir,
                            args.timeout, args.mappers))
    print(f"{len(cfgs)} configs over {len(bench_files)} benchmarks")

    if not args.reestimate:
        with mp.Pool(args.jobs) as pool:
            for msg in pool.imap_unordered(run_one, cfgs):
                print(msg)

    rows = aggregate(out_dir, REPO / "outputs" / f"{args.suite}_agg.csv")
    add_estimates(rows, REPO / "outputs" / f"{args.suite}_agg_est.csv")
    print(f"aggregated {len(rows)} rows")
    return 0


if __name__ == "__main__":
    sys.exit(main())
