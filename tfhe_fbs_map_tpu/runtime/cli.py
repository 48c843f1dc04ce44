"""Homomorphic circuit runner: execute mapped ``.lbf`` programs under TFHE.

The executable counterpart the reference never ships (it stops at emitting
``.lbf`` files and estimating their cost through Concrete; SURVEY.md §2
C18).  This runner loads or maps a circuit, encrypts random (or provided)
inputs, executes every lincomb/bootstrap level batched on the device,
decrypts, and verifies bit-exactness against the cleartext oracle.

    python -m tfhe_fbs_map_tpu.runtime circuit.lbf --batch 16
    python -m tfhe_fbs_map_tpu.runtime circuit.blif --map --fbs_size 4
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# Safety factor on the staged-vs-native routing decision.  r4 used a fixed
# 0.8 margin calibrated from one Kreyvium measurement; the launch-aware
# runtime predictor (optimizer/runtime_model.py) now prices the per-level
# overheads the per-boot model misses, so near-ties are decided by the
# model itself and the default margin is 1.0 (route staged iff predicted
# faster).  Override with --staged-margin for re-calibration experiments.
STAGED_MARGIN = 1.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Execute a mapped FBS circuit homomorphically")
    ap.add_argument("filename", help=".lbf program or circuit to map")
    ap.add_argument("--map", action="store_true",
                    help="input is a source circuit: map it first")
    ap.add_argument("--type", default="blif",
                    choices=["blif", "bristol", "bench"])
    ap.add_argument("--unroll_frames", type=int, default=10,
                    help="time frames for sequential .bench circuits "
                         "(matches the mapping CLI default)")
    ap.add_argument("--mapper", default="search",
                    choices=["basic", "naive", "search", "search+",
                             "search+dc", "best"])
    ap.add_argument("--fbs_size", type=int, default=None,
                    help="FBS size (default: from --params or 4)")
    ap.add_argument("--batch", type=int, default=8,
                    help="number of circuit evaluations in parallel")
    ap.add_argument("--keys", help="key checkpoint (.npz); generated if absent")
    ap.add_argument("--save-keys", help="write generated keys here")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--checkpoint", default=None,
                    help=".npz path: snapshot the wire buffer periodically "
                         "and resume an interrupted run from it (adaptive: "
                         "snapshot cost stays under ~10%% of compute)")
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    help="fixed level interval for snapshots (overrides "
                         "the adaptive schedule)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="run the circuit this many times; report the last "
                         "(steady-state, compile cache warm)")
    ap.add_argument("--test-params", action="store_true",
                    help="use the small insecure test parameter set")
    ap.add_argument("--p-error", type=float, default=None,
                    help="per-bootstrap error-probability target for the "
                         "parameter optimizer (default: the reference "
                         "pipeline's 4-sigma, ~6.3e-5 — at that target a "
                         "run of B bootstraps EXPECTS ~6e-5*B bit flips; "
                         "use e.g. 1e-9 for bit-exactness claims)")
    ap.add_argument("--mesh", default=None, metavar="DP,TP",
                    help="run the executor mesh-parallel: 'DP,TP' device "
                         "counts (e.g. 2,2), 'DP' (tp=1), or 'auto' (all "
                         "devices on dp).  dp shards the evaluation batch; "
                         "tp shards the matmul-orientation key contraction")
    ap.add_argument("--orientation", default="auto",
                    choices=["auto", "matmul", "compact", "generic"],
                    help="bootstrap path (auto: on a GPU, precomputed key "
                         "matrices when they fit the card's memory, compact "
                         "keys otherwise; the generic path elsewhere)")
    ap.add_argument("--save-outputs", metavar="NPY", default=None,
                    help="write the output ciphertexts [outputs, batch, "
                         "kN+1] (int32) here, e.g. to compare runs")
    ap.add_argument("--staged", default="auto", choices=["auto", "on", "off"],
                    help="staged dual-family pipeline (tfhe/staged.py): "
                         "large LUTs split into a size-p/2 + size-8 pair, "
                         "small ones run on the cheap family, wires are "
                         "produced pre-scaled.  auto = use it when the "
                         "program compiles onto it AND the optimizer says "
                         "it is cheaper than one size-p bootstrap")
    ap.add_argument("--staged-margin", type=float, default=STAGED_MARGIN,
                    help="route staged only when the launch-aware runtime "
                         "prediction beats native by this factor "
                         "(default %(default)s; the prediction already "
                         "prices per-level launches and batch padding)")
    args = ap.parse_args(argv)

    from ..utils.cache import enable_compile_cache
    enable_compile_cache()

    from ..frontend.lut_program import parse_lbf
    from ..frontend.mapping.basic import BasicMapper
    from ..frontend.mapping.heuristic import HeuristicMapper
    from ..frontend.parsers import parse_circuit
    from ..optimizer import optimize
    from ..tfhe import TEST_PARAMS, generate_keys
    from ..tfhe.keys import load_keys, save_keys
    from .executor import CircuitExecutor

    # --- obtain the program --------------------------------------------
    circuit = None
    if args.map:
        kw = ({"unroll_frames": args.unroll_frames}
              if args.type == "bench" else {})
        circuit = parse_circuit(args.filename, args.type, **kw)
        p = args.fbs_size or 4
        if args.mapper == "basic":
            prog = BasicMapper().map(circuit)
        elif args.mapper == "best":
            from ..frontend.mapping.heuristic import map_best
            prog = map_best(circuit, fbs_size=p)
        else:
            prog = HeuristicMapper(cone_merger=args.mapper,
                                   fbs_size=p).map(circuit)
        prog.remove_dangling_nodes()
    else:
        prog = parse_lbf(open(args.filename).read())

    stats = prog.stats()
    # the FBS size the mapper targeted: recorded in the .lbf (our superset
    # stanza), else the smallest p at which every table is realizable —
    # max_lut_size//2 alone is NOT enough, negacyclic half-tables are tied
    # to the exact mapping-time p
    p_needed = prog.fbs_size or prog.min_fbs_size()
    print(f"# program: {stats} (p={p_needed})", file=sys.stderr)

    # --- staged-pipeline probe -------------------------------------------
    # compile the program onto the dual-family plan WITHOUT keys to learn
    # whether it is realizable and what its post-scaling norms are
    staged_sol = None
    staged_routes = None
    staged_nb = 1
    p_run = max(p_needed, args.fbs_size or p_needed)
    if args.staged != "off" and not args.keys and not args.test_params \
            and p_run >= 10 and p_run % 2 == 0:
        from ..optimizer.optimizer import optimize_staged
        from .executor import staged_level_routes, staged_probe
        try:
            eff1, eff2, routes = staged_probe(prog, p_run)
            # the search objective is the WHOLE-PROGRAM cost under the
            # node routing mix (an f2 single costs one select-family
            # boot, not a split pair)
            w1 = routes["f1"] + routes["split"]
            w2 = routes["f2"] + routes["split"]
            staged_nb = max(1, sum(routes.values()))
            kw = ({"max_p_error": args.p_error}
                  if args.p_error is not None else {})
            # wires produced by f1 singles carry fam1's (not fam2's)
            # fresh-bootstrap variance: any f1 routing forces the
            # conservative max(v1, v2) wire bound (noise.py:129).  With
            # the all-split default a Kreyvium-class program (8754 f1
            # singles) measured a 0.22/boot stage-1 error vs the 5e-5
            # model.
            kw["wires_from_stage2"] = routes["f1"] == 0
            staged_sol = optimize_staged(p_run, eff1, eff2,
                                         weight1=w1, weight2=w2, **kw)
            if staged_sol is None:
                # high effective norms: retry with the kN=2048 master
                # (the GLWE noise floor clamp makes its keys ~2^12x
                # cleaner; cost roughly doubles per boot)
                staged_sol = optimize_staged(p_run, eff1, eff2,
                                             weight1=w1, weight2=w2,
                                             big_dim=2048, **kw)
            if staged_sol is not None:
                staged_routes = staged_level_routes(prog, p_run)
        except ValueError as e:
            if args.staged == "on":
                print(f"--staged on: {e}", file=sys.stderr)
                return 1
            print(f"# staged: not realizable ({str(e)[:120]}...)",
                  file=sys.stderr)

    # --- keys -----------------------------------------------------------
    bsk_limbs = 4
    sol = None
    use_staged = False
    if args.keys:
        keys = load_keys(args.keys)
    else:
        if args.test_params:
            params = TEST_PARAMS.with_p(max(p_needed, TEST_PARAMS.p))
        else:
            kw = ({"max_p_error": args.p_error}
                  if args.p_error is not None else {})
            sol = optimize(p_run, max(1, stats["norm2_linprod"]), **kw)
            if sol is None and staged_sol is None:
                print("no parameter set satisfies the error target",
                      file=sys.stderr)
                return 1
            # Launch-aware routing: price BOTH plans at the actual
            # evaluation batch — per-level kernel launches, power-of-two
            # level padding, and the dual-family two-calls-per-level all
            # included (optimizer/runtime_model.py; replaces a fixed
            # margin on the per-boot model, which mis-priced small-batch
            # staged programs — PERF.md lesson 21).
            use_staged = False
            if staged_sol is not None:
                from ..optimizer.runtime_model import (predict_native_us,
                                                       predict_staged_us)
                from .executor import native_level_boots
                staged_rt = predict_staged_us(staged_sol, staged_routes,
                                              args.batch)
                native_rt = (predict_native_us(sol,
                                               native_level_boots(prog),
                                               args.batch)
                             if sol is not None else float("inf"))
                print(f"# runtime model (batch {args.batch}): native "
                      f"{native_rt / 1e3:.1f}ms/eval, staged "
                      f"{staged_rt / 1e3:.1f}ms/eval", file=sys.stderr)
                use_staged = (args.staged == "on" or sol is None
                              or staged_rt < args.staged_margin * native_rt)
        if use_staged:
            from ..tfhe.staged import generate_staged_keys
            print(f"# staged params: fam1={staged_sol.params1} "
                  f"fam2={staged_sol.params2} "
                  f"(program cost {staged_sol.cost:.0f}us vs native "
                  f"{(sol.cost * staged_nb) if sol else float('nan'):.0f})",
                  file=sys.stderr)
            t0 = time.time()
            keys = generate_staged_keys(p_run, staged_sol.params1,
                                        staged_sol.params2, seed=args.seed)
            print(f"# staged keygen: {time.time() - t0:.1f}s",
                  file=sys.stderr)
        else:
            if not args.test_params:
                params = sol.params
                bsk_limbs = sol.bsk_limbs  # optimizer-validated quantized BSK
                print(f"# params: {params} (bsk_limbs={bsk_limbs})",
                      file=sys.stderr)
            t0 = time.time()
            keys = generate_keys(params, seed=args.seed)
            print(f"# keygen: {time.time() - t0:.1f}s", file=sys.stderr)
            if args.save_keys:
                save_keys(args.save_keys, keys)

    # --- encrypt / run / decrypt / verify ------------------------------
    rng = np.random.default_rng(args.seed)
    input_names = [n.name for n in prog.nodes if n.kind == "input"]
    values = {name: rng.integers(0, 2, args.batch) for name in input_names}
    oracle = prog.eval(values)

    # --- fast-path selection --------------------------------------------
    fast = None
    if args.orientation != "generic":
        import jax

        from ..ops.blind_rotate import pick_orientation, prepare_fast_keys

        families = ([keys.keys1, keys.keys2] if use_staged else [keys])
        orient = args.orientation
        if orient == "auto":
            dev = jax.devices()[0]
            stats = dev.memory_stats() or {}
            orient = pick_orientation([f.params for f in families],
                                      dev.platform,
                                      stats.get("bytes_limit", 0))
        if orient:
            t0 = time.time()
            kw = {} if use_staged else {"bsk_limbs": bsk_limbs}
            fast = [prepare_fast_keys(f, orientation=orient, **kw)
                    for f in families]
            jax.block_until_ready([f.bsk_kernels for f in fast])
            fast = tuple(fast) if use_staged else fast[0]
            print(f"# fast keys ({orient}): {time.time() - t0:.1f}s",
                  file=sys.stderr)

    mesh = None
    if args.mesh:
        import jax

        from ..parallel.distributed import global_mesh, init_distributed
        from ..parallel.mesh import make_mesh
        multi = init_distributed()  # no-op unless a coordinator is given
        if args.mesh == "auto":
            if multi:
                mesh = global_mesh(tp=1)
            dp, tp = len(jax.devices()), 1
        else:
            parts = [int(x) for x in args.mesh.split(",")]
            dp, tp = (parts + [1])[:2]
        if mesh is None:
            mesh = make_mesh(jax.devices()[:dp * tp], dp=dp, tp=tp)
        if args.batch % dp:
            print(f"--batch {args.batch} must be divisible by dp={dp}",
                  file=sys.stderr)
            return 1
        print(f"# mesh: dp={dp} tp={tp}", file=sys.stderr)

    ex = CircuitExecutor(prog, keys, fast_keys=fast, mesh=mesh)
    t0 = time.time()
    buf0 = ex.encrypt_inputs(values, rng)
    enc_s = time.time() - t0
    run_s = None
    for rep in range(max(1, args.repeat)):
        t0 = time.time()
        # checkpointing only applies to the first run: later repeats are
        # steady-state timing and must not resume from its snapshots
        buf = ex.run(buf0, checkpoint=args.checkpoint if rep == 0 else None,
                     checkpoint_every=args.checkpoint_every)
        buf.block_until_ready()
        run_s = time.time() - t0
    got = ex.decrypt_outputs(buf)
    if args.save_outputs:
        np.save(args.save_outputs, np.asarray(ex.output_ciphertexts(buf)[1]))

    errors = wrong_bits = 0
    for k, want in oracle.items():
        bad = int(np.sum(np.asarray(want) != got[k]))
        if bad:
            errors += 1
            wrong_bits += bad
            print(f"MISMATCH on output {k}: want {np.asarray(want)} "
                  f"got {got[k]}", file=sys.stderr)

    total_boots = ex.num_bootstraps * args.batch
    # honest noise accounting: at the parameter set's per-bootstrap error
    # probability, a run of `total_boots` bootstraps EXPECTS flips — a
    # wrong-bit count at or below that expectation is the noise model
    # working, not a framework bug
    sol_pe = None if args.keys or args.test_params else (
        staged_sol.p_error if use_staged else sol.p_error)
    print(json.dumps({
        "staged": use_staged,
        "bit_exact": errors == 0,
        "wrong_bits": wrong_bits,
        "total_output_bits": len(oracle) * args.batch,
        "expected_flips": (round(sol_pe * total_boots, 3)
                           if sol_pe is not None else None),
        "outputs": len(oracle),
        "levels": len(ex.levels),
        "bootstraps": ex.num_bootstraps,
        "batch": args.batch,
        "mesh": dict(mesh.shape) if mesh is not None else None,
        "encrypt_s": round(enc_s, 3),
        "run_s": round(run_s, 3),
        "boots_per_sec": round(total_boots / run_s, 2) if run_s else None,
    }))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
