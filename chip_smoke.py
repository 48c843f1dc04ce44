#!/usr/bin/env python3
"""On-card smoke test of the homomorphic circuit path, in one process.

    python3 chip_smoke.py               # one GPU: phases 1-5
    python3 chip_smoke.py --four-cards  # four GPUs: phases 1 and 6 only

1. device: fails unless JAX's first device is a GPU; prints its kind, the
   device count and ``nvidia-smi``'s card name and power limit;
2. every bootstrap path (precomputed ``matmul`` key matrices where they fit,
   ``compact`` keys always) against the generic ``tfhe/pbs.py`` path at
   the bench families' full widths, batch 16: output ciphertexts must be
   identical as uint32 and decrypt to the table;
3. ``bench.py`` at the anchor, batch 512, ``errors == 0``;
4. the runtime CLI on AES-128 (native, p=4), bit-exact;
5. the runtime CLI on Kreyvium-1152 (staged, p=10), bit-exact;
6. (``--four-cards``) phase 4's program on one card, then ``--mesh 4,1``
   and ``--mesh 2,2``: identical output ciphertexts.

Every phase raises on failure; only a full pass prints the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

AES = REPO / "outputs" / "bristol" / "aes_128_4_search.lbf"
KREYVIUM = REPO / "outputs" / "generated" / "kreyvium_stream_v1_10_search.lbf"


def log(msg: str) -> None:
    print(msg, flush=True)


def last_json(fn, argv) -> tuple[int, dict]:
    """Run an entry point's ``main(argv)`` in-process; its exit code and
    the JSON object it printed last (its stdout is echoed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    out = buf.getvalue()
    sys.stdout.write(out)
    return rc, json.loads(out.strip().splitlines()[-1])


def compile_counters() -> dict:
    """Seconds XLA spent compiling, and persistent-cache hits and misses,
    counted from JAX's monitoring events from here on."""
    import jax
    stats = {"backend_compile_s": 0.0, "cache_hits": 0, "cache_misses": 0}

    def on_duration(event, duration_secs, **kw):
        if event == "/jax/core/compile/backend_compile_duration":
            stats["backend_compile_s"] += duration_secs

    def on_event(event, **kw):
        for key in ("cache_hits", "cache_misses"):
            if event == f"/jax/compilation_cache/{key}":
                stats[key] += 1
    jax.monitoring.register_event_duration_secs_listener(on_duration)
    jax.monitoring.register_event_listener(on_event)
    return stats


def phase_device():
    import jax

    from tfhe_fbs_map_tpu.utils.gpu import card_name_and_power_limit
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU, JAX platform {dev.platform!r}")
    card = card_name_and_power_limit()
    log(f"phase 1 device: kind={dev.device_kind!r} "
        f"count={len(jax.devices())} card={card}")
    return dev, card


def phase_kernels(dev) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import preset_params, staged_p32_families
    from tfhe_fbs_map_tpu.ops.blind_rotate import (functional_bootstrap_fast,
                                                   key_bytes,
                                                   pick_orientation,
                                                   prepare_fast_keys)
    from tfhe_fbs_map_tpu.tfhe import (build_test_vector, decrypt_values,
                                       encrypt_values, functional_bootstrap,
                                       generate_keys)

    fam1, fam2 = staged_p32_families()
    families = [("anchor", preset_params("anchor")),
                ("p16", preset_params("p16")),
                ("staged-p32 fam1", fam1), ("staged-p32 fam2", fam2),
                ("native-p32", preset_params("p32"))]
    mem = dev.memory_stats()["bytes_limit"]
    batch = 16
    for i, (name, params) in enumerate(families):
        t0 = time.time()
        keys = generate_keys(params, seed=100 + i)
        rng = np.random.default_rng(i)
        table = rng.integers(0, 2, params.p).tolist()
        values = rng.integers(0, params.p, batch)
        cts = encrypt_values(keys, values, rng)
        tv, post = build_test_vector(table, params)
        tvs = jnp.broadcast_to(jnp.asarray(tv), (batch, params.poly_size))
        posts = jnp.full((batch,), np.int32(post))
        want = np.asarray(functional_bootstrap(keys, cts, tvs, posts)) \
            .astype(np.uint32)
        for orient in ("matmul", "compact"):
            if orient == "matmul" and pick_orientation(
                    [params], dev.platform, mem) != "matmul":
                log(f"phase 2 {name} matmul: not run, key matrices "
                    f"{key_bytes(params, orient) / 1e9:.1f} GB do not fit "
                    f"beside the rest in {mem / 1e9:.1f} GB")
                continue
            fast = prepare_fast_keys(keys, orientation=orient)
            got = functional_bootstrap_fast(fast, cts, tvs, posts)
            same = np.array_equal(np.asarray(got).astype(np.uint32), want)
            dec = decrypt_values(keys, got)
            ok_dec = np.array_equal(dec, np.asarray(table)[values])
            log(f"phase 2 {name} {orient}: n={params.lwe_dim} "
                f"k={params.glwe_dim} N={params.poly_size} "
                f"l={params.bsk_level} batch={batch} identical_u32={same} "
                f"decrypt_ok={ok_dec} (tolerance 0: all device arithmetic "
                f"is integer mod 2^32, noise is sampled on the host)")
            if not (same and ok_dec):
                raise AssertionError(f"{name} {orient} differs from the "
                                     "generic path")
            del fast, got
            gc.collect()
        del keys
        gc.collect()
        jax.clear_caches()
        log(f"phase 2 {name}: {time.time() - t0:.1f}s")


def phase_bench(card: str) -> None:
    import bench
    rc, res = last_json(bench.main, ["--preset", "anchor", "--batch", "512"])
    log(f"phase 3 bench anchor batch 512: {res['value']} boots/s, "
        f"{res['ms_per_bootstrap']} ms/boot, errors={res['errors']}, "
        f"orientation={res['orientation']}, card={card}")
    if rc != 0 or res["errors"] != 0:
        raise AssertionError(f"bench failed: rc={rc} errors={res['errors']}")


def run_cli(label: str, argv: list[str]) -> dict:
    from tfhe_fbs_map_tpu.runtime.cli import main as run_main
    t0 = time.time()
    rc, res = last_json(run_main, argv)
    log(f"{label}: bit_exact={res['bit_exact']} "
        f"wrong_bits={res['wrong_bits']} bootstraps={res['bootstraps']} "
        f"levels={res['levels']} batch={res['batch']} staged={res['staged']} "
        f"mesh={res['mesh']} run_s={res['run_s']} "
        f"wall_s={time.time() - t0:.1f}")
    if rc != 0 or not res["bit_exact"] or res["wrong_bits"] != 0:
        raise AssertionError(f"{label} is not bit-exact")
    gc.collect()
    return res


def phase_four_cards() -> None:
    import jax
    import numpy as np
    if len(jax.devices()) < 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, found "
                         f"{len(jax.devices())}")
    out_dir = REPO / "chiprun_out" / "four_cards"
    out_dir.mkdir(parents=True, exist_ok=True)
    base = [str(AES), "--p-error", "1e-9", "--batch", "8"]
    outs = {}
    for mesh in (None, "4,1", "2,2"):
        path = out_dir / f"aes_{(mesh or 'one').replace(',', 'x')}.npy"
        argv = base + ["--save-outputs", str(path)]
        if mesh:
            argv += ["--mesh", mesh]
        run_cli(f"phase 6 AES-128 mesh={mesh or 'one card'}", argv)
        outs[mesh] = np.load(path)
    ref = outs[None]
    for mesh in ("4,1", "2,2"):
        same = np.array_equal(outs[mesh].astype(np.uint32),
                              ref.astype(np.uint32))
        log(f"phase 6 --mesh {mesh} vs one card: identical={same} "
            f"shape={tuple(ref.shape)}")
        if not same:
            raise AssertionError(f"--mesh {mesh} output differs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)

    from tfhe_fbs_map_tpu.utils.cache import enable_compile_cache
    cache = enable_compile_cache()
    compiles = compile_counters()
    t_start = time.time()
    dev, card = phase_device()
    log(f"compile cache: {cache}")

    if args.four_cards:
        phase_four_cards()
    else:
        for label, fn in (("phase 2", lambda: phase_kernels(dev)),
                          ("phase 3", lambda: phase_bench(card)),
                          ("phase 4", lambda: run_cli(
                              "phase 4 AES-128 native",
                              [str(AES), "--p-error", "1e-9",
                               "--batch", "8"])),
                          ("phase 5", lambda: run_cli(
                              "phase 5 Kreyvium-1152 staged",
                              [str(KREYVIUM), "--staged", "on",
                               "--batch", "16", "--p-error", "1e-9"]))):
            t0 = time.time()
            fn()
            log(f"{label} done in {time.time() - t0:.1f}s")

    import jax
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    log(f"total {time.time() - t_start:.1f}s, compile: {compiles}, "
        f"peak_bytes_in_use={peak}, card={card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
