"""Time the bootstrap paths against each other on the card, end to end.

For each bench preset given, builds both key forms where they fit, times
``functional_bootstrap_fast`` at each batch (compile excluded, ends in
``block_until_ready``), checks every output against the first path's, and
optionally traces one call and prints the device time per kernel name.

    python experiments/kernel_timing.py --presets anchor p16 --batch 512 8 \
        [--generic] [--trace-dir chiprun_out/traces]

Every line names the card and its power limit.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import collections
import gc
import glob
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def device_kernel_times(logdir: str, top: int = 12) -> list[tuple[str, float,
                                                                  int]]:
    """(name, total device ms, count) of the busiest kernels in a trace."""
    from jax.profiler import ProfileData
    path = sorted(glob.glob(f"{logdir}/**/*.xplane.pb", recursive=True))[-1]
    prof = ProfileData.from_file(path)
    tot: dict = collections.defaultdict(float)
    cnt: dict = collections.Counter()
    for plane in prof.planes:
        if "/device:GPU" not in plane.name:
            continue
        for line in plane.lines:
            for ev in line.events:
                tot[ev.name] += ev.duration_ns / 1e6
                cnt[ev.name] += 1
    rows = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [(name, ms, cnt[name]) for name, ms in rows]


def time_call(fn, iters: int) -> float:
    """Seconds per call after one warm-up call."""
    fn().block_until_ready()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    out.block_until_ready()
    return (time.perf_counter() - t0) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--presets", nargs="+", default=["anchor", "p16"])
    ap.add_argument("--batch", nargs="+", type=int, default=[512])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--orientations", nargs="+",
                    default=["matmul", "compact"])
    ap.add_argument("--generic", action="store_true",
                    help="also time the generic tfhe/pbs.py path")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--quick", action="store_true",
                    help="tiny insecure params on any backend (rehearsal)")
    args = ap.parse_args(argv)

    from tfhe_fbs_map_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from bench import preset_params, quick_params
    from tfhe_fbs_map_tpu.ops.blind_rotate import (functional_bootstrap_fast,
                                                   pick_orientation,
                                                   prepare_fast_keys)
    from tfhe_fbs_map_tpu.tfhe import (build_test_vector, encrypt_values,
                                       functional_bootstrap, generate_keys)
    from tfhe_fbs_map_tpu.utils.gpu import card_name_and_power_limit

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.quick:
        print("kernel_timing.py needs a GPU", file=sys.stderr)
        return 2
    card = card_name_and_power_limit()
    for preset in args.presets:
        params = quick_params() if args.quick else preset_params(preset)
        keys = generate_keys(params, seed=1)
        rng = np.random.default_rng(2)
        tv, post = build_test_vector([1, 0, 1], params)
        paths = []
        for orient in args.orientations:
            if orient == "matmul" and not args.quick and pick_orientation(
                    [params], dev.platform,
                    dev.memory_stats()["bytes_limit"]) != "matmul":
                print(f"{preset} matmul: key matrices do not fit")
                continue
            fast = prepare_fast_keys(keys, orientation=orient)
            paths.append((orient, lambda c, t, p, f=fast:
                          functional_bootstrap_fast(f, c, t, p)))
        if args.generic:
            paths.append(("generic", lambda c, t, p:
                          functional_bootstrap(keys, c, t, p)))
        for batch in args.batch:
            cts = encrypt_values(keys, rng.integers(0, 3, batch), rng)
            tvs = jnp.broadcast_to(jnp.asarray(tv),
                                   (batch, params.poly_size))
            posts = jnp.full((batch,), np.int32(post))
            ref = None
            for name, fn in paths:
                t0 = time.perf_counter()
                out = np.asarray(fn(cts, tvs, posts))
                first_s = time.perf_counter() - t0
                ref = out if ref is None else ref
                same = np.array_equal(out, ref)
                s = time_call(lambda: fn(cts, tvs, posts), args.iters)
                print(f"{preset} {name} batch={batch}: {s * 1e3:.3f} ms/call "
                      f"{s * 1e6 / batch:.3f} us/boot compile+first "
                      f"{first_s:.1f}s identical={same} [{card}]",
                      flush=True)
                if not same:
                    raise AssertionError(f"{preset} {name} differs")
                if args.trace_dir and batch == max(args.batch):
                    logdir = f"{args.trace_dir}/{preset}_{name}_{batch}"
                    with jax.profiler.trace(logdir):
                        fn(cts, tvs, posts).block_until_ready()
                    for kname, ms, c in device_kernel_times(logdir):
                        print(f"    {ms:9.3f} ms {c:6d}x  {kname[:110]}")
        del paths, keys
        fast = None             # free this preset's keys before the next
        gc.collect()
        jax.clear_caches()
    return 0


if __name__ == "__main__":
    sys.exit(main())
