"""Batched homomorphic executor for mapped FBS programs.

Compiles a :class:`LutProgram` into a *levelized plan* and runs it under
TFHE on device.  Design (SURVEY.md §5 "level-wise batched bootstrapping"):

* The IR invariant (lincomb flattening, ``lut_program.py``) guarantees every
  lincomb reads only inputs/bootstrap outputs, so the program is an
  alternating lincomb/bootstrap DAG.  Wires (= LWE ciphertexts, big key)
  exist only for inputs and bootstrap outputs; lincombs are fused into the
  bootstrap that consumes them.
* Bootstraps are grouped by depth level; all bootstraps of a level run as
  ONE batched blind rotation — with a user batch of V circuit evaluations,
  the kernel batch is (bootstraps_in_level × V).
* The compiled plan is static arrays (gather indices, coefficient matrices,
  test polynomials), so each level step is a single jitted call.

This is the component the reference delegates wholesale to Zama Concrete
(SURVEY.md §2 C18): it executes ``.lbf`` programs homomorphically with
decryptions bit-exact against ``LutProgram.eval``.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..frontend.lut_program import (LutProgram, N_BOOT, N_CONST, N_INPUT,
                                    N_LIN)
from ..tfhe.encrypt import decode, lwe_phase
from ..tfhe.keys import TFHEKeys
from ..tfhe.numeric import I32
from ..tfhe.pbs import build_test_vector, functional_bootstrap
from ..tfhe.params import TFHEParams

__all__ = ["CircuitExecutor", "LevelPlan"]


@dataclass
class LevelPlan:
    """Static tensors for one level of batched bootstraps."""

    wire_idx: np.ndarray     # [nb, T] gather rows into the wire buffer
    coefs: np.ndarray        # [nb, T] int32 lincomb coefficients (0-padded)
    consts: np.ndarray       # [nb] int32 lincomb constant * delta (torus)
    test_polys: np.ndarray   # [nb, N] int32
    posts: np.ndarray        # [nb] int32 post-rotation body offsets
    out_rows: np.ndarray     # [nb] destination rows in the wire buffer


@dataclass
class StagedLevelPlan:
    """Static tensors for one level of staged (two-family) bootstraps.

    Stage 1: the re-gridded x_lo lincomb through the size-(p/2) family;
    stage 2: G + the branch lincomb through the size-8 select family
    (tfhe/staged.py).  Coefficients are post-scaled-wire-encoding
    multipliers (wires are produced at the gcd of their consumers' needed
    torus scales, so most multipliers collapse to 1)."""

    wire_idx1: np.ndarray    # [nb, T]
    coefs1: np.ndarray       # [nb, T]
    consts1: np.ndarray      # [nb]
    tvs1: np.ndarray         # [nb, N1]
    posts1: np.ndarray       # [nb]
    out_rows1: np.ndarray    # [nb] (dummy for split rows; real for singles)
    wire_idx2: np.ndarray    # [nb, T]
    coefs2: np.ndarray       # [nb, T]
    consts2: np.ndarray      # [nb]
    tvs2: np.ndarray         # [nb, N2]
    posts2: np.ndarray       # [nb]
    out_rows: np.ndarray     # [nb]
    n_splits: int = 0        # leading rows of both stages forming pairs


@dataclass
class OutputSpec:
    kind: str                # "wire" | "lin" | "const"
    wire_idx: np.ndarray     # for lin: [T]; for wire: [1]
    coefs: np.ndarray
    const: int               # const term (value units) / const value


class CircuitExecutor:
    def __init__(self, prog: LutProgram, keys: TFHEKeys,
                 fast_keys=None, mesh=None):
        """``fast_keys``: optional :class:`ops.blind_rotate.FastKeys` (a
        pair of them for staged keys); when given, bootstraps run on the
        int8 fast path instead of the generic gather-based external product.

        ``mesh``: optional :class:`jax.sharding.Mesh` with a ``"dp"`` axis
        (and optionally ``"tp"``).  The wire buffer ``[num_wires, V, d]`` is
        dp-sharded on the evaluation batch V and every level step runs
        sharded: the compact / generic paths via ``shard_map`` (the circuit
        plan and key material replicate, each device bootstraps its batch
        slice — no collectives), the ``matmul`` orientation via GSPMD with
        the key contraction tp-sharded (partial external products meet in
        an int32 psum, which XLA hands to NCCL)."""
        from ..tfhe.staged import StagedKeys
        self.prog = prog
        self.keys = keys
        self.fast_keys = fast_keys
        self.mesh = mesh
        self.staged = isinstance(keys, StagedKeys)
        if self.staged:
            self.params = keys.wire_params        # global wire grid
            self._compile_staged(prog)
        else:
            self.params = keys.params
            self._compile(prog)
        self._sharded_step = None
        self._local_step = None
        self._local_scan = None
        self._scan_cache: dict = {}
        self._plan_device = None
        if mesh is not None:
            assert "dp" in mesh.axis_names, "executor mesh needs a dp axis"
            self._sharded_step = (self._build_staged_sharded_step()
                                  if self.staged
                                  else self._build_sharded_step())

    # ------------------------------------------------------------- compile
    def _compile(self, prog: LutProgram) -> None:
        params = self.params
        wire_row: dict[str, int] = {}
        self.input_rows: dict[str, int] = {}
        levels: dict[int, list] = {}
        node_level: dict[str, int] = {}

        def lin_parts(node):
            rows, coefs = [], []
            for c, v in node.terms:
                rows.append(wire_row[v.name])
                coefs.append(int(c))
            return rows, coefs, int(node.const)

        for node in prog.nodes:
            if node.kind == N_INPUT:
                wire_row[node.name] = len(wire_row)
                self.input_rows[node.name] = wire_row[node.name]
                node_level[node.name] = 0
            elif node.kind == N_LIN:
                lv = max((node_level[v.name] for _, v in node.terms),
                         default=0)
                node_level[node.name] = lv
            elif node.kind == N_BOOT:
                src = node.src
                if src.kind == N_LIN:
                    rows, coefs, const = lin_parts(src)
                    lv = node_level[src.name] + 1
                else:  # bootstrap of a raw input/bootstrap wire
                    rows, coefs, const = [wire_row[src.name]], [1], 0
                    lv = node_level[src.name] + 1
                row = len(wire_row)
                wire_row[node.name] = row
                node_level[node.name] = lv
                tv, post = build_test_vector(node.table, params)
                levels.setdefault(lv, []).append(
                    (rows, coefs, const, tv, post, row))

        # One extra dummy wire row receives the results of padding slots, so
        # every level can be padded to a power-of-two bootstrap count and
        # share a handful of compiled kernel shapes instead of one per level.
        self.dummy_row = len(wire_row)
        self.num_wires = len(wire_row) + 1
        self.num_bootstraps = sum(len(v) for v in levels.values())

        t_global = max((len(rows) for v in levels.values()
                        for rows, *_ in v), default=1)

        def bucket(nb: int) -> int:
            b = 1
            while b < nb:
                b *= 2
            return b

        self.levels: list[LevelPlan] = []
        for lv in sorted(levels):
            entries = levels[lv]
            nb = bucket(len(entries))
            wire_idx = np.zeros((nb, t_global), dtype=np.int32)
            coefs = np.zeros((nb, t_global), dtype=np.int32)
            consts = np.zeros(nb, dtype=np.int32)
            tvs = np.zeros((nb, params.poly_size), dtype=np.int32)
            posts = np.zeros(nb, dtype=np.int32)
            out_rows = np.full(nb, self.dummy_row, dtype=np.int32)
            for j, (rows, cfs, const, tv, post, row) in enumerate(entries):
                wire_idx[j, :len(rows)] = rows
                coefs[j, :len(cfs)] = cfs
                consts[j] = np.int64(const * params.delta) \
                    .astype(np.uint32).astype(np.int32)
                tvs[j] = tv
                posts[j] = np.int64(post).astype(np.uint32).astype(np.int32)
                out_rows[j] = row
            self.levels.append(LevelPlan(wire_idx, coefs, consts, tvs,
                                         posts, out_rows))

        # outputs
        self.outputs: dict[str, OutputSpec] = {}
        for name, node in prog.outputs.items():
            if node.kind == N_CONST:
                self.outputs[name] = OutputSpec("const", np.zeros(0, np.int32),
                                                np.zeros(0, np.int32),
                                                node.const)
            elif node.kind == N_LIN:
                rows, cfs, const = lin_parts(node)
                self.outputs[name] = OutputSpec(
                    "lin", np.asarray(rows, np.int32),
                    np.asarray(cfs, np.int32), const)
            else:
                self.outputs[name] = OutputSpec(
                    "wire", np.asarray([wire_row[node.name]], np.int32),
                    np.asarray([1], np.int32), 0)

    # ------------------------------------------------------- staged compile
    def _compile_staged(self, prog: LutProgram) -> None:
        """Compile onto the dual-family staged pipeline (tfhe/staged.py).

        Per bootstrap node, cheapest-first:
        * table realizable at the size-8 select family -> ONE fam2 boot;
        * realizable at the size-(p/2) family -> ONE fam1 boot;
        * else the two-stage split (stage-1 packed pair + select).
        Wires are produced pre-scaled to the gcd of their consumers' needed
        torus multiples (scaled wire encodings): the test vector carries the
        scale for free, collapsing lincomb noise amplification.
        """
        import math

        from ..tfhe.staged import split_node

        params = self.params                    # wire grid (p = global p)
        p = params.p
        delta_w = params.delta
        k1p = self.keys.keys1.params            # p = p//2 grid
        k2p = self.keys.keys2.params            # p = 8 grid
        delta1, delta2 = k1p.delta, k2p.delta

        def c_const(table, pf):
            tau = len(table)
            if tau <= pf:
                return 0            # unused
            c = table[0] + table[pf]
            if tau <= 2 * pf and all(table[x] + table[x + pf] == c
                                     for x in range(tau - pf)):
                return c
            return None

        def can_single(table, pf):
            return len(table) <= pf or c_const(table, pf) is not None

        wire_row: dict[str, int] = {}
        self.input_rows = {}
        node_level: dict[str, int] = {}
        entries: dict[int, list] = {}           # level -> list of compiled
        needs: dict[int, set] = {}
        failures: list[str] = []

        def lin_parts(node):
            return ([wire_row[v.name] for _, v in node.terms],
                    [int(c) for c, _ in node.terms], int(node.const))

        compiled: list = []   # (lv, kind, rows, coefs, const, table, row)
        for node in prog.nodes:
            if node.kind == N_INPUT:
                wire_row[node.name] = len(wire_row)
                self.input_rows[node.name] = wire_row[node.name]
                node_level[node.name] = 0
            elif node.kind == N_LIN:
                node_level[node.name] = max(
                    (node_level[v.name] for _, v in node.terms), default=0)
            elif node.kind == N_BOOT:
                src = node.src
                if src.kind == N_LIN:
                    rows, coefs, const = lin_parts(src)
                    w_bounds = [v.max_val for _, v in src.terms]
                else:
                    rows, coefs, const = [wire_row[src.name]], [1], 0
                    w_bounds = [src.max_val]
                lv = node_level[src.name] + 1
                row = len(wire_row)
                wire_row[node.name] = row
                node_level[node.name] = lv
                table = list(node.table)
                # fam1 multiplier: wires at q/2p consumed on the q/(2*p1)
                # grid need c * p/p1
                m1 = p // k1p.p
                m2 = p // k2p.p
                # splits are wired for the SELECT_P select grid; singles
                # need the family grid to divide the wire grid (p2 | p)
                splits_ok = (k1p.p == p // 2 and p % (2 * k2p.p) == 0)
                if p % k2p.p == 0 and can_single(table, k2p.p):
                    kind, split = "f2", None
                    for r, c in zip(rows, coefs):
                        needs.setdefault(r, set()).add(m2 * c)
                elif can_single(table, k1p.p):
                    kind, split = "f1", None
                    for r, c in zip(rows, coefs):
                        needs.setdefault(r, set()).add(m1 * c)
                else:
                    split = split_node(coefs, const, table, p,
                                       bounds=w_bounds) \
                        if splits_ok else None
                    kind = "split"
                    if split is None:
                        failures.append(
                            f"{node.name}: tau={len(table)} coefs={coefs} "
                            f"const={const}")
                        continue
                    for i in split.a_idx:
                        needs.setdefault(rows[i], set()).add(2 * coefs[i])
                    for i in split.b_idx:
                        needs.setdefault(rows[i], set()).add(coefs[i])
                compiled.append((lv, kind, rows, coefs, const, table, row,
                                 split))
        if failures:
            raise ValueError(
                "program has bootstrap nodes the staged pipeline cannot "
                "realize (run the native single-family executor instead): "
                + "; ".join(failures[:8]))

        for name, spec_node in prog.outputs.items():
            if spec_node.kind == N_LIN:
                for _, v in spec_node.terms:
                    needs.setdefault(wire_row[v.name], set()).add(1)
            elif spec_node.kind not in (N_CONST,):
                needs.setdefault(wire_row[spec_node.name], set()).add(1)

        scale = {r: max(1, math.gcd(*ns) if len(ns) > 1
                        else abs(next(iter(ns))))
                 for r, ns in needs.items()}
        self.row_scale = np.ones(len(wire_row) + 1, dtype=np.int64)
        for r, s in scale.items():
            self.row_scale[r] = s

        def mult(needed, r):
            s = scale.get(r, 1)
            assert needed % s == 0, (needed, s)
            return needed // s

        for (lv, kind, rows, coefs, const, table, row, split) in compiled:
            out_delta = int(scale.get(row, 1)) * delta_w
            m1, m2 = p // k1p.p, p // k2p.p
            if kind == "f2":
                tv, post = build_test_vector(table, k2p, out_delta=out_delta)
                e = dict(kind="f2", rows2=rows,
                         coefs2=[mult(m2 * c, r) for r, c in zip(rows, coefs)],
                         const2=const * delta2, tv2=tv, post2=post, row=row)
            elif kind == "f1":
                tv, post = build_test_vector(table, k1p, out_delta=out_delta)
                e = dict(kind="f1", rows1=rows,
                         coefs1=[mult(m1 * c, r) for r, c in zip(rows, coefs)],
                         const1=const * delta1, tv1=tv, post1=post, row=row)
            else:
                tv1, post1 = build_test_vector(split.t1, k1p,
                                               out_delta=delta2)
                tv2, post2 = build_test_vector(split.t2, k2p,
                                               out_delta=out_delta)
                e = dict(kind="split",
                         rows1=[rows[i] for i in split.a_idx],
                         coefs1=[mult(2 * coefs[i], rows[i])
                                 for i in split.a_idx],
                         const1=split.const_lo * delta1, tv1=tv1, post1=post1,
                         rows2=[rows[i] for i in split.b_idx],
                         coefs2=[mult(coefs[i], rows[i])
                                 for i in split.b_idx],
                         const2=4 * split.const_hi * delta2,
                         tv2=tv2, post2=post2, row=row)
            entries.setdefault(lv, []).append(e)

        self.dummy_row = len(wire_row)
        self.num_wires = len(wire_row) + 1
        self.num_bootstraps = len(compiled)
        # each split counts one logical bootstrap; the device runs 2 stages
        self.num_stage_calls = sum(
            2 if e["kind"] == "split" else 1
            for lvl in entries.values() for e in lvl)
        # effective post-scaling squared norms per family (for the noise
        # model: optimize_staged(p, eff_norm1, eff_norm2)) and the node
        # routing mix (for honest cost accounting: an f2 single costs one
        # select-family boot, not a full split pair)
        self.eff_norm1 = max(
            (sum(c * c for c in e["coefs1"]) for lvl in entries.values()
             for e in lvl if "coefs1" in e), default=1)
        self.eff_norm2 = max(
            (sum(c * c for c in e.get("coefs2", []))
             + (1 if e["kind"] == "split" else 0)
             for lvl in entries.values() for e in lvl if e["kind"] != "f1"),
            default=1)
        self.route_counts = {kind: sum(
            1 for lvl in entries.values() for e in lvl if e["kind"] == kind)
            for kind in ("f1", "f2", "split")}
        # per-level routing profile (ns, nf1, nf2) for the launch-aware
        # runtime predictor (optimizer/runtime_model.py): each level issues
        # one fam1 call batched bucket(ns+nf1) and one fam2 call batched
        # bucket(ns+nf2)
        self.level_routes = [
            (sum(1 for e in entries[lv] if e["kind"] == "split"),
             sum(1 for e in entries[lv] if e["kind"] == "f1"),
             sum(1 for e in entries[lv] if e["kind"] == "f2"))
            for lv in sorted(entries)]

        def bucket(nb: int) -> int:
            b = 1
            while b < nb:
                b *= 2
            return b

        t_all = [len(e.get("rows1", [])) for lvl in entries.values()
                 for e in lvl] + [len(e.get("rows2", [])) for lvl
                                  in entries.values() for e in lvl]
        t_global = max(max(t_all, default=1), 1)
        N1, N2 = k1p.poly_size, k2p.poly_size

        def u32(x):
            return np.int64(x).astype(np.uint32).astype(np.int32)

        self.levels = []
        for lv in sorted(entries):
            lvl = entries[lv]
            # stage-1 batch: splits first, then f1 singles
            splits = [e for e in lvl if e["kind"] == "split"]
            f1s = [e for e in lvl if e["kind"] == "f1"]
            f2s = [e for e in lvl if e["kind"] == "f2"]
            ns = len(splits)
            nb1 = bucket(ns + len(f1s)) if (ns or f1s) else 0
            nb2 = bucket(ns + len(f2s)) if (ns or f2s) else 0

            wi1 = np.zeros((nb1, t_global), np.int32)
            cf1 = np.zeros((nb1, t_global), np.int32)
            cs1 = np.zeros(nb1, np.int32)
            tvs1 = np.zeros((nb1, N1), np.int32)
            ps1 = np.zeros(nb1, np.int32)
            or1 = np.full(nb1, self.dummy_row, np.int32)
            for j, e in enumerate(splits + f1s):
                wi1[j, :len(e["rows1"])] = e["rows1"]
                cf1[j, :len(e["coefs1"])] = e["coefs1"]
                cs1[j] = u32(e["const1"])
                tvs1[j] = e["tv1"]
                ps1[j] = u32(e["post1"])
                if e["kind"] == "f1":
                    or1[j] = e["row"]
            wi2 = np.zeros((nb2, t_global), np.int32)
            cf2 = np.zeros((nb2, t_global), np.int32)
            cs2 = np.zeros(nb2, np.int32)
            tvs2 = np.zeros((nb2, N2), np.int32)
            ps2 = np.zeros(nb2, np.int32)
            or2 = np.full(nb2, self.dummy_row, np.int32)
            for j, e in enumerate(splits + f2s):
                wi2[j, :len(e.get("rows2", []))] = e.get("rows2", [])
                cf2[j, :len(e.get("coefs2", []))] = e.get("coefs2", [])
                cs2[j] = u32(e["const2"])
                tvs2[j] = e["tv2"]
                ps2[j] = u32(e["post2"])
                or2[j] = e["row"]
            self.levels.append(StagedLevelPlan(
                wi1, cf1, cs1, tvs1, ps1, or1,
                wi2, cf2, cs2, tvs2, ps2, or2, ns))

        # outputs (same spec structure as the native compile)
        self.outputs = {}
        for name, node in prog.outputs.items():
            if node.kind == N_CONST:
                self.outputs[name] = OutputSpec("const", np.zeros(0, np.int32),
                                                np.zeros(0, np.int32),
                                                node.const)
            elif node.kind == N_LIN:
                rows, cfs, const = lin_parts(node)
                self.outputs[name] = OutputSpec(
                    "lin", np.asarray(rows, np.int32),
                    np.asarray(cfs, np.int32), const)
            else:
                self.outputs[name] = OutputSpec(
                    "wire", np.asarray([wire_row[node.name]], np.int32),
                    np.asarray([1], np.int32), 0)

    # ------------------------------------------------------------- sharding
    def _buf_sharding(self):
        from jax.sharding import NamedSharding, PartitionSpec as P
        return NamedSharding(self.mesh, P(None, "dp"))

    def _build_sharded_step(self):
        """One jitted mesh-sharded level step (see ``__init__`` docstring)."""
        import jax
        from jax.sharding import PartitionSpec as P

        mesh, keys, fast = self.mesh, self.keys, self.fast_keys
        buf_sharding = self._buf_sharding()

        if fast is not None and fast.orientation == "matmul":
            # GSPMD path: dp-sharded batch, tp-sharded key contraction.
            # The keys are traced arguments: closed over, XLA would bake
            # them into the executable as constants.
            from ..ops.blind_rotate import FastKeys
            from ..parallel.mesh import shard_fast_keys
            self.fast_keys = fast = shard_fast_keys(mesh, fast)

            @jax.jit
            def sharded(bsk, ksk, buf, *plan):
                fk = FastKeys(keys.params, bsk, ksk, "matmul")
                return _level_step(keys, fk, buf, *plan)

            def step(buf, *plan):
                return sharded(fast.bsk_kernels, fast.ksk_limbs, buf, *plan)

            return step

        # compact / generic: shard_map over dp with the plan and keys
        # replicated.  tp (if present in the mesh) is left unmapped — these
        # paths have no sharded contraction.
        if fast is not None:
            from ..ops.blind_rotate import FastKeys
            key_args = (fast.bsk_kernels, fast.ksk_limbs)
            orientation = fast.orientation

            def local(bsk, ksk, buf, *plan):
                fk = FastKeys(keys.params, bsk, ksk, orientation)
                return _level_step(keys, fk, buf, *plan)
        else:
            key_args = (keys.bsk, keys.ksk)

            def local(bsk, ksk, buf, *plan):
                k = TFHEKeys(params=keys.params, lwe_key=None,
                             glwe_key=None, bsk=bsk, ksk=ksk)
                return _level_step(k, None, buf, *plan)

        mapped = jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(), P(), P(None, "dp")) + (P(),) * 6,
            out_specs=P(None, "dp"), check_vma=False)
        jitted = jax.jit(mapped, out_shardings=buf_sharding)

        def step(buf, *plan):
            return jitted(*key_args, buf, *plan)

        return step

    def _build_staged_sharded_step(self):
        """Mesh-parallel staged level step: shard_map over dp with BOTH
        families' keys replicated (tp has no sharded contraction on this
        path)."""
        import functools

        import jax
        from jax.sharding import PartitionSpec as P

        mesh, sk, fast = self.mesh, self.keys, self.fast_keys
        buf_sharding = self._buf_sharding()

        if fast is not None:
            f1, f2 = fast
            from ..ops.blind_rotate import FastKeys
            key_args = (f1.bsk_kernels, f1.ksk_limbs,
                        f2.bsk_kernels, f2.ksk_limbs)
            o1, o2 = f1.orientation, f2.orientation

            def local(ns, b1, kl1, b2, kl2, buf, *plan):
                fk1 = FastKeys(sk.keys1.params, b1, kl1, o1)
                fk2 = FastKeys(sk.keys2.params, b2, kl2, o2)
                return _staged_level_step(sk.keys1, sk.keys2, fk1, fk2, ns,
                                          buf, *plan)
        else:
            key_args = (sk.keys1.bsk, sk.keys1.ksk,
                        sk.keys2.bsk, sk.keys2.ksk)

            def local(ns, b1, kl1, b2, kl2, buf, *plan):
                kk1 = TFHEKeys(params=sk.keys1.params, lwe_key=None,
                               glwe_key=None, bsk=b1, ksk=kl1)
                kk2 = TFHEKeys(params=sk.keys2.params, lwe_key=None,
                               glwe_key=None, bsk=b2, ksk=kl2)
                return _staged_level_step(kk1, kk2, None, None, ns,
                                          buf, *plan)

        cache = {}

        def step(n_splits, buf, *plan):
            if n_splits not in cache:
                fn = functools.partial(local, n_splits)
                mapped = jax.shard_map(
                    fn, mesh=mesh,
                    in_specs=(P(), P(), P(), P(), P(None, "dp"))
                    + (P(),) * 12,
                    out_specs=P(None, "dp"), check_vma=False)
                cache[n_splits] = jax.jit(mapped, out_shardings=buf_sharding)
            return cache[n_splits](*key_args, buf, *plan)

        return step

    # ----------------------------------------------------- local (1-device)
    def _build_local_step(self):
        """One JITTED single-device level step.

        Jitting collapses a level into one dispatched computation instead
        of one dispatch per op (which dominated small-batch circuit runs,
        PERF.md lesson 23); key material is passed as traced arguments (not
        closure constants) so XLA does not bake multi-GB keys into the
        executable."""
        import functools

        import jax

        keys, fast = self.keys, self.fast_keys
        if self.staged:
            sk = keys
            if fast is not None:
                f1, f2 = fast
                from ..ops.blind_rotate import FastKeys
                key_args = (f1.bsk_kernels, f1.ksk_limbs,
                            f2.bsk_kernels, f2.ksk_limbs)
                o1, o2 = f1.orientation, f2.orientation

                def local(ns, b1, kl1, b2, kl2, buf, *plan):
                    fk1 = FastKeys(sk.keys1.params, b1, kl1, o1)
                    fk2 = FastKeys(sk.keys2.params, b2, kl2, o2)
                    return _staged_level_step(sk.keys1, sk.keys2, fk1, fk2,
                                              ns, buf, *plan)
            else:
                key_args = (sk.keys1.bsk, sk.keys1.ksk,
                            sk.keys2.bsk, sk.keys2.ksk)

                def local(ns, b1, kl1, b2, kl2, buf, *plan):
                    kk1 = TFHEKeys(params=sk.keys1.params, lwe_key=None,
                                   glwe_key=None, bsk=b1, ksk=kl1)
                    kk2 = TFHEKeys(params=sk.keys2.params, lwe_key=None,
                                   glwe_key=None, bsk=b2, ksk=kl2)
                    return _staged_level_step(kk1, kk2, None, None, ns,
                                              buf, *plan)

            cache = {}

            def step(n_splits, buf, *plan):
                if n_splits not in cache:
                    cache[n_splits] = jax.jit(
                        functools.partial(local, n_splits))
                return cache[n_splits](*key_args, buf, *plan)

            return step

        if fast is not None:
            from ..ops.blind_rotate import FastKeys
            key_args = (fast.bsk_kernels, fast.ksk_limbs)
            orientation = fast.orientation

            def local(bsk, ksk, buf, *plan):
                fk = FastKeys(keys.params, bsk, ksk, orientation)
                return _level_step(keys, fk, buf, *plan)
        else:
            key_args = (keys.bsk, keys.ksk)

            def local(bsk, ksk, buf, *plan):
                k = TFHEKeys(params=keys.params, lwe_key=None,
                             glwe_key=None, bsk=bsk, ksk=ksk)
                return _level_step(k, None, buf, *plan)

        jitted = jax.jit(local)

        def step(buf, *plan):
            return jitted(*key_args, buf, *plan)

        return step

    def _build_local_scan(self):
        """Jitted multi-level step: lax.scan over a stack of consecutive
        same-shape levels.

        One jitted call per level costs a dispatch; thin-deep programs
        (ISCAS circuits at small batch, the 128-level EPFL adder) are
        dispatch-dominated.  Levels
        whose plan tensors share shapes (the power-of-two bucketing makes
        that the common case) are stacked on a leading axis and executed
        as ONE dispatched scan."""
        import functools

        import jax

        keys, fast = self.keys, self.fast_keys
        if self.staged:
            sk = keys
            if fast is not None:
                f1, f2 = fast
                from ..ops.blind_rotate import FastKeys
                key_args = (f1.bsk_kernels, f1.ksk_limbs,
                            f2.bsk_kernels, f2.ksk_limbs)
                o1, o2 = f1.orientation, f2.orientation

                def local(ns, b1, kl1, b2, kl2, buf, *stacked):
                    fk1 = FastKeys(sk.keys1.params, b1, kl1, o1)
                    fk2 = FastKeys(sk.keys2.params, b2, kl2, o2)

                    def body(b, xs):
                        return _staged_level_step(sk.keys1, sk.keys2, fk1,
                                                  fk2, ns, b, *xs), None
                    buf, _ = jax.lax.scan(body, buf, stacked)
                    return buf
            else:
                key_args = (sk.keys1.bsk, sk.keys1.ksk,
                            sk.keys2.bsk, sk.keys2.ksk)

                def local(ns, b1, kl1, b2, kl2, buf, *stacked):
                    kk1 = TFHEKeys(params=sk.keys1.params, lwe_key=None,
                                   glwe_key=None, bsk=b1, ksk=kl1)
                    kk2 = TFHEKeys(params=sk.keys2.params, lwe_key=None,
                                   glwe_key=None, bsk=b2, ksk=kl2)

                    def body(b, xs):
                        return _staged_level_step(kk1, kk2, None, None, ns,
                                                  b, *xs), None
                    buf, _ = jax.lax.scan(body, buf, stacked)
                    return buf

            cache = {}

            def scan_step(n_splits, buf, *stacked):
                if n_splits not in cache:
                    cache[n_splits] = jax.jit(
                        functools.partial(local, n_splits))
                return cache[n_splits](*key_args, buf, *stacked)

            return scan_step

        if fast is not None:
            from ..ops.blind_rotate import FastKeys
            key_args = (fast.bsk_kernels, fast.ksk_limbs)
            orientation = fast.orientation

            def local(bsk, ksk, buf, *stacked):
                fk = FastKeys(keys.params, bsk, ksk, orientation)

                def body(b, xs):
                    return _level_step(keys, fk, b, *xs), None
                buf, _ = jax.lax.scan(body, buf, stacked)
                return buf
        else:
            key_args = (keys.bsk, keys.ksk)

            def local(bsk, ksk, buf, *stacked):
                k = TFHEKeys(params=keys.params, lwe_key=None,
                             glwe_key=None, bsk=bsk, ksk=ksk)

                def body(b, xs):
                    return _level_step(k, None, b, *xs), None
                buf, _ = jax.lax.scan(body, buf, stacked)
                return buf

        jitted = jax.jit(local)

        def scan_step(buf, *stacked):
            return jitted(*key_args, buf, *stacked)

        return scan_step

    def _scan_groups_from(self, start: int):
        """Stack consecutive same-shape levels (from ``start``) for the
        scanned executor: list of (n_splits | None, tuple_of_stacked)."""
        plans = self._plan_arrays()
        groups: list = []
        cur_key, cur = None, []
        for lv in range(start, len(self.levels)):
            plan = self.levels[lv]
            if self.staged:
                key = (plan.n_splits,) + tuple(x.shape
                                               for x in plans[lv])
            else:
                key = tuple(x.shape for x in plans[lv])
            if key != cur_key and cur:
                groups.append((cur_key, cur))
                cur = []
            cur_key = key
            cur.append(plans[lv])
        if cur:
            groups.append((cur_key, cur))
        out = []
        for key, members in groups:
            stacked = tuple(jnp.stack([m[i] for m in members])
                            for i in range(len(members[0])))
            ns = key[0] if self.staged else None
            out.append((ns, stacked, len(members)))
        return out

    def _plan_arrays(self):
        """Per-level plan tensors as device arrays, uploaded ONCE (not per
        level per repeat)."""
        if self._plan_device is None:
            out = []
            for plan in self.levels:
                if self.staged:
                    out.append(tuple(jnp.asarray(x) for x in (
                        plan.wire_idx1, plan.coefs1, plan.consts1, plan.tvs1,
                        plan.posts1, plan.out_rows1, plan.wire_idx2,
                        plan.coefs2, plan.consts2, plan.tvs2, plan.posts2,
                        plan.out_rows)))
                else:
                    out.append(tuple(jnp.asarray(x) for x in (
                        plan.wire_idx, plan.coefs, plan.consts,
                        plan.test_polys, plan.posts, plan.out_rows)))
            self._plan_device = out
        return self._plan_device

    # ---------------------------------------------------------------- run
    def encrypt_inputs(self, values: dict[str, np.ndarray],
                       rng: np.random.Generator) -> jnp.ndarray:
        """Build the initial wire buffer [num_wires, V, kN+1].

        All inputs are encrypted in ONE batched device call.
        """
        v = len(next(iter(values.values()))) if values else 1
        d = self.params.big_dim + 1
        buf = jnp.zeros((self.num_wires, v, d), dtype=np.int32)
        names = list(self.input_rows)
        if names:
            # staged executor: inputs are produced pre-scaled to their
            # consumers' gcd torus multiple (scaled wire encodings)
            def scaled(n):
                vals = np.asarray(values[n], dtype=np.int64)
                if self.staged:
                    vals = vals * int(self.row_scale[self.input_rows[n]])
                return vals
            flat = np.concatenate([scaled(n) for n in names])
            key_holder = self.keys.keys1 if self.staged else self.keys
            from ..tfhe.encrypt import encode, lwe_encrypt
            cts = lwe_encrypt(
                key_holder.extracted_key, encode(flat, self.params),
                key_holder.params.glwe_noise_std, rng)
            cts = cts.reshape(len(names), v, d)
            rows = jnp.asarray([self.input_rows[n] for n in names])
            buf = buf.at[rows].set(cts)
        if self.mesh is not None:
            import jax
            dp = self.mesh.shape["dp"]
            assert v % dp == 0, \
                f"batch {v} must be divisible by the dp axis ({dp})"
            buf = jax.device_put(buf, self._buf_sharding())
        return buf

    def run(self, buf: jnp.ndarray, checkpoint: str | None = None,
            checkpoint_every: int | None = None,
            checkpoint_budget: float = 0.1) -> jnp.ndarray:
        """Execute all levels; returns the filled wire buffer.

        ``checkpoint``: optional ``.npz`` path.  The wire buffer is saved
        periodically, and a matching file resumes the run from the level
        after its snapshot — the analogue of the reference harness's
        make-level file-existence resume (SURVEY.md §5 "Checkpoint /
        resume").

        ``checkpoint_every``: fixed level interval; default None =
        ADAPTIVE.  A snapshot reads the whole wire buffer back to host,
        which for fast circuits can dwarf the compute.  Adaptive mode
        primes a save-cost estimate from the buffer size, then keeps
        total snapshot time under
        ``checkpoint_budget`` of the elapsed run: fast circuits never
        checkpoint, deep Trivium/Kreyvium streams checkpoint roughly every
        ``save_cost / budget`` seconds of compute.
        """
        import time as _time
        self._run_t0 = _time.time()
        self._save_spent, self._save_cost_est = 0.0, None
        start = 0
        if checkpoint is not None:
            try:
                with np.load(checkpoint) as z:
                    if z["num_levels"] == len(self.levels) \
                            and z["buf"].shape == tuple(buf.shape):
                        start = int(z["level"]) + 1
                        buf = jnp.asarray(z["buf"])
                        if self.mesh is not None:
                            import jax
                            buf = jax.device_put(buf, self._buf_sharding())
            except FileNotFoundError:
                pass
        if self._sharded_step is None and checkpoint is None:
            # scanned path: consecutive same-shape levels run as one
            # dispatched lax.scan (dispatch-dominated thin-deep programs)
            if self._local_scan is None:
                self._local_scan = self._build_local_scan()
            if self._scan_cache.get("start") != start:
                self._scan_cache = {"start": start,
                                    "groups": self._scan_groups_from(start)}
            for ns, stacked, _n in self._scan_cache["groups"]:
                if self.staged:
                    buf = self._local_scan(ns, buf, *stacked)
                else:
                    buf = self._local_scan(buf, *stacked)
            return buf
        step = self._sharded_step
        if step is None:
            if self._local_step is None:
                self._local_step = self._build_local_step()
            step = self._local_step
        plans = self._plan_arrays()
        for lv, plan in enumerate(self.levels):
            if lv < start:
                continue
            if self.staged:
                buf = step(plan.n_splits, buf, *plans[lv])
            else:
                buf = step(buf, *plans[lv])
            if checkpoint is not None and lv + 1 < len(self.levels):
                if checkpoint_every is not None:
                    due = (lv + 1) % checkpoint_every == 0
                else:
                    if self._save_cost_est is None:
                        # prime: an uncompressed .npz write at ~1 GB/s;
                        # replaced by the measured cost after the first save
                        nbytes = int(np.prod(buf.shape)) * 4
                        self._save_cost_est = nbytes / 1e9
                    elapsed = _time.time() - self._run_t0
                    due = (self._save_spent + self._save_cost_est
                           <= checkpoint_budget * elapsed)
                if due:
                    t0 = _time.time()
                    np.savez(checkpoint, buf=np.asarray(buf), level=lv,
                             num_levels=len(self.levels))
                    cost = _time.time() - t0
                    self._save_spent += cost
                    self._save_cost_est = cost
                    import sys as _sys
                    print(f"# checkpoint level {lv}: {cost:.2f}s "
                          f"(total {self._save_spent:.2f}s of "
                          f"{_time.time() - self._run_t0:.2f}s)",
                          file=_sys.stderr)
        return buf

    def output_ciphertexts(self, buf: jnp.ndarray) -> tuple[list[str],
                                                             jnp.ndarray]:
        """Names and ciphertexts [O, V, d] of the non-constant outputs: ONE
        batched gather + lincomb device call for all of them."""
        params = self.params
        names = [n for n, s in self.outputs.items() if s.kind != "const"]
        if not names:
            return names, jnp.zeros((0, buf.shape[1], buf.shape[2]), I32)
        t_max = max(1, max(len(self.outputs[n].wire_idx) for n in names))
        idx = np.full((len(names), t_max), self.dummy_row, dtype=np.int32)
        cfs = np.zeros((len(names), t_max), dtype=np.int32)
        consts = np.zeros(len(names), dtype=np.int32)
        for o, name in enumerate(names):
            spec = self.outputs[name]
            idx[o, :len(spec.wire_idx)] = spec.wire_idx
            cfs[o, :len(spec.coefs)] = spec.coefs
            consts[o] = np.int64(spec.const * params.delta) \
                .astype(np.uint32).astype(np.int32)
        cts = buf[jnp.asarray(idx)]                        # [O, T, V, d]
        lin = jnp.einsum("ot,otvd->ovd", jnp.asarray(cfs), cts,
                         preferred_element_type=I32)
        return names, lin.at[:, :, -1].add(jnp.asarray(consts)[:, None])

    def decrypt_outputs(self, buf: jnp.ndarray) -> dict[str, np.ndarray]:
        """Decrypt every output (constants come from the plan)."""
        v = buf.shape[1]
        out = {name: np.full(v, spec.const, dtype=np.int64)
               for name, spec in self.outputs.items() if spec.kind == "const"}
        names, lin = self.output_ciphertexts(buf)
        if not names:
            return out
        phases = np.asarray(lwe_phase(self.keys.extracted_key,
                                      lin.reshape(-1, lin.shape[-1])))
        decoded = decode(phases, self.params).reshape(len(names), v)
        for o, name in enumerate(names):
            out[name] = decoded[o]
        return out

    def run_cleartext(self, values: dict[str, np.ndarray],
                      seed: int = 0) -> dict[str, np.ndarray]:
        """encrypt → run → decrypt convenience wrapper."""
        rng = np.random.default_rng(seed)
        buf = self.encrypt_inputs(values, rng)
        buf = self.run(buf)
        return self.decrypt_outputs(buf)


def staged_probe(prog: LutProgram, p: int
                 ) -> tuple[float, float, dict[str, int]]:
    """Keyless staged-compile probe: (eff_norm1, eff_norm2, route_counts).

    Compiles ``prog`` onto the dual-family plan with dummy parameter shells
    (no key material is touched at compile time) and returns the
    post-scaling effective squared norms the noise model needs
    (``optimize_staged(p, eff1, eff2)``) plus the per-routing node counts
    ({"f1", "f2", "split"}) for honest whole-program cost accounting.
    Raises ValueError when the program has nodes the staged pipeline
    cannot realize.
    """
    from ..tfhe.params import TFHEParams as TP
    from ..tfhe.staged import SELECT_P, StagedKeys

    p1 = p // 2 if p >= 32 else p
    p2 = SELECT_P if p % SELECT_P == 0 else p // 2

    def shell(pp, k, N):
        return TFHEKeys(params=TP(p=pp, lwe_dim=16, glwe_dim=k, poly_size=N,
                                  bsk_level=1, bsk_base_log=8, ksk_level=1,
                                  ksk_base_log=8, lwe_noise_std=0.0,
                                  glwe_noise_std=0.0),
                        lwe_key=None, glwe_key=None, bsk=None, ksk=None)

    probe = CircuitExecutor(prog, StagedKeys(p=p, keys1=shell(p1, 1, 2048),
                                             keys2=shell(p2, 2, 1024)))
    return probe.eff_norm1, probe.eff_norm2, probe.route_counts


def staged_level_routes(prog: LutProgram, p: int) -> list[tuple[int, int,
                                                                int]]:
    """Per-level (n_split, n_f1, n_f2) routing profile of the staged plan
    (same keyless probe as :func:`staged_probe`; raises ValueError when not
    staged-realizable).  Feeds the launch-aware runtime predictor
    (optimizer/runtime_model.py): each level issues one fam1 call batched
    ``bucket(ns + nf1)`` and one fam2 call batched ``bucket(ns + nf2)``."""
    from ..tfhe.params import TFHEParams as TP
    from ..tfhe.staged import SELECT_P, StagedKeys

    p1 = p // 2 if p >= 32 else p
    p2 = SELECT_P if p % SELECT_P == 0 else p // 2

    def shell(pp, k, N):
        return TFHEKeys(params=TP(p=pp, lwe_dim=16, glwe_dim=k, poly_size=N,
                                  bsk_level=1, bsk_base_log=8, ksk_level=1,
                                  ksk_base_log=8, lwe_noise_std=0.0,
                                  glwe_noise_std=0.0),
                        lwe_key=None, glwe_key=None, bsk=None, ksk=None)

    probe = CircuitExecutor(prog, StagedKeys(p=p, keys1=shell(p1, 1, 2048),
                                             keys2=shell(p2, 2, 1024)))
    return probe.level_routes


def native_level_boots(prog: LutProgram) -> list[int]:
    """Per-level bootstrap counts of the native single-family plan (the
    level assignment of :meth:`CircuitExecutor._compile`, keyless)."""
    level: dict[str, int] = {}
    counts: dict[int, int] = {}
    for node in prog.nodes:
        if node.kind == N_INPUT:
            level[node.name] = 0
        elif node.kind == N_LIN:
            level[node.name] = max((level[v.name] for _, v in node.terms),
                                   default=0)
        elif node.kind == N_BOOT:
            lv = level[node.src.name] + 1
            level[node.name] = lv
            counts[lv] = counts.get(lv, 0) + 1
    return [counts[lv] for lv in sorted(counts)]


def _lincomb_flat(buf, wire_idx, coefs, consts):
    """Gather + lincomb -> v-major flat batch [v*nb, d]."""
    gathered = buf[wire_idx]                              # [nb, T, V, d]
    lin = jnp.einsum("nt,ntvd->nvd", coefs, gathered,
                     preferred_element_type=I32)
    lin = lin.at[:, :, -1].add(consts[:, None])
    v = buf.shape[1]
    return jnp.transpose(lin, (1, 0, 2)).reshape(v * lin.shape[0],
                                                 lin.shape[-1])


def _run_fbs(keys: TFHEKeys, fast_keys, flat, tvs, posts, v):
    tvs_flat = jnp.tile(tvs, (v, 1))
    posts_flat = jnp.tile(posts, (v,))
    if fast_keys is not None:
        from ..ops.blind_rotate import functional_bootstrap_fast
        return functional_bootstrap_fast(fast_keys, flat, tvs_flat,
                                         posts_flat)
    return functional_bootstrap(keys, flat, tvs_flat, posts_flat)


def _staged_level_step(keys1, keys2, fast1, fast2, n_splits, buf,
                       wi1, cf1, cs1, tvs1, ps1, out_rows1,
                       wi2, cf2, cs2, tvs2, ps2, out_rows):
    """One staged level: fam1 call (split stage-1 + f1 singles), then fam2
    call (split stage-2 consuming G + f2 singles), one scatter each."""
    _, v, d = buf.shape
    nb1, nb2 = wi1.shape[0], wi2.shape[0]
    g = None
    if nb1:
        flat1 = _lincomb_flat(buf, wi1, cf1, cs1)
        out1 = _run_fbs(keys1, fast1, flat1, tvs1, ps1, v)
        out1 = jnp.transpose(out1.reshape(v, nb1, d), (1, 0, 2))
        g = out1[:n_splits]                               # [ns, V, d]
        # f1 singles scatter (split/padding rows land on the dummy row)
        buf = buf.at[out_rows1].set(out1)
    if nb2:
        flat2 = _lincomb_flat(buf, wi2, cf2, cs2)
        if g is not None and n_splits:
            g_flat = jnp.concatenate(
                [g, jnp.zeros((nb2 - n_splits, v, d), dtype=I32)], axis=0)
            flat2 = flat2 + jnp.transpose(g_flat, (1, 0, 2)).reshape(
                v * nb2, d)
        out2 = _run_fbs(keys2, fast2, flat2, tvs2, ps2, v)
        out2 = jnp.transpose(out2.reshape(v, nb2, d), (1, 0, 2))
        buf = buf.at[out_rows].set(out2)
    return buf


def _level_step(keys: TFHEKeys, fast_keys, buf, wire_idx, coefs, consts,
                tvs, posts, out_rows):
    """One level: fused lincombs + one batched FBS + scatter of results.

    The kernel batch is flattened V-major so a dp-sharded V axis stays the
    leading (sharded) axis of the bootstrap batch — no cross-shard
    data movement when the executor runs under a mesh."""
    nb, t_max = wire_idx.shape
    _, v, d = buf.shape
    gathered = buf[wire_idx]                              # [nb, T, V, d]
    lin = jnp.einsum("nt,ntvd->nvd", coefs, gathered,
                     preferred_element_type=I32)
    lin = lin.at[:, :, -1].add(consts[:, None])
    flat = jnp.transpose(lin, (1, 0, 2)).reshape(v * nb, d)
    tvs_flat = jnp.tile(tvs, (v, 1))
    posts_flat = jnp.tile(posts, (v,))
    if fast_keys is not None:
        from ..ops.blind_rotate import functional_bootstrap_fast
        fresh = functional_bootstrap_fast(fast_keys, flat, tvs_flat,
                                          posts_flat)
    else:
        fresh = functional_bootstrap(keys, flat, tvs_flat, posts_flat)
    fresh = jnp.transpose(fresh.reshape(v, nb, d), (1, 0, 2))
    return buf.at[out_rows].set(fresh)
