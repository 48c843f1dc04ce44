"""Target IR: integer linear combinations + functional bootstraps.

``LutProgram`` is the framework's mapped-program IR — the exact program shape
TFHE can execute cheaply: integer lincombs over encrypted bits (nearly free)
and functional bootstraps (the expensive primitive).  It mirrors the observable
semantics of the reference's ``LutExecEnv``
(``/root/reference/fbs_mapper/fbs_exec_env.py:11-276``):

* three node types: input / linear-product / bootstrap (+ free-standing consts),
* builder-level CSE on structurally identical instructions
  (reference ``fbs_exec_env.py:93-100``),
* flattening of nested linear products and const folding
  (reference ``fbs_exec_env.py:131-145``),
* per-node value upper-bound tracking, with the invariant that every bootstrap
  table has exactly ``max_val + 1`` entries (reference ``fbs_exec_env.py:76-91,
  147-152``),
* vectorized cleartext evaluation — the oracle the homomorphic executor
  must reproduce bit-exactly (reference ``fbs_exec_env.py:208-229``),
* ``stats`` with the ``norm2_linprod`` metric that feeds the TFHE noise/cost
  model (reference ``fbs_exec_env.py:245-276``),
* ``.fbs`` pretty-print and ``.lbf`` serialization (reference
  ``fbs_exec_env.py:158-206``), plus an ``.lbf`` parser (new: the runtime
  consumes serialized programs directly).
"""

from __future__ import annotations

import sys
import textwrap
from typing import Sequence

import numpy as np

__all__ = ["LutNode", "LutProgram", "parse_lbf"]

N_CONST = "const"
N_INPUT = "input"
N_LIN = "lin"
N_BOOT = "boot"


class LutNode:
    __slots__ = ("nid", "name", "kind", "terms", "const", "src", "table",
                 "max_val")

    def __init__(self, nid: int, name: str, kind: str):
        self.nid = nid
        self.name = name
        self.kind = kind
        self.terms: tuple[tuple[int, "LutNode"], ...] = ()
        self.const = 0
        self.src: "LutNode | None" = None
        self.table: tuple[int, ...] = ()
        self.max_val = 0

    def __repr__(self) -> str:
        if self.kind == N_CONST:
            return str(self.const)
        if self.kind == N_INPUT:
            return f"Input({self.name})"
        if self.kind == N_LIN:
            body = " + ".join(f"{c} * {v.name}" for c, v in self.terms)
            tail = f" + {self.const}" if self.const != 0 else ""
            return f"{body}{tail}"
        return f"Bootstrap({self.src.name}, {list(self.table)})"


class LutProgram:
    def __init__(self, merge_linear_prods: bool = True,
                 fbs_size: int | None = None):
        self.nodes: list[LutNode] = []          # topological order
        self.outputs: dict[str, LutNode] = {}
        # FBS size p the mapper targeted.  Needed to re-execute the program:
        # a table of length tau in (p, 2p] relies on the negacyclic identity
        # AT THAT p (``table[x] + table[x+p]`` constant) — it is not
        # recoverable from the table length alone.
        self.fbs_size = fbs_size
        self._merge_linear_prods = merge_linear_prods
        self._cse: dict[tuple, LutNode] = {}
        self._auto_id = 0

    def min_fbs_size(self) -> int:
        """Smallest p at which every bootstrap table is realizable
        (direct lookup for tau <= p, or one of the negacyclic half-table
        modes for p < tau <= 2p — reference ``map_to_fbs.py:81-98``)."""
        tabs = [n.table for n in self.nodes if n.kind == N_BOOT]
        max_tau = max((len(t) for t in tabs), default=2)

        def ok(table, p):
            tau = len(table)
            if tau <= p:
                return True
            if tau > 2 * p:
                return False
            c = table[0] + table[p]
            return all(table[x] + table[x + p] == c
                       for x in range(tau - p))

        for p in range((max_tau + 1) // 2, max_tau + 1):
            if all(ok(t, p) for t in tabs):
                return max(2, p)
        return max(2, max_tau)

    # ------------------------------------------------------------------ build
    def _intern(self, key: tuple, make) -> LutNode:
        node = self._cse.get(key)
        if node is None:
            self._auto_id += 1
            node = make(f"m{self._auto_id}")
            self._cse[key] = node
            self.nodes.append(node)
        return node

    def input(self, name: str) -> LutNode:
        def make(_auto):
            node = LutNode(len(self.nodes), name, N_INPUT)
            node.max_val = 1
            return node
        return self._intern(("inp", name), make)

    def const(self, value: int) -> LutNode:
        # Free-standing constant; never part of the instruction stream
        # (mirrors reference ``fbs_exec_env.py:105-106``).
        node = LutNode(-1, str(value), N_CONST)
        node.const = int(value)
        node.max_val = int(value)
        return node

    def linear(self, coefs: Sequence[int], vals: Sequence[LutNode],
               const_coef: int = 0) -> LutNode:
        """Integer lincomb Σ coef·val + const, flattening nested lincombs."""
        terms: list[tuple[int, LutNode]] = []
        const = int(const_coef)
        for coef, val in zip(coefs, vals):
            assert isinstance(val, LutNode), "expected LutNode"
            coef = int(coef)
            if val.kind == N_LIN and self._merge_linear_prods:
                terms.extend((coef * c1, v1) for c1, v1 in val.terms)
                const += coef * val.const
            elif val.kind == N_CONST:
                const += coef * val.const
            else:
                terms.append((coef, val))

        key = ("lin", tuple((c, v.nid) for c, v in terms), const)

        def make(auto_name):
            node = LutNode(len(self.nodes), auto_name, N_LIN)
            node.terms = tuple(terms)
            node.const = const
            node.max_val = const + sum(max(0, c * v.max_val)
                                       for c, v in terms)
            return node
        return self._intern(key, make)

    def bootstrap(self, val: LutNode, table: Sequence[int]) -> LutNode:
        assert isinstance(val, LutNode), "expected LutNode"
        table = tuple(int(t) for t in table)
        assert len(table) == val.max_val + 1, (
            f"bootstrap table has {len(table)} entries but input "
            f"{val.name} has value bound {val.max_val}")
        assert min(table) == 0, "bootstrap table must contain 0"

        key = ("boot", val.nid, table)

        def make(auto_name):
            node = LutNode(len(self.nodes), auto_name, N_BOOT)
            node.src = val
            node.table = table
            node.max_val = max(table)
            return node
        return self._intern(key, make)

    def output(self, name: str, val: LutNode) -> None:
        assert isinstance(val, LutNode), "expected LutNode"
        self.outputs[name] = val

    # ------------------------------------------------------------------ eval
    def eval(self, input_values: dict[str, np.ndarray | Sequence[int]]
             ) -> dict[str, np.ndarray]:
        """Cleartext oracle; homomorphic execution must decrypt to this."""
        wires: dict[str, np.ndarray] = {"0": np.int64(0), "1": np.int64(1)}
        for node in self.nodes:
            if node.kind == N_INPUT:
                val = np.asarray(input_values[node.name]).reshape(-1)
            elif node.kind == N_LIN:
                val = np.int64(node.const)
                for c, v in node.terms:
                    val = val + c * wires[v.name]
            else:  # bootstrap: exact LUT gather
                val = np.asarray(node.table, dtype=np.int64)[wires[node.src.name]]
            wires[node.name] = val
        return {name: wires[out.name] for name, out in self.outputs.items()}

    # ------------------------------------------------------------- transforms
    def remove_dangling_nodes(self) -> None:
        live = {out.name for out in self.outputs.values()}
        for node in reversed(self.nodes):
            if node.name in live:
                if node.kind == N_LIN:
                    live.update(v.name for _, v in node.terms)
                elif node.kind == N_BOOT:
                    live.add(node.src.name)
        self.nodes = [n for n in self.nodes if n.name in live]

    # ------------------------------------------------------------------ info
    def stats(self) -> dict:
        nb_inp = nb_lin = nb_boot = 0
        max_lut_size = 0
        norm2: dict[str, int] = {}
        for node in self.nodes:
            if node.kind == N_INPUT:
                nb_inp += 1
                norm2[node.name] = 1
            elif node.kind == N_LIN:
                nb_lin += 1
                norm2[node.name] = sum(c * c * norm2[v.name]
                                       for c, v in node.terms)
            else:
                nb_boot += 1
                max_lut_size = max(max_lut_size, len(node.table))
                norm2[node.name] = 1
        return dict(
            nb_inp=nb_inp,
            nb_linprod=nb_lin,
            nb_bootstrap=nb_boot,
            max_lut_size=max_lut_size,
            norm2_linprod=max(norm2.values()) if norm2 else 0,
            nb_out=len(self.outputs),
        )

    def print(self, os=sys.stdout, show_inputs: bool = False,
              show_outputs: bool = False) -> None:
        for node in self.nodes:
            if node.kind == N_INPUT and not show_inputs:
                continue
            print(f"{node.name} = {node!r}", file=os)
        if show_outputs:
            for name, val in self.outputs.items():
                print(f"Output {name} = {val.name}", file=os)

    # ------------------------------------------------------------------- I/O
    def write_lbf(self, os=sys.stdout) -> None:
        """Serialize in the reference `.lbf` format
        (``fbs_exec_env.py:170-206``): ``.inputs/.outputs`` headers, one
        ``.lincomb`` stanza (inputs sorted by name) or ``.bootstrap`` stanza
        per node, and one identity ``.lincomb`` per output."""
        input_names = [n.name for n in self.nodes if n.kind == N_INPUT]

        if self.fbs_size is not None:
            # superset stanza over the reference format: the mapper's FBS
            # size, required to re-execute negacyclic half-tables
            print(f".fbs_size {self.fbs_size}", file=os)
        line = f".inputs {' '.join(input_names)}"
        print(" \\\n ".join(textwrap.wrap(line)), file=os)
        line = f".outputs {' '.join(map(str, self.outputs.keys()))}"
        print(" \\\n ".join(textwrap.wrap(line)), file=os)

        for node in self.nodes:
            if node.kind == N_INPUT:
                continue
            if node.kind == N_LIN:
                terms = sorted(node.terms, key=lambda cv: cv[1].name)
                names = " ".join(v.name for _, v in terms)
                coefs = " ".join(str(c) for c, _ in terms)
                const = f"{node.const}" if node.const != 0 else ""
                print(f".lincomb {names} {node.name}", file=os)
                print(f"{coefs} {const}", file=os)
            else:
                print(f".bootstrap {node.src.name} {node.name}", file=os)
                print("".join(map(str, node.table)), file=os)

        for out, val in self.outputs.items():
            print(f".lincomb {val.name} {out}", file=os)
            print("1", file=os)


def parse_lbf(text: str) -> LutProgram:
    """Parse a serialized `.lbf` program back into a ``LutProgram``.

    Inverse of :meth:`LutProgram.write_lbf`.  Multi-digit bootstrap tables are
    not representable in the digit-string format for values > 9; the format
    (like the reference's) stores one digit per entry.
    """
    # Undo line continuations.
    text = text.replace("\\\n", " ")
    prog = LutProgram()
    wires: dict[str, LutNode] = {}
    outputs: list[str] = []
    out_alias: dict[str, str] = {}

    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    i = 0
    while i < len(lines):
        parts = lines[i].split()
        if parts[0] == ".fbs_size":
            prog.fbs_size = int(parts[1])
            i += 1
        elif parts[0] == ".inputs":
            for name in parts[1:]:
                wires[name] = prog.input(name)
            i += 1
        elif parts[0] == ".outputs":
            outputs.extend(parts[1:])
            i += 1
        elif parts[0] == ".lincomb":
            srcs, dst = parts[1:-1], parts[-1]
            row = lines[i + 1].split()
            coefs = [int(c) for c in row[:len(srcs)]]
            const = int(row[len(srcs)]) if len(row) > len(srcs) else 0
            vals = [wires[s] if s in wires else prog.const(int(s))
                    for s in srcs]
            if dst in outputs and len(srcs) == 1 and coefs == [1] \
                    and const == 0:
                # output identity stanza
                out_alias[dst] = srcs[0]
            else:
                wires[dst] = prog.linear(coefs, vals, const_coef=const)
            i += 2
        elif parts[0] == ".bootstrap":
            src, dst = parts[1], parts[2]
            table = [int(ch) for ch in lines[i + 1]]
            wires[dst] = prog.bootstrap(wires[src], table)
            i += 2
        else:
            raise ValueError(f"unknown .lbf stanza: {lines[i]!r}")

    for name in outputs:
        src = out_alias.get(name, name)
        if src in wires:
            prog.output(name, wires[src])
        else:
            prog.output(name, prog.const(int(src)))
    return prog
