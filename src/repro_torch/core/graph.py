"""Logic-graph IR for SIMDRAM Step 1 (paper §4.1, Appendix A).

Two directed-acyclic graph forms are used, exactly as in the paper:

* AOIG — AND-OR-Inverter graph: nodes are 2-input AND / OR primitives,
  edges may be complemented (the "inverter" lives on the edge).
* MIG  — Majority-Inverter graph: nodes are 3-input MAJ primitives,
  edges may be complemented.

Both share one node/edge representation here; ``kind`` distinguishes them.
Edges are encoded as signed literals referring to node ids, exactly like an
AIG literal: ``lit = node_id << 1 | complemented``.  Node id 0 is reserved
for the constant FALSE, so literal 0 = const0 and literal 1 = const1 — this
mirrors the paper's C-group rows C0/C1.
"""
from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Literals
# ---------------------------------------------------------------------------

CONST0 = 0  # literal: constant 0 (C0 row)
CONST1 = 1  # literal: constant 1 (C1 row)


def lit(node_id: int, neg: bool = False) -> int:
    return (node_id << 1) | int(neg)


def lit_node(literal: int) -> int:
    return literal >> 1


def lit_neg(literal: int) -> bool:
    return bool(literal & 1)


def lit_not(literal: int) -> int:
    return literal ^ 1


# ---------------------------------------------------------------------------
# Nodes
# ---------------------------------------------------------------------------

PI = "pi"
AND = "and"
OR = "or"
MAJ = "maj"
CONST = "const"


@dataclasses.dataclass(frozen=True)
class Node:
    kind: str
    fanin: tuple[int, ...] = ()  # literals
    name: str = ""               # for PIs: stable operand name


class LogicGraph:
    """A mutable DAG of logic nodes with structural hashing.

    Node 0 is always the constant-0 node.  Primary inputs are created with
    :meth:`input`; gates with :meth:`gate_and` / :meth:`gate_or` /
    :meth:`gate_maj`.  Outputs are named literals.
    """

    def __init__(self) -> None:
        self.nodes: list[Node] = [Node(CONST)]
        self.outputs: list[tuple[str, int]] = []  # (name, literal)
        self._strash: dict[tuple, int] = {}
        self._input_ids: dict[str, int] = {}

    # -- construction -------------------------------------------------------
    def input(self, name: str) -> int:
        """Create (or fetch) a primary input; returns its literal."""
        if name in self._input_ids:
            return lit(self._input_ids[name])
        nid = len(self.nodes)
        self.nodes.append(Node(PI, name=name))
        self._input_ids[name] = nid
        return lit(nid)

    def _mk(self, kind: str, fanin: tuple[int, ...]) -> int:
        key = (kind, fanin)
        found = self._strash.get(key)
        if found is not None:
            return lit(found)
        nid = len(self.nodes)
        self.nodes.append(Node(kind, fanin=fanin))
        self._strash[key] = nid
        return lit(nid)

    def gate_and(self, a: int, b: int) -> int:
        # constant folding
        if a == CONST0 or b == CONST0:
            return CONST0
        if a == CONST1:
            return b
        if b == CONST1:
            return a
        if a == b:
            return a
        if a == lit_not(b):
            return CONST0
        a, b = min(a, b), max(a, b)
        return self._mk(AND, (a, b))

    def gate_or(self, a: int, b: int) -> int:
        return lit_not(self.gate_and(lit_not(a), lit_not(b)))

    def gate_or_node(self, a: int, b: int) -> int:
        """An explicit OR node (kept distinct for AOIG fidelity)."""
        if a == CONST1 or b == CONST1:
            return CONST1
        if a == CONST0:
            return b
        if b == CONST0:
            return a
        if a == b:
            return a
        if a == lit_not(b):
            return CONST1
        a, b = min(a, b), max(a, b)
        return self._mk(OR, (a, b))

    def gate_xor(self, a: int, b: int) -> int:
        """XOR via AOIG structure: (a|b) & ~(a&b)."""
        return self.gate_and(self.gate_or_node(a, b), lit_not(self.gate_and(a, b)))

    def gate_mux(self, sel: int, t: int, f: int) -> int:
        """sel ? t : f   as AOIG."""
        return self.gate_or_node(self.gate_and(sel, t), self.gate_and(lit_not(sel), f))

    def gate_maj(self, a: int, b: int, c: int) -> int:
        """3-input majority with full local simplification (MIG axioms)."""
        ins = [a, b, c]
        # Ω.M (majority): M(x,x,z)=x ; M(x,~x,z)=z
        for i in range(3):
            for j in range(i + 1, 3):
                if ins[i] == ins[j]:
                    return ins[i]
                if ins[i] == lit_not(ins[j]):
                    return ins[3 - i - j]
        # constants: M(a,b,0)=AND, M(a,b,1)=OR handled by keeping the node —
        # but M with two constants folds above (0,1 are complements).
        # Ω.I (inverter propagation): canonicalize so ≤1 fanin is negated by
        # preferring the form with fewer complemented edges; M(~a,~b,~c)=~M(a,b,c)
        ncomp = sum(lit_neg(x) for x in ins)
        out_neg = False
        if ncomp >= 2:
            # try full complement: only exact when all three flip (Ω.I), so flip
            # all and complement the output.
            ins = [lit_not(x) for x in ins]
            out_neg = True
        ins.sort()
        result = self._mk(MAJ, tuple(ins))
        return lit_not(result) if out_neg else result

    def add_output(self, name: str, literal: int) -> None:
        self.outputs.append((name, literal))

    # -- queries ------------------------------------------------------------
    @property
    def num_gates(self) -> int:
        return sum(1 for n in self.nodes if n.kind in (AND, OR, MAJ))

    def gate_ids(self) -> list[int]:
        return [i for i, n in enumerate(self.nodes) if n.kind in (AND, OR, MAJ)]

    def input_names(self) -> list[str]:
        return [n.name for n in self.nodes if n.kind == PI]

    def topo_order(self) -> list[int]:
        """Topological order of live node ids (outputs' transitive fanin)."""
        seen: set[int] = set()
        order: list[int] = []

        def visit(nid: int) -> None:
            if nid in seen:
                return
            seen.add(nid)
            for f in self.nodes[nid].fanin:
                visit(lit_node(f))
            order.append(nid)

        for _, out in self.outputs:
            visit(lit_node(out))
        return order

    def live_gate_count(self) -> int:
        return sum(1 for nid in self.topo_order() if self.nodes[nid].kind in (AND, OR, MAJ))

    def depth(self) -> int:
        level: dict[int, int] = {}
        for nid in self.topo_order():
            node = self.nodes[nid]
            if node.kind in (PI, CONST):
                level[nid] = 0
            else:
                level[nid] = 1 + max(level[lit_node(f)] for f in node.fanin)
        return max((level[lit_node(o)] for _, o in self.outputs), default=0)

    # -- evaluation (bit-parallel on python ints) ----------------------------
    def evaluate(self, assignment: dict[str, int], mask: int = -1) -> dict[str, int]:
        """Evaluate all outputs.  ``assignment`` maps PI name → int whose bits
        are independent SIMD lanes (bit-parallel evaluation, like bitlines).
        ``mask`` limits the lane width."""
        val: dict[int, int] = {0: 0}
        for nid in self.topo_order():
            node = self.nodes[nid]
            if node.kind == CONST:
                val[nid] = 0
            elif node.kind == PI:
                val[nid] = assignment[node.name] & mask
            else:
                f = [self._litval(val, x, mask) for x in node.fanin]
                if node.kind == AND:
                    val[nid] = f[0] & f[1]
                elif node.kind == OR:
                    val[nid] = f[0] | f[1]
                else:  # MAJ
                    val[nid] = (f[0] & f[1]) | (f[0] & f[2]) | (f[1] & f[2])
        return {name: self._litval(val, o, mask) for name, o in self.outputs}

    @staticmethod
    def _litval(val: dict[int, int], literal: int, mask: int) -> int:
        v = val[lit_node(literal)]
        return (~v & mask) if lit_neg(literal) else (v & mask)

    def clone(self) -> "LogicGraph":
        g = LogicGraph()
        g.nodes = list(self.nodes)
        g.outputs = list(self.outputs)
        g._strash = dict(self._strash)
        g._input_ids = dict(self._input_ids)
        return g
