"""Step 1 of the SIMDRAM framework: AOIG → optimized MIG (paper §4.1, App. A).

The transformation has two parts, exactly as the paper describes:

1. *Naive substitution*: every 2-input AND/OR primitive becomes a 3-input MAJ
   with one input tied to C0/C1.  This yields a functionally-correct but
   inefficient MIG (paper Fig. 15b — it equals Ambit's representation).
2. *Greedy optimization*: repeated node-reduction / reshaping passes using the
   MIG axioms of Amarù et al. [7] (paper Table 4): Ω.M (majority), Ω.I
   (inverter propagation) — both applied during reconstruction through
   ``gate_maj`` — plus structural hashing, constant propagation, and
   relevance-driven 3-cut rewriting against a table of size-optimal MIG
   templates (XOR/XNOR/MUX/AOI/AND3/OR3...).  The XOR3 template is the shared
   full-adder structure S = M(M(¬a,b,c), ¬M(a,b,c), a) that App. A derives by
   hand in Fig. 15j; strashing makes the sum and carry outputs share the
   M(a,b,c) node automatically, reproducing the paper's 3-MAJ full adder.

The optimizer is deterministic; ``optimize_mig`` iterates passes until the
live gate count stops improving.
"""
from __future__ import annotations

import itertools

from .graph import (AND, CONST, CONST0, CONST1, MAJ, OR, PI, LogicGraph,
                    lit_neg, lit_node, lit_not)

# ---------------------------------------------------------------------------
# Part 1: naive AOIG → MIG substitution
# ---------------------------------------------------------------------------


def aoig_to_mig_naive(aoig: LogicGraph) -> LogicGraph:
    """AND(a,b) → MAJ(a,b,0); OR(a,b) → MAJ(a,b,1).  (paper Fig. 15b)"""
    return _reconstruct(aoig)


# ---------------------------------------------------------------------------
# Size-optimal templates for 3-input cut functions
# ---------------------------------------------------------------------------
# keyed by 8-bit truth table over (a,b,c), bit index = a + 2b + 4c.


def _tt3(fn) -> int:
    t = 0
    for i in range(8):
        a, b, c = i & 1, (i >> 1) & 1, (i >> 2) & 1
        if fn(a, b, c):
            t |= 1 << i
    return t


def _tmpl_xor3(g: LogicGraph, a: int, b: int, c: int) -> int:
    # 3-node XOR3 via the shared full-adder structure (App. A, Fig. 15j):
    # S = M( M(¬a,b,c), ¬M(a,b,c), a )
    y = g.gate_maj(lit_not(a), b, c)
    k = g.gate_maj(a, b, c)
    return g.gate_maj(y, lit_not(k), a)


def _tmpl_xor2(g: LogicGraph, a: int, b: int, _c: int) -> int:
    return _tmpl_xor3(g, a, b, CONST0)


def _tmpl_mux(g: LogicGraph, s: int, a: int, b: int) -> int:
    # s ? a : b  = M( M(s,a,0), M(¬s,b,0), 1 )   (3 nodes)
    return g.gate_maj(g.gate_maj(s, a, CONST0),
                      g.gate_maj(lit_not(s), b, CONST0), CONST1)


TEMPLATES: dict[int, object] = {}


def _register_templates() -> None:
    def reg(tt, builder):
        TEMPLATES.setdefault(tt & 0xFF, builder)

    # every function realizable by ONE maj node over (±a,±b,±c,0,1)
    base = {"a": lambda a, b, c: a, "b": lambda a, b, c: b, "c": lambda a, b, c: c,
            "0": lambda a, b, c: 0, "1": lambda a, b, c: 1}
    for trio in itertools.combinations_with_replacement(sorted(base), 3):
        for negs in itertools.product((0, 1), repeat=3):
            def f(a, b, c, trio=trio, negs=negs):
                vals = [base[t](a, b, c) ^ n for t, n in zip(trio, negs)]
                return int(sum(vals) >= 2)

            def build(g, a, b, c, trio=trio, negs=negs):
                m = {"a": a, "b": b, "c": c, "0": CONST0, "1": CONST1}
                lits = [lit_not(m[t]) if n else m[t] for t, n in zip(trio, negs)]
                return g.gate_maj(*lits)

            reg(_tt3(f), build)
    # multi-node templates
    reg(_tt3(lambda a, b, c: a ^ b), _tmpl_xor2)
    reg(_tt3(lambda a, b, c: 1 ^ a ^ b),
        lambda g, a, b, c: lit_not(_tmpl_xor2(g, a, b, c)))
    reg(_tt3(lambda a, b, c: a ^ b ^ c), _tmpl_xor3)
    reg(_tt3(lambda a, b, c: 1 ^ a ^ b ^ c),
        lambda g, a, b, c: lit_not(_tmpl_xor3(g, a, b, c)))
    reg(_tt3(lambda a, b, c: b if a else c), _tmpl_mux)
    reg(_tt3(lambda a, b, c: c if a else b), lambda g, a, b, c: _tmpl_mux(g, a, c, b))
    reg(_tt3(lambda a, b, c: a if b else c), lambda g, a, b, c: _tmpl_mux(g, b, a, c))
    reg(_tt3(lambda a, b, c: a if c else b), lambda g, a, b, c: _tmpl_mux(g, c, a, b))
    reg(_tt3(lambda a, b, c: a and (b or c)),
        lambda g, a, b, c: g.gate_maj(a, g.gate_maj(a, b, c), CONST0))
    reg(_tt3(lambda a, b, c: a or (b and c)),
        lambda g, a, b, c: g.gate_maj(a, g.gate_maj(a, b, c), CONST1))
    reg(_tt3(lambda a, b, c: a and b and c),
        lambda g, a, b, c: g.gate_maj(g.gate_maj(a, b, CONST0), c, CONST0))
    reg(_tt3(lambda a, b, c: a or b or c),
        lambda g, a, b, c: g.gate_maj(g.gate_maj(a, b, CONST1), c, CONST1))


def _register_two_node_templates() -> None:
    """Exhaustively enumerate every function realizable by TWO maj nodes
    over (±a, ±b, ±c, 0, 1) and register size-optimal builders for any truth
    table not already covered — making the cut rewriter size-optimal for all
    ≤2-node-realizable 3-input functions."""
    base_tt = {"a": 0b10101010, "b": 0b11001100, "c": 0b11110000,
               "0": 0, "1": 0xFF}
    lits = []  # (tt, builder_fn(g, a, b, c) -> literal)
    for name, tt in base_tt.items():
        def mk(name=name):
            def build(g, a, b, c):
                return {"a": a, "b": b, "c": c, "0": CONST0,
                        "1": CONST1}[name]
            return build
        lits.append((tt, mk()))
        if name in ("a", "b", "c"):
            def mkn(name=name):
                def build(g, a, b, c):
                    return lit_not({"a": a, "b": b, "c": c}[name])
                return build
            lits.append((~tt & 0xFF, mkn()))

    def maj_tt(x, y, z):
        return (x & y) | (x & z) | (y & z)

    import itertools as _it
    # all single-node results (as composable literal sources)
    node1: list[tuple[int, object]] = []
    for (t1, b1), (t2, b2), (t3, b3) in _it.combinations(lits, 3):
        tt = maj_tt(t1, t2, t3)

        def mk1(b1=b1, b2=b2, b3=b3):
            def build(g, a, b, c):
                return g.gate_maj(b1(g, a, b, c), b2(g, a, b, c),
                                  b3(g, a, b, c))
            return build
        node1.append((tt, mk1()))
        node1.append((~tt & 0xFF, (lambda f: lambda g, a, b, c:
                                   lit_not(f(g, a, b, c)))(mk1())))
    # two-node: one operand is a node-1 result
    pool = lits + node1
    two_node: dict[int, object] = {}
    for t_in, b_in in node1:
        for (t1, b1), (t2, b2) in _it.combinations(lits, 2):
            tt = maj_tt(t_in, t1, t2)
            if tt not in TEMPLATES and tt not in two_node:
                def mk2(b_in=b_in, b1=b1, b2=b2):
                    def build(g, a, b, c):
                        return g.gate_maj(b_in(g, a, b, c), b1(g, a, b, c),
                                          b2(g, a, b, c))
                    return build
                two_node[tt] = mk2()
    for tt, build in two_node.items():
        TEMPLATES.setdefault(tt, build)


_register_templates()
_register_two_node_templates()


# ---------------------------------------------------------------------------
# Cut machinery
# ---------------------------------------------------------------------------


def _cut_function(g: LogicGraph, root: int, leaves: tuple[int, ...]) -> int | None:
    """Truth table (over ≤3 leaves) of node ``root``; None if not covered."""
    order = {leaf: i for i, leaf in enumerate(leaves)}
    masks = (0b10101010, 0b11001100, 0b11110000)
    memo: dict[int, int | None] = {}

    def val(nid: int) -> int | None:
        if nid in memo:
            return memo[nid]
        if nid in order:
            memo[nid] = masks[order[nid]]
            return memo[nid]
        node = g.nodes[nid]
        if node.kind == CONST:
            memo[nid] = 0
        elif node.kind == PI:
            memo[nid] = None
        else:
            fs = []
            for f in node.fanin:
                v = val(lit_node(f))
                if v is None:
                    memo[nid] = None
                    return None
                fs.append((~v & 0xFF) if lit_neg(f) else v)
            if node.kind == MAJ:
                memo[nid] = (fs[0] & fs[1]) | (fs[0] & fs[2]) | (fs[1] & fs[2])
            elif node.kind == AND:
                memo[nid] = fs[0] & fs[1]
            else:
                memo[nid] = fs[0] | fs[1]
        return memo[nid]

    return val(root)


def _all_cuts(g: LogicGraph, k: int = 3, max_cuts: int = 10) -> dict[int, list[tuple[int, ...]]]:
    cuts: dict[int, list[frozenset[int]]] = {}
    result: dict[int, list[tuple[int, ...]]] = {}
    for n in g.topo_order():
        node = g.nodes[n]
        if node.kind == CONST:
            cuts[n] = [frozenset()]
            continue
        if node.kind == PI:
            cuts[n] = [frozenset([n])]
            continue
        pools = [cuts.get(lit_node(f), [frozenset([lit_node(f)])]) for f in node.fanin]
        merged: list[frozenset[int]] = []
        for combo in itertools.product(*pools):
            u = frozenset().union(*combo)
            if len(u) <= k and u not in merged:
                merged.append(u)
            if len(merged) >= max_cuts:
                break
        # largest cuts first: templates are size-optimal for the whole cut,
        # so a 3-cut rewrite replaces the most intermediate structure
        result[n] = sorted((tuple(sorted(c)) for c in merged if c),
                           key=len, reverse=True)
        merged.append(frozenset([n]))
        cuts[n] = merged
    return result


# ---------------------------------------------------------------------------
# Optimization passes
# ---------------------------------------------------------------------------


def _reconstruct(g: LogicGraph) -> LogicGraph:
    """Rebuild through gate_maj so local axioms (Ω.M, Ω.I, constant folding)
    and structural hashing apply everywhere; AND/OR become MAJ."""
    out = LogicGraph()
    remap: dict[int, int] = {0: CONST0}

    def mlit(old: int) -> int:
        v = remap[lit_node(old)]
        return lit_not(v) if lit_neg(old) else v

    for nid in range(1, len(g.nodes)):
        node = g.nodes[nid]
        if node.kind == PI:
            remap[nid] = out.input(node.name)
        elif node.kind == MAJ:
            remap[nid] = out.gate_maj(*(mlit(f) for f in node.fanin))
        elif node.kind == AND:
            remap[nid] = out.gate_maj(mlit(node.fanin[0]), mlit(node.fanin[1]), CONST0)
        elif node.kind == OR:
            remap[nid] = out.gate_maj(mlit(node.fanin[0]), mlit(node.fanin[1]), CONST1)
    for name, o in g.outputs:
        out.add_output(name, mlit(o))
    return out


def _cut_rewrite(g: LogicGraph) -> LogicGraph:
    """Topo-order rebuild where each node may be re-expressed by a
    size-optimal template over one of its 3-cuts.  Structural hashing in the
    output graph turns template sharing (e.g. FA sum/carry) into real
    node sharing."""
    out = LogicGraph()
    remap: dict[int, int] = {0: CONST0}
    cuts = _all_cuts(g)

    def mlit(old: int) -> int:
        v = remap[lit_node(old)]
        return lit_not(v) if lit_neg(old) else v

    for nid in g.topo_order():
        node = g.nodes[nid]
        if node.kind == CONST:
            continue
        if node.kind == PI:
            remap[nid] = out.input(node.name)
            continue
        chosen = None
        for leaves in cuts.get(nid, []):
            if not all(leaf in remap for leaf in leaves):
                continue
            tt = _cut_function(g, nid, leaves)
            if tt is None:
                continue
            builder = TEMPLATES.get(tt & 0xFF)
            if builder is None:
                continue
            leaf_lits = [remap[leaf] for leaf in leaves] + [CONST0] * (3 - len(leaves))
            chosen = builder(out, *leaf_lits)
            break
        if chosen is None:
            if node.kind == MAJ:
                chosen = out.gate_maj(*(mlit(f) for f in node.fanin))
            elif node.kind == AND:
                chosen = out.gate_maj(mlit(node.fanin[0]), mlit(node.fanin[1]), CONST0)
            else:
                chosen = out.gate_maj(mlit(node.fanin[0]), mlit(node.fanin[1]), CONST1)
        remap[nid] = chosen
    for name, o in g.outputs:
        out.add_output(name, mlit(o))
    return out


def optimize_mig(mig: LogicGraph, max_rounds: int = 8) -> LogicGraph:
    best = _reconstruct(mig)
    for _ in range(max_rounds):
        cand = _reconstruct(_cut_rewrite(best))
        if cand.live_gate_count() >= best.live_gate_count():
            break
        best = cand
    return best


def synthesize(aoig: LogicGraph, optimize: bool = True) -> LogicGraph:
    """Full Step 1: AOIG → (optimized) MIG."""
    mig = aoig_to_mig_naive(aoig)
    return optimize_mig(mig) if optimize else mig


class SynthesisError(ValueError):
    """Step-1 synthesis produced a MIG that disagrees with its AOIG."""


def check_synthesis(aoig: LogicGraph, name: str = "graph",
                    max_inputs: int = 12) -> None:
    """Exhaustively verify Step-1 synthesis for a (slice-sized) AOIG.

    Both MIG forms — the naive MAJ/NOT substitution (the Ambit baseline)
    and the optimized MIG — are evaluated bit-parallel against the source
    AOIG on *every* input assignment (one SIMD lane per assignment, like
    bitlines).  User-defined operations registered through
    ``SimdramMachine.define_op`` run through here before they reach row
    allocation, so a miscompiled template or a bad axiom rewrite surfaces
    as a clear :class:`SynthesisError` instead of wrong in-DRAM results.

    Slice graphs have a handful of inputs, so exhaustion is cheap; graphs
    wider than ``max_inputs`` are rejected (define such ops via
    ``compile_fn`` and cover them with their own tests).
    """
    names = aoig.input_names()
    if len(names) > max_inputs:
        raise ValueError(
            f"{name!r}: {len(names)} inputs is too wide to verify "
            f"exhaustively (limit {max_inputs}) — register via compile_fn "
            "and validate externally")
    lanes = 1 << len(names)
    mask = (1 << lanes) - 1
    assignment = {}
    for i, pi in enumerate(names):
        pat = 0
        for lane in range(lanes):
            if (lane >> i) & 1:
                pat |= 1 << lane
        assignment[pi] = pat
    ref = aoig.evaluate(assignment, mask)
    naive = aoig_to_mig_naive(aoig)
    for g, form in ((naive, "naive MAJ/NOT substitution"),
                    (optimize_mig(naive), "optimized MIG")):
        got = g.evaluate(assignment, mask)
        if got != ref:
            wrong = sorted(o for o in ref if got.get(o) != ref[o])
            raise SynthesisError(
                f"{name!r}: {form} disagrees with the source AOIG on "
                f"output(s) {wrong}")
