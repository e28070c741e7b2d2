"""AOIG circuit definitions for the 16 SIMDRAM operations (paper §4.4).

Every operation enters the framework as an AND/OR/NOT description (AOIG) of
its 1-bit slice — exactly the paper's Step-1 input — and is synthesized to an
optimized MIG by ``repro_torch.core.synthesis`` before μProgram generation.

Operation classes (paper Table 5):
  class 1 (linear):    abs, addition, bitcount, max, min, ReLU, subtraction,
                       if_else, equal, greater, greater_equal
  class 2 (log):       and_reduction, or_reduction, xor_reduction
  class 3 (quadratic): multiplication, division
"""
from __future__ import annotations

import dataclasses

from .compiler import SliceSpec, compile_flat, compile_slice
from .graph import CONST0, LogicGraph, lit_not
from .uprogram import AAP, C0, DRow, UProgram, concat_programs

# ---------------------------------------------------------------------------
# 1-bit slice AOIGs (class-1 ops)
# ---------------------------------------------------------------------------


def _full_add(g: LogicGraph, a: int, b: int, c: int) -> tuple[int, int]:
    """(sum, carry) as AOIG — the paper's Fig. 15a structure."""
    axb = g.gate_xor(a, b)
    s = g.gate_xor(axb, c)
    cout = g.gate_or_node(g.gate_and(a, b), g.gate_and(c, axb))
    return s, cout


def build_add(g: LogicGraph) -> None:
    a, b, c = g.input("a"), g.input("b"), g.input("carry")
    s, cout = _full_add(g, a, b, c)
    g.add_output("out", s)
    g.add_output("carry", cout)


def build_sub(g: LogicGraph) -> None:
    # a - b via borrow: d = a ⊕ b ⊕ w ;  w' = ¬a·b + w·(a XNOR b)
    a, b, w = g.input("a"), g.input("b"), g.input("borrow")
    axb = g.gate_xor(a, b)
    d = g.gate_xor(axb, w)
    wn = g.gate_or_node(g.gate_and(lit_not(a), b), g.gate_and(w, lit_not(axb)))
    g.add_output("out", d)
    g.add_output("borrow", wn)


def build_greater(g: LogicGraph) -> None:
    # src1 > src2  ⇔  borrow-out of (src2 - src1); scan LSB→MSB
    a, b, w = g.input("a"), g.input("b"), g.input("gt")
    axb = g.gate_xor(a, b)
    wn = g.gate_or_node(g.gate_and(a, lit_not(b)), g.gate_and(w, lit_not(axb)))
    g.add_output("gt", wn)


def build_greater_equal(g: LogicGraph) -> None:
    # src1 >= src2 ⇔ ¬ borrow-out of (src1 - src2)
    a, b, w = g.input("a"), g.input("b"), g.input("lt")
    axb = g.gate_xor(a, b)
    wn = g.gate_or_node(g.gate_and(lit_not(a), b), g.gate_and(w, lit_not(axb)))
    g.add_output("lt", wn)
    g.add_output("ge", lit_not(wn))


def build_equal(g: LogicGraph) -> None:
    # running neq' = neq | (a ⊕ b); final eq = ¬neq
    a, b, q = g.input("a"), g.input("b"), g.input("neq")
    nq = g.gate_or_node(q, g.gate_xor(a, b))
    g.add_output("neq", nq)
    g.add_output("eq", lit_not(nq))


def build_if_else(g: LogicGraph) -> None:
    s, a, b = g.input("sel"), g.input("a"), g.input("b")
    g.add_output("out", g.gate_mux(s, a, b))


def build_relu(g: LogicGraph) -> None:
    # out = ¬sign · x  (sign = MSB row, loop-invariant binding)
    s, a = g.input("sgn"), g.input("a")
    g.add_output("out", g.gate_and(lit_not(s), a))


def build_abs(g: LogicGraph) -> None:
    # |x| = (x ⊕ s) + s, s = sign bit: slice is t = a⊕s with half-add carry
    s, a, c = g.input("sgn"), g.input("a"), g.input("carry")
    t = g.gate_xor(a, s)
    g.add_output("out", g.gate_xor(t, c))
    g.add_output("carry", g.gate_and(t, c))


def build_gated_add(g: LogicGraph) -> None:
    """acc += a·gate  (the inner slice of multiplication)."""
    acc, a, gate, c = g.input("acc"), g.input("a"), g.input("gate"), g.input("carry")
    t = g.gate_and(a, gate)
    s, cout = _full_add(g, acc, t, c)
    g.add_output("out", s)
    g.add_output("carry", cout)


def _nary(g: LogicGraph, op: str, n_srcs: int) -> None:
    ins = [g.input(f"s{k}") for k in range(n_srcs)]
    acc = ins[0]
    for x in ins[1:]:
        if op == "and":
            acc = g.gate_and(acc, x)
        elif op == "or":
            acc = g.gate_or_node(acc, x)
        else:
            acc = g.gate_xor(acc, x)
    g.add_output("out", acc)


def build_and_reduction(g: LogicGraph, n_srcs: int = 3) -> None:
    _nary(g, "and", n_srcs)


def build_or_reduction(g: LogicGraph, n_srcs: int = 3) -> None:
    _nary(g, "or", n_srcs)


def build_xor_reduction(g: LogicGraph, n_srcs: int = 3) -> None:
    _nary(g, "xor", n_srcs)


# ---------------------------------------------------------------------------
# Slice specs (class-1 / class-2)
# ---------------------------------------------------------------------------


def spec_add() -> SliceSpec:
    return SliceSpec("addition", build_add, ("a", "b"), states={"carry": 0})


def spec_sub() -> SliceSpec:
    return SliceSpec("subtraction", build_sub, ("a", "b"), states={"borrow": 0})


def spec_greater() -> SliceSpec:
    return SliceSpec("greater", build_greater, ("a", "b"), states={"gt": 0},
                     out_array=None, epilogue_outputs={"gt": ("out", 0)})


def spec_greater_equal() -> SliceSpec:
    return SliceSpec("greater_equal", build_greater_equal, ("a", "b"),
                     states={"lt": 0}, out_array=None,
                     epilogue_outputs={"ge": ("out", 0)})


def spec_equal() -> SliceSpec:
    return SliceSpec("equal", build_equal, ("a", "b"), states={"neq": 0},
                     out_array=None, epilogue_outputs={"eq": ("out", 0)})


def spec_if_else() -> SliceSpec:
    return SliceSpec("if_else", build_if_else, ("a", "b"),
                     invariants={"sel": DRow("sel", 0, fixed=True)})


def spec_relu(n_bits: int) -> SliceSpec:
    return SliceSpec("relu", build_relu, ("a",),
                     invariants={"sgn": DRow("a", n_bits - 1, fixed=True)})


def spec_abs(n_bits: int) -> SliceSpec:
    return SliceSpec("abs", build_abs, ("a",),
                     invariants={"sgn": DRow("a", n_bits - 1, fixed=True)},
                     states={"carry": DRow("a", n_bits - 1, fixed=True)})


def spec_reduction(kind: str, n_srcs: int = 3) -> SliceSpec:
    build = {"and": build_and_reduction, "or": build_or_reduction,
             "xor": build_xor_reduction}[kind]
    return SliceSpec(f"{kind}_reduction",
                     lambda g: build(g, n_srcs),
                     tuple(f"s{k}" for k in range(n_srcs)))


def spec_gated_add() -> SliceSpec:
    return SliceSpec("gated_add", build_gated_add, ("acc", "a"),
                     invariants={"gate": DRow("gate", 0, fixed=True)},
                     states={"carry": 0}, out_array="acc")


# ---------------------------------------------------------------------------
# Rebasing helper for composite ops
# ---------------------------------------------------------------------------


def rebase(prog: UProgram, offsets: dict[str, int],
           renames: dict[str, str] | None = None) -> UProgram:
    """Shift/rename D-row arrays of a compiled μProgram (composite ops)."""
    renames = renames or {}

    def fix(r):
        if isinstance(r, DRow):
            arr = renames.get(r.array, r.array)
            return DRow(arr, r.bit + offsets.get(r.array, 0), r.fixed)
        return r

    def fix_uop(u):
        if isinstance(u, AAP):
            src = u.src if isinstance(u.src, tuple) else fix(u.src)
            return AAP(src, tuple(fix(d) for d in u.dsts))
        return u

    return UProgram(name=prog.name, n_bits=prog.n_bits,
                    prologue=[fix_uop(u) for u in prog.prologue],
                    body=[fix_uop(u) for u in prog.body],
                    epilogue=[fix_uop(u) for u in prog.epilogue],
                    body_reps=prog.body_reps, inputs=prog.inputs,
                    outputs=prog.outputs, scratch=prog.scratch)


# ---------------------------------------------------------------------------
# Composite operations (class-3 + tree ops)
# ---------------------------------------------------------------------------


def compile_max(n_bits: int, minimum: bool = False, optimize: bool = True) -> UProgram:
    """max/min = greater(a,b) feeding a predicated select (paper: 10n+2)."""
    gt = compile_slice(spec_greater(), n_bits, optimize=optimize)
    gt = rebase(gt, {}, {"out": "_gtrow"})
    sel = compile_slice(spec_if_else(), n_bits, optimize=optimize)
    if minimum:
        sel = rebase(sel, {}, {"a": "b", "b": "a", "sel": "_gtrow"})
    else:
        sel = rebase(sel, {}, {"sel": "_gtrow"})
    return concat_programs("minimum" if minimum else "maximum",
                           [gt, sel], n_bits, inputs=("a", "b"),
                           outputs=("out",), scratch=("_gtrow",))


def compile_bitcount(n_bits: int, optimize: bool = True) -> UProgram:
    """Popcount over the n bit-rows of each element via a CSA/adder tree of
    full adders (cost ≈ 8 per FA ⇒ ~8n, matching Table 5's Ω=8n−8log(n+1))."""
    g = LogicGraph()
    bits = [(g.input(f"a{i}"), 0) for i in range(n_bits)]  # (lit, weight)
    out_width = max(1, (n_bits).bit_length())
    columns: dict[int, list[int]] = {}
    for lit, w in bits:
        columns.setdefault(0, []).append(lit)
    weight = 0
    while weight < out_width:
        col = columns.get(weight, [])
        while len(col) >= 3:
            a, b, c = col.pop(), col.pop(), col.pop()
            s, k = _full_add(g, a, b, c)
            col.append(s)
            columns.setdefault(weight + 1, []).append(k)
        while len(col) >= 2:
            a, b = col.pop(), col.pop()
            s, k = _full_add(g, a, b, CONST0)   # half adder
            col.append(s)
            columns.setdefault(weight + 1, []).append(k)
        g.add_output(f"out{weight}", col[0] if col else CONST0)
        weight += 1
    binding = {f"a{i}": DRow("a", i, fixed=True) for i in range(n_bits)}
    targets = {f"out{w}": DRow("out", w, fixed=True) for w in range(out_width)}
    prog = compile_flat("bitcount", g, binding, targets, n_bits,
                        optimize=optimize)
    prog.inputs, prog.outputs = ("a",), ("out",)
    return prog


def compile_multiplication(n_bits: int, optimize: bool = True) -> UProgram:
    """Truncating n×n→n multiply: n gated-add passes; shifts are free row
    re-indexing (vertical layout).  Paper: 11n²−5n−1 (class 3)."""
    progs: list[UProgram] = []
    # zero the accumulator rows
    zero = UProgram("mul_zero", n_bits,
                    prologue=[AAP(C0, (DRow("out", i, fixed=True),))
                              for i in range(n_bits)], body=[], body_reps=0)
    progs.append(zero)
    base = compile_slice(spec_gated_add(), n_bits, optimize=optimize)
    for j in range(n_bits):
        pj = rebase(base, {"acc": j, "gate": j},
                    renames={"acc": "out", "gate": "b"})
        pj = dataclasses.replace(pj, body_reps=n_bits - j, name=f"mul_pass{j}")
        progs.append(pj)
    return concat_programs("multiplication", progs, n_bits,
                           inputs=("a", "b"), outputs=("out",))


def compile_division(n_bits: int, optimize: bool = True) -> UProgram:
    """Restoring long division (unsigned): quotient in 'out', remainder in the
    final R window.  The left-shift of the remainder each step is *free*: the
    R window simply slides down one row index (the paper's 'changing the row
    indices' optimization for shifts under vertical layout).  Paper reports
    8n²+12n with a non-restoring scheme; our restoring scheme is ~16n² —
    recorded as a deviation in EXPERIMENTS.md."""
    from .uprogram import P_DCC0, P_NDCC0

    n = n_bits
    progs: list[UProgram] = []
    # R value at step j occupies rows R[j .. j+n] (LSB at R[j]).
    # zero the initial window rows [n .. 2n-1]
    init_ops = [AAP(C0, (DRow("R", n + k, fixed=True),)) for k in range(n)]
    # _bx = b zero-extended to n+1 bits
    init_ops += [AAP(DRow("b", i, fixed=True), (DRow("_bx", i, fixed=True),))
                 for i in range(n)]
    init_ops.append(AAP(C0, (DRow("_bx", n, fixed=True),)))
    progs.append(UProgram("div_init", n, prologue=init_ops, body=[], body_reps=0))

    sub = compile_slice(
        SliceSpec("div_sub", build_sub, ("a", "b"), states={"borrow": 0},
                  epilogue_outputs={"borrow": ("_q", 0)}), n + 1,
        optimize=optimize)
    mux = compile_slice(spec_if_else(), n + 1, optimize=optimize)
    for step in range(n - 1, -1, -1):
        # shift-in: new LSB of the window is a[step]
        progs.append(UProgram(f"div_in{step}", n, prologue=[
            AAP(DRow("a", step, fixed=True), (DRow("R", step, fixed=True),))],
            body=[], body_reps=0))
        # _t = R_window - _bx ; borrow → _q[0]
        s = rebase(sub, {"a": step}, renames={"a": "R", "b": "_bx", "out": "_t"})
        s = dataclasses.replace(s, name=f"div_sub{step}")
        progs.append(s)
        # quotient bit = ¬borrow (routed through a dual-contact cell)
        progs.append(UProgram(f"div_q{step}", n, prologue=[
            AAP(DRow("_q", 0, fixed=True), (P_DCC0,)),
            AAP(P_NDCC0, (DRow("out", step, fixed=True),))],
            body=[], body_reps=0))
        # restore: R = borrow ? R : _t
        m = rebase(mux, {"a": step, "out": step},
                   renames={"a": "R", "b": "_t", "out": "R", "sel": "_q"})
        m = dataclasses.replace(m, name=f"div_mux{step}")
        progs.append(m)
    return concat_programs("division", progs, n,
                           inputs=("a", "b"), outputs=("out",),
                           scratch=("R", "_t", "_bx", "_q"))


# ---------------------------------------------------------------------------
# Operation registry — the framework's programmable op table
# ---------------------------------------------------------------------------
#
# The paper's pitch is the *framework*, not the 16 built-in operations: any
# AOIG a programmer supplies runs through the same Step-1/2/3 pipeline.  The
# op table is therefore a registry, not a hardcoded dispatch: the 16 Table-5
# operations register at import, and user operations join at runtime via
# :func:`register_operation` (process-wide) or, scoped to one session,
# ``SimdramMachine.define_op`` (:mod:`repro_torch.simdram.machine`).

CLASS_OF = {
    "abs": 1, "addition": 1, "bitcount": 1, "maximum": 1, "minimum": 1,
    "relu": 1, "subtraction": 1, "if_else": 1, "equal": 1, "greater": 1,
    "greater_equal": 1, "and_reduction": 2, "or_reduction": 2,
    "xor_reduction": 2, "multiplication": 3, "division": 3,
}

PAPER_COUNTS = {  # Table 5 closed forms
    "abs": lambda n: 10 * n - 2,
    "addition": lambda n: 8 * n + 1,
    "bitcount": lambda n: 8 * n,
    "division": lambda n: 8 * n * n + 12 * n,
    "maximum": lambda n: 10 * n + 2,
    "minimum": lambda n: 10 * n + 2,
    "multiplication": lambda n: 11 * n * n - 5 * n - 1,
    "relu": lambda n: 3 * n + ((n - 1) % 2),
    "subtraction": lambda n: 8 * n + 1,
    "if_else": lambda n: 7 * n,
    "and_reduction": lambda n: 5 * (n // 2) + 2,
    "or_reduction": lambda n: 5 * (n // 2) + 2,
    "xor_reduction": lambda n: 6 * (n // 2) + 1,
    "equal": lambda n: 4 * n + 3,
    "greater": lambda n: 3 * n + 2,
    "greater_equal": lambda n: 3 * n + 2,
}

# the 16 built-ins, frozen before any user registration can extend CLASS_OF
ALL_OPS = tuple(CLASS_OF)


@dataclasses.dataclass(frozen=True)
class OperationDef:
    """One registered operation: a compile entry point plus metadata.

    ``compile_fn(n_bits, optimize)`` must return a fully-formed
    :class:`~repro_torch.core.uprogram.UProgram` — anything built from
    :func:`~repro_torch.core.compiler.compile_slice` /
    :func:`~repro_torch.core.compiler.compile_flat` / :func:`rebase` /
    :func:`~repro_torch.core.uprogram.concat_programs` qualifies.
    """

    name: str
    compile_fn: object            # (n_bits: int, optimize: bool) -> UProgram
    op_class: int | None = None   # paper Table-5 class (1/2/3), if meaningful
    builtin: bool = False


_OPERATIONS: dict[str, OperationDef] = {}


def register_operation(name: str, compile_fn, *, op_class: int | None = None,
                       paper_count=None, override: bool = False,
                       _builtin: bool = False) -> OperationDef:
    """Register a new operation with the process-wide op table.

    After registration the operation is a first-class citizen of the whole
    framework: :func:`compile_operation`, the compile/lower cache
    (:func:`repro_torch.core.trace.compile_trace`), every execution backend and
    the replay-timing substrate all pick it up with no other change.
    ``paper_count`` optionally records a closed-form command count (joins
    ``PAPER_COUNTS``); ``override=True`` replaces an existing non-builtin
    registration.
    """
    if not callable(compile_fn):
        raise TypeError(f"compile_fn for {name!r} must be callable")
    existing = _OPERATIONS.get(name)
    if existing is not None:
        if existing.builtin:
            raise ValueError(f"cannot override built-in operation {name!r}")
        if not override:
            raise ValueError(f"operation {name!r} already registered "
                             "(pass override=True to replace it)")
    d = OperationDef(name, compile_fn, op_class, _builtin)
    _OPERATIONS[name] = d
    if op_class is not None:
        CLASS_OF[name] = op_class
    if paper_count is not None:
        PAPER_COUNTS[name] = paper_count
    if existing is not None:
        _drop_cached_compiles(name)
    return d


def unregister_operation(name: str) -> None:
    """Remove a user-registered operation (built-ins are protected)."""
    d = _OPERATIONS.get(name)
    if d is None:
        return
    if d.builtin:
        raise ValueError(f"cannot unregister built-in operation {name!r}")
    del _OPERATIONS[name]
    if name not in ALL_OPS:
        CLASS_OF.pop(name, None)
        PAPER_COUNTS.pop(name, None)
    _drop_cached_compiles(name)


def _drop_cached_compiles(name: str) -> None:
    """A replaced or removed registration must also leave every live
    compile/lower cache — private machine memories resolve unknown names
    through this registry, so the stale compile could otherwise keep
    executing out of any of them."""
    from .trace import invalidate_everywhere
    invalidate_everywhere(name)


def get_operation(name: str) -> OperationDef:
    try:
        return _OPERATIONS[name]
    except KeyError:
        raise KeyError(name) from None


def list_operations() -> tuple[str, ...]:
    """Every registered operation name (built-ins + user registrations)."""
    return tuple(sorted(_OPERATIONS))


def compile_operation(name: str, n_bits: int, optimize: bool = True) -> UProgram:
    """Compile any registered SIMDRAM operation for n-bit elements.

    ``optimize=False`` skips Step-1 MIG optimization, yielding the naive
    AND/OR/NOT-equivalent command stream — this is the paper's Ambit
    baseline (§6: 'evaluate all 16 SIMDRAM operations in Ambit using their
    equivalent AND/OR/NOT-based implementations').
    """
    return get_operation(name).compile_fn(n_bits, optimize)


def _register_builtins() -> None:
    def slice_of(spec_fn, per_width: bool = False):
        if per_width:
            return lambda n, opt=True: compile_slice(spec_fn(n), n,
                                                     optimize=opt)
        return lambda n, opt=True: compile_slice(spec_fn(), n, optimize=opt)

    builtins = {
        "addition": slice_of(spec_add),
        "subtraction": slice_of(spec_sub),
        "greater": slice_of(spec_greater),
        "greater_equal": slice_of(spec_greater_equal),
        "equal": slice_of(spec_equal),
        "if_else": slice_of(spec_if_else),
        "relu": slice_of(spec_relu, per_width=True),
        "abs": slice_of(spec_abs, per_width=True),
        "and_reduction": lambda n, opt=True: compile_slice(
            spec_reduction("and"), n, optimize=opt),
        "or_reduction": lambda n, opt=True: compile_slice(
            spec_reduction("or"), n, optimize=opt),
        "xor_reduction": lambda n, opt=True: compile_slice(
            spec_reduction("xor"), n, optimize=opt),
        "maximum": lambda n, opt=True: compile_max(n, optimize=opt),
        "minimum": lambda n, opt=True: compile_max(n, minimum=True,
                                                   optimize=opt),
        "bitcount": lambda n, opt=True: compile_bitcount(n, optimize=opt),
        "multiplication": lambda n, opt=True: compile_multiplication(
            n, optimize=opt),
        "division": lambda n, opt=True: compile_division(n, optimize=opt),
    }
    assert set(builtins) == set(ALL_OPS)
    for name, fn in builtins.items():
        register_operation(name, fn, op_class=CLASS_OF[name], _builtin=True)


_register_builtins()
