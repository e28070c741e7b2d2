"""SIMDRAM μOp ISA, subarray row organization, and μProgram container.

Mirrors the paper's §3.1 (subarray organization) and §4.2.1 (μOps):

* Subarray rows are split into the D-group (data rows), C-group (constant
  rows C0/C1) and B-group (compute rows T0–T3 plus the two dual-contact-cell
  rows DCC0/DCC1 with negated wordline ports ¬DCC0/¬DCC1).
* Command-sequence μOps: ``AAP`` (ACTIVATE-ACTIVATE-PRECHARGE = in-DRAM row
  copy, possibly to a multi-row B-group address) and ``AP`` (triple-row
  activation + precharge = destructive 3-input majority).
* Control/arithmetic μOps (addi/subi/comp/module/bnez/done) generalize the
  1-bit loop body to n-bit operands; we keep them at the μProgram level as a
  (prologue, body×n, epilogue) structure, which is exactly what the control
  unit's loop counter + μPC implement in Fig. 7.

Addressing model.  The B-group row decoder supports *multi-row* addresses:
single-row ports, fixed two-row pairs, and triple-row (TRA) addresses.  The
paper exposes these through μRegisters B0–B17.  We implement the same budget:
8 single ports, 4 pair addresses, and a configurable set of TRA triples; the
compiler records which triples each μProgram uses so that decoder cost can be
audited (``UProgram.used_triples``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

# ---------------------------------------------------------------------------
# B-group cells & ports
# ---------------------------------------------------------------------------

# physical B-group cells (six compute rows, paper §3.1)
CELL_T0, CELL_T1, CELL_T2, CELL_T3, CELL_DCC0, CELL_DCC1 = range(6)
N_B_CELLS = 6
T_CELLS = (CELL_T0, CELL_T1, CELL_T2, CELL_T3)
DCC_CELLS = (CELL_DCC0, CELL_DCC1)

CELL_NAMES = {CELL_T0: "T0", CELL_T1: "T1", CELL_T2: "T2", CELL_T3: "T3",
              CELL_DCC0: "DCC0", CELL_DCC1: "DCC1"}


@dataclasses.dataclass(frozen=True, order=True)
class Port:
    """A wordline view of a B-group cell.  ``neg`` selects the n-wordline of
    a dual-contact cell (read: complement; write: stores complement)."""
    cell: int
    neg: bool = False

    def __post_init__(self) -> None:
        if self.neg and self.cell not in DCC_CELLS:
            raise ValueError("only DCC cells have negated ports")

    def __str__(self) -> str:
        return ("~" if self.neg else "") + CELL_NAMES[self.cell]


# the 8 single-row ports (μRegisters B0–B7 in Fig. 6)
P_T0, P_T1, P_T2, P_T3 = (Port(c) for c in T_CELLS)
P_DCC0, P_DCC1 = Port(CELL_DCC0), Port(CELL_DCC1)
P_NDCC0, P_NDCC1 = Port(CELL_DCC0, True), Port(CELL_DCC1, True)
SINGLE_PORTS = (P_T0, P_T1, P_T2, P_T3, P_DCC0, P_NDCC0, P_DCC1, P_NDCC1)

# fixed pair addresses (multi-row copy destinations, cf. paper's B10 example
# "activating μRegister B10 allows the AAP to copy array A into both rows T2
# and T3 at once")
PAIR_ADDRESSES: tuple[tuple[Port, ...], ...] = (
    (P_T0, P_T3),
    (P_T1, P_T2),
    (P_T2, P_T3),
    (P_DCC0, P_DCC1),
)


# ---------------------------------------------------------------------------
# Row references
# ---------------------------------------------------------------------------

# D-group/C-group rows are referenced symbolically: (array name, bit offset).
# The control unit's μRegister Addressing Unit resolves ``base + bit`` at
# runtime (paper §4.3); C0/C1 are the constant rows.

@dataclasses.dataclass(frozen=True)
class DRow:
    """A D-group row: bit ``bit`` of the operand array named ``array``.

    ``array`` indexes μRegisters B18–B22 (source/dest base addresses);
    scratch arrays (for multi-step ops) use additional D-group allocations.
    ``fixed`` rows do not shift with the loop induction variable (used for
    loop-invariant operands such as predication masks or sign rows).
    """
    array: str
    bit: int = 0
    fixed: bool = False

    def __str__(self) -> str:
        return f"{self.array}[{self.bit}{'!' if self.fixed else ''}]"


@dataclasses.dataclass(frozen=True)
class CRow:
    """A C-group constant row (C0 = all zeros, C1 = all ones)."""
    one: bool

    def __str__(self) -> str:
        return "C1" if self.one else "C0"


C0 = CRow(False)
C1 = CRow(True)

RowRef = object  # Port | DRow | CRow


# ---------------------------------------------------------------------------
# μOps
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AAP:
    """ACTIVATE(src) → ACTIVATE(dst…) → PRECHARGE: copy src row into one or
    more destination rows.  If ``src`` is a tuple of 3 ports, the first
    ACTIVATE is itself a TRA: this is the paper's *Case 2 coalescing* (an AP
    immediately followed by an AAP from the TRA address fuses into one AAP
    whose source activation performs the majority)."""
    src: object                      # RowRef or tuple[Port, Port, Port]
    dsts: tuple                      # tuple of RowRef (ports or D rows)

    def __str__(self) -> str:
        s = ("MAJ(" + ",".join(map(str, self.src)) + ")"
             if isinstance(self.src, tuple) else str(self.src))
        return f"AAP {','.join(map(str, self.dsts))} <- {s}"


@dataclasses.dataclass(frozen=True)
class AP:
    """Triple-row activation + precharge: in-place 3-input majority.  All
    three cells end up holding the majority (through their port polarity)."""
    ports: tuple                      # tuple[Port, Port, Port]

    def __str__(self) -> str:
        return f"AP  MAJ({','.join(map(str, self.ports))})"


UOp = object  # AAP | AP


def is_command_sequence(u: UOp) -> bool:
    return isinstance(u, (AAP, AP))


# ---------------------------------------------------------------------------
# μProgram
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class UProgram:
    """A compiled SIMDRAM operation.

    ``body`` μOps reference operand bits relative to the loop induction
    variable: a ``DRow(array, k)`` inside the body denotes bit ``i + k`` of
    ``array`` at loop iteration ``i``.  This is what the control unit's
    addi/bnez μOps implement; we keep the structured form (the +1 "done"
    accounting per paper Table 5 is ``n_loop_overhead``).
    """
    name: str
    n_bits: int
    prologue: list = dataclasses.field(default_factory=list)
    body: list = dataclasses.field(default_factory=list)      # repeated n times
    epilogue: list = dataclasses.field(default_factory=list)
    body_reps: int | None = None      # defaults to n_bits
    inputs: tuple[str, ...] = ()
    outputs: tuple[str, ...] = ()
    scratch: tuple[str, ...] = ()     # D-group scratch arrays (name, n_bits implied)
    # cross-op fusion metadata (None for ordinary programs; set by
    # compile_chain): {"stages": ((op, value, start, end), ...),
    # "elided_rows": int, "elided_seqs": int} — start/end index the
    # flattened μOp stream, so lowering can recover per-stage seam spans
    chain: dict | None = None

    # -- accounting ---------------------------------------------------------
    @property
    def reps(self) -> int:
        return self.n_bits if self.body_reps is None else self.body_reps

    def flatten(self) -> list:
        """Concrete μOp stream for one row-chunk of elements."""
        out = list(self.prologue)
        for i in range(self.reps):
            for u in self.body:
                out.append(_shift_uop(u, i))
        out.extend(self.epilogue)
        return out

    def command_count(self) -> int:
        """Total AAP+AP command sequences (the paper's Table 5 metric)."""
        return (sum(is_command_sequence(u) for u in self.prologue)
                + self.reps * sum(is_command_sequence(u) for u in self.body)
                + sum(is_command_sequence(u) for u in self.epilogue))

    def command_mix(self) -> dict:
        """(n_AAP, n_AP, n_TRA) — every AP is a TRA; an AAP whose source is a
        triple also performs a TRA on its first ACTIVATE."""
        n_aap = n_ap = n_tra = 0
        for u in self.flatten():
            if isinstance(u, AAP):
                n_aap += 1
                if isinstance(u.src, tuple):
                    n_tra += 1
            elif isinstance(u, AP):
                n_ap += 1
                n_tra += 1
        return {"AAP": n_aap, "AP": n_ap, "TRA": n_tra}

    def used_triples(self) -> set:
        """Distinct TRA addresses used — decoder-cost audit (§3.1)."""
        triples = set()
        for u in self.flatten():
            if isinstance(u, AP):
                triples.add(tuple(sorted(u.ports)))
            elif isinstance(u, AAP) and isinstance(u.src, tuple):
                triples.add(tuple(sorted(u.src)))
        return triples

    def pretty(self, max_ops: int = 40) -> str:
        lines = [f"; μProgram {self.name} (n={self.n_bits}, "
                 f"{self.command_count()} command sequences)"]
        for tag, ops in (("prologue", self.prologue), ("body", self.body),
                         ("epilogue", self.epilogue)):
            if ops:
                lines.append(f";; {tag}" + (f" ×{self.reps}" if tag == "body" else ""))
                lines.extend(f"  {u}" for u in ops[:max_ops])
                if len(ops) > max_ops:
                    lines.append(f"  ... ({len(ops) - max_ops} more)")
        return "\n".join(lines)


def normalize_uop(u: UOp):
    """Canonical form of a *flattened* μOp: D-row references drop their
    ``fixed`` loop-invariance mark.  ``fixed`` steers :func:`_shift_uop`
    during flattening but names the same physical row afterwards, so the
    lowered command-trace IR (``repro_torch.core.trace``) cannot — and need not —
    preserve it; round-trip comparisons go through this form."""
    def n(r):
        if isinstance(r, DRow) and r.fixed:
            return DRow(r.array, r.bit)
        return r

    if isinstance(u, AAP):
        src = u.src if isinstance(u.src, tuple) else n(u.src)
        return AAP(src, tuple(n(d) for d in u.dsts))
    return u


def _shift_uop(u: UOp, i: int):
    """Rebase DRow bit offsets by the loop induction variable ``i``."""
    def sh(r):
        if isinstance(r, DRow) and not r.fixed:
            return DRow(r.array, r.bit + i)
        return r

    if isinstance(u, AAP):
        src = u.src if isinstance(u.src, tuple) else sh(u.src)
        return AAP(src, tuple(sh(d) for d in u.dsts))
    return u


def rename_uops(uops: Sequence, renames: dict) -> list:
    """Rename D-row array names throughout a *flattened* μOp stream.

    The cross-op fusion pass uses this to stitch μPrograms together: one
    program's output array is renamed to the value name the next program
    reads, so both resolve to the *same* physical rows after lowering — the
    row-allocation reuse that eliminates the inter-op LISA hop.  Ports and
    C-group rows are untouched; ``bit``/``fixed`` are preserved.
    """
    if not renames:
        return list(uops)

    def fix(r):
        if isinstance(r, DRow) and r.array in renames:
            return DRow(renames[r.array], r.bit, r.fixed)
        return r

    out = []
    for u in uops:
        if isinstance(u, AAP):
            src = u.src if isinstance(u.src, tuple) else fix(u.src)
            out.append(AAP(src, tuple(fix(d) for d in u.dsts)))
        else:
            out.append(u)
    return out


def _cells_written(u) -> set:
    """B-group cells a μOp overwrites (TRA results + AAP port destinations)."""
    cells = set()
    if isinstance(u, AP):
        cells.update(p.cell for p in u.ports)
    elif isinstance(u, AAP):
        if isinstance(u.src, tuple):
            cells.update(p.cell for p in u.src)
        cells.update(d.cell for d in u.dsts if isinstance(d, Port))
    return cells


def dedupe_const_stores(uops: Sequence) -> tuple[list, list]:
    """Drop AAP constant loads that restate a B-cell's current constant.

    A forward pass tracking, per compute cell, the constant it is known to
    hold (written from C0/C1 through some port polarity and not overwritten
    since).  A later ``AAP C-row → port`` storing the same constant is a
    redundant init — across a fusion seam this is the next op's state-init
    prologue restating what the previous op left behind.  Only provably
    redundant destinations are dropped; any other write invalidates the
    cell's known constant.  Returns ``(kept_uops, kept_indices)`` so chain
    compilation can keep per-stage spans aligned.
    """
    known: dict[int, bool] = {}       # cell → constant currently stored
    out: list = []
    kept: list[int] = []
    for i, u in enumerate(uops):
        if (isinstance(u, AAP) and isinstance(u.src, CRow)
                and u.dsts and all(isinstance(d, Port) for d in u.dsts)):
            val = u.src.one
            fresh = tuple(d for d in u.dsts
                          if known.get(d.cell) != (val != d.neg))
            if not fresh:
                continue              # every destination already holds it
            for d in fresh:
                known[d.cell] = (val != d.neg)
            out.append(u if fresh == u.dsts else AAP(u.src, fresh))
            kept.append(i)
            continue
        for c in _cells_written(u):
            known.pop(c, None)
        out.append(u)
        kept.append(i)
    return out, kept


def eliminate_dead_writes(uops: Sequence, live_arrays) -> tuple[list, list]:
    """Backward dead-store elimination over a flattened μOp stream.

    ``live_arrays`` names the D-group arrays whose rows must survive to the
    end (the outputs).  Walking backwards, an AAP destination row that is
    never read downstream and is not an output is pruned; an AAP left with
    no destinations is dropped entirely (a single-row ACTIVATE read is
    non-destructive) — unless its source is a TRA triple, in which case the
    majority side effect on the cells is preserved as a plain AP.  Port
    destinations are always kept (cell liveness is not tracked backwards,
    so every cell write is conservatively live).  Returns
    ``(kept_uops, kept_indices)``.
    """
    full_live = set(live_arrays)
    live: set[tuple[str, int]] = set()

    def row_live(r: DRow) -> bool:
        return r.array in full_live or (r.array, r.bit) in live

    out: list = []
    kept: list[int] = []
    for i in range(len(uops) - 1, -1, -1):
        u = uops[i]
        if not isinstance(u, AAP):
            out.append(u)
            kept.append(i)
            continue
        dsts = tuple(d for d in u.dsts
                     if not isinstance(d, DRow) or row_live(d))
        if not dsts:
            if isinstance(u.src, tuple):
                out.append(AP(u.src))
                kept.append(i)
            continue
        for d in dsts:
            if isinstance(d, DRow) and d.array not in full_live:
                live.discard((d.array, d.bit))
        if isinstance(u.src, DRow):
            live.add((u.src.array, u.src.bit))
        out.append(u if dsts == u.dsts else AAP(u.src, dsts))
        kept.append(i)
    out.reverse()
    kept.reverse()
    return out, kept


def concat_programs(name: str, progs: Sequence[UProgram], n_bits: int,
                    inputs=(), outputs=(), scratch=(),
                    renames: Sequence[dict] | None = None,
                    optimize_seams: bool = False) -> UProgram:
    """Compose μPrograms sequentially (used for class-3 ops like mul/div that
    chain adder/mux μPrograms with shifted row bases).

    ``renames`` optionally supplies one array-rename map per program
    (:func:`rename_uops`) so consecutive programs can share rows — the
    cross-op fusion building block.  ``optimize_seams=True`` additionally
    runs :func:`dedupe_const_stores` and :func:`eliminate_dead_writes`
    (live set = ``outputs``) over the concatenated stream, removing the
    redundant init copies and dead handoff rows a seam leaves behind.
    """
    flat: list = []
    for k, p in enumerate(progs):
        ops = p.flatten()
        if renames is not None and renames[k]:
            ops = rename_uops(ops, renames[k])
        flat.extend(ops)
    if optimize_seams:
        flat, _ = dedupe_const_stores(flat)
        flat, _ = eliminate_dead_writes(flat, outputs)
    return UProgram(name=name, n_bits=n_bits, prologue=flat, body=[],
                    epilogue=[], body_reps=0, inputs=tuple(inputs),
                    outputs=tuple(outputs), scratch=tuple(scratch))
