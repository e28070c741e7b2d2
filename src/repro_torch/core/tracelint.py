"""TraceLint — static verification of lowered command traces.

The command trace (:class:`~repro_torch.core.trace.LoweredTrace`) is the last
form an operation takes before it reaches a replay FSM or a tenant's bank,
and since ``machine.define_op(compile_fn=...)`` it can come from arbitrary
user code.  A single misallocated row silently computes garbage: real-chip
characterization (arXiv:2402.18736, arXiv:2405.06081) shows that *which*
rows are simultaneously activated, and in what charge state, decides
whether an in-DRAM operation works at all.  This module checks those
structural properties without executing anything.

``lint_trace`` runs a row-liveness dataflow pass over the ``cmds`` array —
def/use chains per physical row — plus a structural pass over the ``seqs``
table.  Diagnostics carry a machine-checkable ``kind``, a severity, the
offending command index and the human row key recovered through the
``row_index`` inverse.  The diagnostic kinds:

====================  ======== ==================================================
kind                  severity what it means
====================  ======== ==================================================
``malformed-seqs``    error    ``seqs`` does not tile ``cmds`` (gap/overlap/
                               out-of-range span), or a sequence's contents do
                               not match its kind (e.g. a multi-source AAP)
``malformed-cmds``    error    unknown opcode in the command array
``copy-src-dup``      warning  a COPY whose ``c`` column does not duplicate its
                               ``b`` (src) column — the encoding invariant
``row-bounds``        error    a row operand outside the reserved ``row_index``
                               region (1-based, ``|code| <= n_rows``)
``bad-neg-port``      error    an n-wordline (negative) reference to a row that
                               is not a dual-contact cell
``tra-operand``       error    a triple-row activation naming a non-B-group row,
                               or fewer than three distinct rows
``use-before-init``   error    a read of a compute cell that was never written —
                               B-group cells power up with garbage
``const-write``       error    a write to the C0/C1 constant rows (read-only)
``operand-clobber``   error    a write to a row of a pure-input operand array —
                               the caller's data is still live there
``destroyed-read``    error    a Case-2 fused AAP copying from a row that the
                               preceding triple-row MAJ did not define — its
                               pre-activation charge is destroyed, not latched
``undefined-output``  error    a declared output row never written by the trace
``seam-clobber``      error    in a fused chain trace, a stage overwriting a row
                               of a predecessor's output value while a later
                               stage (or the chain output) still reads it
``bank-overlap``      warning  two co-scheduled requests from different tenants
                               share a bank and overlap on D-group rows
====================  ======== ==================================================

Fused chain traces (``trace.chain`` — see
:func:`repro_torch.core.compiler.compile_chain`) additionally run the seam pass:
the row-liveness walk already crosses op boundaries because the fused
stream is one command array, and ``check_seams`` models the per-op
output→input handoff on top of it, flagging cross-stage clobbers of
still-live values.  :func:`lint_graph` is the pre-synthesis counterpart:
it verifies a user ``build_graph`` AOIG *before* Step 1 runs, so
malformed graphs fail at :meth:`SimdramMachine.define_op` with a graph
diagnostic instead of a downstream synthesis crash.

Verification is wired into every entry point that accepts a trace:
``compile_trace(..., verify=)`` / :meth:`TraceCache.get` (default-on; the
report is memoized on the trace so the cached hot path never re-lints),
``SimdramMachine.define_op`` (broken user ops are rejected at registration)
and ``BankScheduler.enqueue`` (the cross-trace ``bank-overlap`` pass).
The reference package's ``python -m repro.tools.tracelint`` sweeps every
registered op × bit width.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Iterable, Sequence

from .uprogram import CELL_NAMES, DCC_CELLS

if TYPE_CHECKING:  # import cycle: trace.py lints lazily inside TraceCache
    from .trace import LoweredTrace

ERROR = "error"
WARNING = "warning"

# states of one physical row during the liveness walk
_UNDEF = 0       # B-group cell before its first write (power-up garbage)
_DEFINED = 1     # holds a value some command wrote
_ZERO = 2        # D row the runtime zero-fills before execution
_CONST = 3       # C0/C1 (read-only)
_OPERAND = 4     # D row of a pure-input array (caller data, read-only here)


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: ``kind`` is machine-checkable, ``row_key`` human."""

    kind: str
    severity: str                 # ERROR or WARNING
    message: str
    cmd_index: int | None = None  # offending row of ``cmds`` (None: global)
    row: int | None = None        # signed row operand as encoded, if any
    row_key: str | None = None    # human name via the row_index inverse

    def __str__(self) -> str:
        where = f"cmd {self.cmd_index}: " if self.cmd_index is not None else ""
        return f"{self.severity}[{self.kind}] {where}{self.message}"


@dataclasses.dataclass
class LintReport:
    """Every diagnostic ``lint_trace`` produced for one trace."""

    name: str
    n_bits: int
    diagnostics: tuple[Diagnostic, ...] = ()

    @property
    def errors(self) -> tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.severity == ERROR)

    @property
    def warnings(self) -> tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.severity == WARNING)

    @property
    def ok(self) -> bool:
        """No errors (warnings do not fail verification)."""
        return not self.errors

    def kinds(self) -> set[str]:
        return {d.kind for d in self.diagnostics}

    def render(self) -> str:
        head = (f"TraceLint: {self.name}/{self.n_bits}b — "
                f"{len(self.errors)} error(s), "
                f"{len(self.warnings)} warning(s)")
        return "\n".join([head] + [f"  {d}" for d in self.diagnostics])

    def raise_for_errors(self) -> "LintReport":
        if not self.ok:
            raise TraceLintError(self)
        return self


class TraceLintError(ValueError):
    """A trace failed static verification; ``.report`` has the findings."""

    def __init__(self, report: LintReport) -> None:
        super().__init__(report.render())
        self.report = report


def row_key_name(key: object) -> str:
    """Human name of one ``row_index`` key: ``T0``/``DCC1``, ``C0``/``C1``,
    or ``array[bit]`` for D-group rows."""
    if isinstance(key, tuple) and len(key) == 2 and key[0] == "cell":
        return CELL_NAMES.get(key[1], f"cell{key[1]}")
    if isinstance(key, tuple) and len(key) == 2:
        return f"{key[0]}[{key[1]}]"
    return str(key)


class _Linter:
    """One lint run; collects diagnostics over a single trace."""

    def __init__(self, trace: "LoweredTrace", max_diagnostics: int) -> None:
        self.trace = trace
        self.max = max_diagnostics
        self.out: list[Diagnostic] = []
        self.inv = {idx: key for key, idx in trace.row_index.items()}
        self.n_rows = len(trace.row_index)
        # row number → liveness state
        self.state: dict[int, int] = {}
        pure_inputs = set(trace.inputs) - set(trace.outputs)
        for key, idx in trace.row_index.items():
            if key in ("C0", "C1"):
                self.state[idx] = _CONST
            elif isinstance(key, tuple) and key[0] == "cell":
                self.state[idx] = _UNDEF
            elif isinstance(key, tuple) and key[0] in pure_inputs:
                self.state[idx] = _OPERAND
            else:
                # outputs/scratch/spills: the runtime zero-fills these rows
                # before the first command (executor ``alloc_operand``)
                self.state[idx] = _ZERO
        self.written: set[int] = set()

    # -- diagnostics ---------------------------------------------------------
    def emit(self, kind: str, severity: str, message: str,
             cmd_index: int | None = None, row: int | None = None) -> None:
        if len(self.out) >= self.max:
            return
        key = self.inv.get(abs(row)) if row is not None else None
        self.out.append(Diagnostic(
            kind=kind, severity=severity, message=message,
            cmd_index=cmd_index, row=row,
            row_key=row_key_name(key) if key is not None else None))

    # -- reference classification -------------------------------------------
    def _key(self, code: int) -> object:
        return self.inv.get(abs(int(code)))

    def _check_ref(self, code: int, i: int, what: str) -> bool:
        """Bounds + polarity of one signed row operand; True when usable."""
        r = abs(int(code))
        if r < 1 or r > self.n_rows:
            self.emit("row-bounds", ERROR,
                      f"{what} row {int(code)} is outside the reserved "
                      f"row_index region 1..{self.n_rows}", i, int(code))
            return False
        key = self._key(code)
        if code < 0 and not (isinstance(key, tuple) and key[0] == "cell"
                             and key[1] in DCC_CELLS):
            self.emit("bad-neg-port", ERROR,
                      f"{what} negates row {row_key_name(key)}, which has no "
                      f"n-wordline (only DCC cells do)", i, int(code))
            return False
        return True

    def _use(self, code: int, i: int, what: str) -> None:
        r = abs(int(code))
        if self.state.get(r) == _UNDEF:
            self.emit("use-before-init", ERROR,
                      f"{what} reads compute cell "
                      f"{row_key_name(self._key(code))} before any write — "
                      f"B-group cells power up with garbage", i, int(code))

    def _def(self, code: int, i: int, what: str) -> None:
        r = abs(int(code))
        st = self.state.get(r)
        key = self._key(code)
        if st == _CONST:
            self.emit("const-write", ERROR,
                      f"{what} writes constant row {row_key_name(key)} "
                      f"(C-group rows are read-only)", i, int(code))
            return
        if st == _OPERAND:
            self.emit("operand-clobber", ERROR,
                      f"{what} clobbers still-live operand row "
                      f"{row_key_name(key)} (array "
                      f"{key[0] if isinstance(key, tuple) else key!r} is a "
                      f"pure input — the caller's data lives there)",
                      i, int(code))
            return
        self.state[r] = _DEFINED
        self.written.add(r)

    # -- passes --------------------------------------------------------------
    def check_shapes(self) -> bool:
        cmds, seqs = self.trace.cmds, self.trace.seqs
        ok = True
        if cmds.ndim != 2 or (cmds.size and cmds.shape[1] != 4):
            self.emit("malformed-cmds", ERROR,
                      f"cmds must be int32[N, 4], got shape {cmds.shape}")
            ok = False
        if seqs.ndim != 2 or (seqs.size and seqs.shape[1] != 3):
            self.emit("malformed-seqs", ERROR,
                      f"seqs must be int32[M, 3], got shape {seqs.shape}")
            ok = False
        return ok

    def check_seqs(self) -> None:
        from .trace import (CMD_COPY, CMD_MAJ, SEQ_AAP, SEQ_AAP_TRA, SEQ_AP)
        cmds, seqs = self.trace.cmds, self.trace.seqs
        n = int(cmds.shape[0])
        cursor = 0
        for kind, start, end in seqs.tolist():
            if start != cursor:
                gap = "overlap" if start < cursor else "gap"
                self.emit("malformed-seqs", ERROR,
                          f"seqs table has a {gap}: sequence starts at "
                          f"cmd {start} but the previous one ended at "
                          f"{cursor}", min(start, cursor))
            if not (0 <= start < end <= n):
                self.emit("malformed-seqs", ERROR,
                          f"sequence span [{start}, {end}) falls outside "
                          f"the {n}-command array", start)
                cursor = max(cursor, end)
                continue
            ops = cmds[start:end, 0].tolist()
            if kind == SEQ_AP:
                if end - start != 1 or ops[0] != CMD_MAJ:
                    self.emit("malformed-seqs", ERROR,
                              f"AP sequence [{start}, {end}) must be exactly "
                              f"one MAJ command", start)
            elif kind == SEQ_AAP:
                srcs = {int(s) for s in cmds[start:end, 2].tolist()}
                if any(op != CMD_COPY for op in ops):
                    self.emit("malformed-seqs", ERROR,
                              f"AAP sequence [{start}, {end}) contains a "
                              f"non-COPY command", start)
                elif len(srcs) > 1:
                    self.emit("malformed-seqs", ERROR,
                              f"AAP sequence [{start}, {end}) copies from "
                              f"{len(srcs)} different source rows — one "
                              f"activation latches one row", start)
            elif kind == SEQ_AAP_TRA:
                if end - start < 2 or ops[0] != CMD_MAJ or \
                        any(op != CMD_COPY for op in ops[1:]):
                    self.emit("malformed-seqs", ERROR,
                              f"fused AAP sequence [{start}, {end}) must be "
                              f"one MAJ followed by COPY commands", start)
                else:
                    tra = {abs(int(c)) for c in cmds[start, 1:4].tolist()}
                    for j in range(start + 1, end):
                        src = int(cmds[j, 2])
                        if abs(src) not in tra:
                            self.emit(
                                "destroyed-read", ERROR,
                                f"fused AAP copies from row "
                                f"{row_key_name(self._key(src))}, which the "
                                f"preceding triple-row MAJ did not define — "
                                f"the sense amps hold the MAJ result and "
                                f"that row's pre-activation charge is "
                                f"destroyed", j, src)
            else:
                self.emit("malformed-seqs", ERROR,
                          f"unknown sequence kind {kind} at span "
                          f"[{start}, {end})", start)
            cursor = max(cursor, end)
        if cursor != n:
            self.emit("malformed-seqs", ERROR,
                      f"seqs table covers commands [0, {cursor}) but the "
                      f"command array has {n} rows", cursor)

    def check_liveness(self) -> None:
        from .trace import CMD_COPY, CMD_MAJ
        for i, (op, a, b, c) in enumerate(self.trace.cmds.tolist()):
            if op == CMD_COPY:
                if self._check_ref(b, i, "COPY src"):
                    self._use(b, i, "COPY")
                if self._check_ref(a, i, "COPY dst"):
                    self._def(a, i, "COPY")
                if c != b:
                    self.emit("copy-src-dup", WARNING,
                              f"COPY c column ({c}) does not duplicate the "
                              f"src column ({b}) — encoding invariant", i, c)
            elif op == CMD_MAJ:
                rows = []
                for code, what in ((a, "TRA port 1"), (b, "TRA port 2"),
                                   (c, "TRA port 3")):
                    if not self._check_ref(code, i, what):
                        continue
                    key = self._key(code)
                    if not (isinstance(key, tuple) and key[0] == "cell"):
                        self.emit("tra-operand", ERROR,
                                  f"{what} activates {row_key_name(key)} — "
                                  f"triple-row activation decodes B-group "
                                  f"cells only", i, int(code))
                        continue
                    rows.append(abs(int(code)))
                    self._use(code, i, what)
                if len(rows) == 3 and len(set(rows)) != 3:
                    self.emit("tra-operand", ERROR,
                              f"TRA activates only {len(set(rows))} distinct "
                              f"rows — a majority of three needs three", i,
                              int(a))
                # the activation overwrites all three cells with MAJ
                for r in set(rows):
                    self.state[r] = _DEFINED
                    self.written.add(r)
            else:
                self.emit("malformed-cmds", ERROR,
                          f"unknown opcode {op} (expected COPY=0 or MAJ=1)",
                          i)

    def check_outputs(self) -> None:
        end = int(self.trace.cmds.shape[0])
        for out in self.trace.outputs:
            rows = [(key, idx) for key, idx in self.trace.row_index.items()
                    if isinstance(key, tuple) and key[0] == out]
            if not rows:
                self.emit("undefined-output", ERROR,
                          f"output array {out!r} has no rows in this trace "
                          f"— nothing ever materializes it", end)
                continue
            for key, idx in rows:
                if idx not in self.written:
                    self.emit("undefined-output", ERROR,
                              f"output row {row_key_name(key)} is never "
                              f"written by the trace", end, idx)

    def check_seams(self) -> None:
        """Cross-op handoff pass for fused chain traces: model which rows
        carry each stage's output value and flag a *different* stage
        overwriting one of them while a later stage or the chain output
        still reads it (``seam-clobber``).  The producer materializing its
        own output rows is of course legal."""
        from .trace import CMD_COPY
        chain = self.trace.chain
        producer: dict[int, tuple[str, int]] = {}   # row → (value, stage)
        for k, stg in enumerate(chain.stages):
            for key, idx in self.trace.row_index.items():
                if isinstance(key, tuple) and key[0] == stg.value:
                    producer[idx] = (stg.value, k)
        if not producer:
            return
        outputs = set(self.trace.outputs)
        cmds = self.trace.cmds.tolist()
        last_read: dict[int, int] = {}
        for i, (op, _a, b, _c) in enumerate(cmds):
            if op == CMD_COPY and abs(int(b)) in producer:
                last_read[abs(int(b))] = i
        end = len(cmds)

        def stage_of(i: int) -> int:
            for k, stg in enumerate(chain.stages):
                if stg.cmd_start <= i < stg.cmd_end:
                    return k
            return -1

        for i, (op, a, _b, _c) in enumerate(cmds):
            if op != CMD_COPY:
                continue   # a MAJ writes B-group cells only, never D rows
            r = abs(int(a))
            hit = producer.get(r)
            if hit is None:
                continue
            value, k_prod = hit
            k_wr = stage_of(i)
            if k_wr == k_prod:
                continue
            live_until = end if value in outputs else last_read.get(r, -1)
            if live_until > i:
                wr_op = chain.stages[k_wr].op if k_wr >= 0 else "?"
                self.emit(
                    "seam-clobber", ERROR,
                    f"fused stage {k_wr} ({wr_op}) overwrites row "
                    f"{row_key_name(self._key(a))} of value {value!r} "
                    f"(produced by stage {k_prod}, "
                    f"{chain.stages[k_prod].op}) while it is still live — "
                    f"a later stage or the chain output still reads it",
                    i, int(a))

    def run(self) -> LintReport:
        if self.check_shapes():
            self.check_seqs()
            self.check_liveness()
            self.check_outputs()
            if getattr(self.trace, "chain", None) is not None:
                self.check_seams()
        return LintReport(name=self.trace.name, n_bits=self.trace.n_bits,
                          diagnostics=tuple(self.out))


def lint_trace(trace: "LoweredTrace",
               max_diagnostics: int = 100) -> LintReport:
    """Statically verify one lowered trace; returns every diagnostic.

    Runs the seqs-table structural pass and the row-liveness def/use pass
    described in the module docstring.  Nothing is executed.  Use
    :meth:`LoweredTrace.lint` for the memoized per-trace report, and
    :meth:`LintReport.raise_for_errors` to turn errors into
    :class:`TraceLintError`.
    """
    return _Linter(trace, max_diagnostics).run()


# ---------------------------------------------------------------------------
# Pre-synthesis pass: user build_graph AOIGs
# ---------------------------------------------------------------------------


def lint_graph(g, name: str = "graph",
               max_diagnostics: int = 100) -> LintReport:
    """Statically verify a user AOIG/MIG *before* synthesis runs.

    ``machine.define_op(build_graph=...)`` accepts arbitrary user code; a
    malformed graph used to surface as a crash deep inside Step-1
    synthesis or row allocation.  This pass checks the graph itself:

    * ``graph-no-outputs`` (error) — no named outputs: the op would
      synthesize to an empty trace;
    * ``graph-dup-output`` (error) — two outputs share a name (the later
      one silently wins downstream);
    * ``graph-bad-literal`` (error) — an output or gate fanin literal
      referencing a node id outside the graph;
    * ``graph-unused-input`` (warning) — a primary input no output
      transitively depends on.
    """
    from .graph import PI, lit_node
    out: list[Diagnostic] = []

    def emit(kind: str, severity: str, message: str) -> None:
        if len(out) < max_diagnostics:
            out.append(Diagnostic(kind=kind, severity=severity,
                                  message=message))

    n = len(g.nodes)
    if not g.outputs:
        emit("graph-no-outputs", ERROR,
             "graph declares no outputs — it would synthesize to an "
             "empty operation")
    seen: set[str] = set()
    for oname, lit_ in g.outputs:
        if oname in seen:
            emit("graph-dup-output", ERROR,
                 f"output {oname!r} is declared twice — the later "
                 f"definition silently wins downstream")
        seen.add(oname)
        if not (0 <= lit_node(lit_) < n):
            emit("graph-bad-literal", ERROR,
                 f"output {oname!r} references node {lit_node(lit_)} "
                 f"outside the {n}-node graph")
    for nid, node in enumerate(g.nodes):
        for f in node.fanin:
            if not (0 <= lit_node(f) < n):
                emit("graph-bad-literal", ERROR,
                     f"node {nid} ({node.kind}) fanin references node "
                     f"{lit_node(f)} outside the {n}-node graph")
    live: set[int] = set()
    stack = [lit_node(lit_) for _, lit_ in g.outputs
             if 0 <= lit_node(lit_) < n]
    while stack:
        nid = stack.pop()
        if nid in live:
            continue
        live.add(nid)
        stack.extend(lit_node(f) for f in g.nodes[nid].fanin
                     if 0 <= lit_node(f) < n)
    for nid, node in enumerate(g.nodes):
        if node.kind == PI and nid not in live:
            emit("graph-unused-input", WARNING,
                 f"primary input {node.name!r} feeds no output")
    return LintReport(name=name, n_bits=0, diagnostics=tuple(out))


# ---------------------------------------------------------------------------
# Cross-trace pass: bank packing
# ---------------------------------------------------------------------------


def row_footprint(trace: "LoweredTrace") -> frozenset:
    """The D-group row keys a trace touches — the rows that persist in a
    subarray between requests (B/C rows are per-op working state)."""
    return frozenset(trace.d_rows)


def lint_packing(
        requests: Sequence[tuple[str, str, frozenset, Iterable[int]]],
        max_diagnostics: int = 100) -> list[Diagnostic]:
    """Flag co-scheduled requests from different tenants that share a bank
    with overlapping D-row footprints.

    ``requests`` rows are ``(name, tenant, footprint, bank_ids)`` in
    submission order (``footprint`` from :func:`row_footprint`).  The
    scheduler serializes streams per bank, but operand/output rows persist
    in the subarray across requests — two tenants packed onto one bank with
    the same row keys read and overwrite each other's data.
    """
    out: list[Diagnostic] = []
    seen: list[tuple[str, str, frozenset, set[int]]] = []
    for name, tenant, fp, bank_ids in requests:
        banks = set(int(b) for b in bank_ids)
        for p_name, p_tenant, p_fp, p_banks in seen:
            if len(out) >= max_diagnostics:
                return out
            if p_tenant == tenant:
                continue
            shared = banks & p_banks
            overlap = fp & p_fp
            if shared and overlap:
                rows = ", ".join(sorted(row_key_name(k) for k in overlap)[:4])
                more = len(overlap) - min(len(overlap), 4)
                out.append(Diagnostic(
                    kind="bank-overlap", severity=WARNING,
                    message=(
                        f"request {name!r} (tenant {tenant!r}) and "
                        f"{p_name!r} (tenant {p_tenant!r}) are co-scheduled "
                        f"on bank(s) {sorted(shared)} with {len(overlap)} "
                        f"overlapping row(s): {rows}"
                        + (f" (+{more} more)" if more else "")),
                    row_key=rows))
        seen.append((name, tenant, fp, banks))
    return out
