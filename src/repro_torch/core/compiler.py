"""Step 2 of the SIMDRAM framework: MIG → μProgram (paper §4.2, App. B).

Implements

* **Task 1 — row-to-operand allocation** (paper Algorithm 1): a greedy,
  topological traversal of the MIG that binds each MAJ operand to one of the
  six B-group compute rows, honoring the two PuM constraints the paper calls
  out: TRAs destroy all three input rows, and only six compute rows exist.
  Negated operands are routed through dual-contact cells (Case 1 of Alg. 1);
  operands produced by a parent MAJ reuse the rows holding the parent's
  result (Case 2); when no compute row is free the allocator closes the
  current *phase* — in our implementation this surfaces as a preservation
  copy or a spill to a D-group scratch row (Case 3).

* **Task 2 — μOp generation + coalescing** (paper §4.2.3): emission of
  AAP/AP command sequences per MAJ node, followed by the paper's two
  coalescing optimizations — Case 1 (multiple copies from one source fuse
  into a single multi-row AAP using a pair address) and Case 2 (an AP
  followed by an AAP reading the TRA result fuses into one AAP whose first
  ACTIVATE performs the majority) — and generalization of the 1-bit body
  into an n-bit loop (the control unit's addi/bnez/done μOps).

The scheduler runs a *steady-state fixpoint* for loop-carried state (e.g.
the carry row of an adder): the home cell of each state is chosen so that
the value naturally ends the body where the next iteration reads it,
eliminating fix-up copies — this is what lets the compiler reproduce the
paper's Table 5 command counts (e.g. 8n+1 for addition) exactly.
"""
from __future__ import annotations

import bisect
import dataclasses

from .graph import MAJ, PI, LogicGraph, lit_neg, lit_node
from .uprogram import (AAP, AP, C0, C1, CRow, DCC_CELLS, DRow, N_B_CELLS,
                       PAIR_ADDRESSES, Port, T_CELLS, UProgram,
                       dedupe_const_stores, eliminate_dead_writes,
                       rename_uops)

# value ids: int MIG node ids for MAJ results; strings for PI values.
Value = object


@dataclasses.dataclass
class CellInfo:
    value: Value | None = None
    neg: bool = False            # cell stores complement of `value`


class AllocationError(RuntimeError):
    pass


class Scheduler:
    """Schedules one MIG into AAP/AP μOps over the six compute rows."""

    def __init__(self, mig: LogicGraph, binding: dict[str, object],
                 out_targets: dict[str, object], state_outputs: dict[str, str],
                 scratch_prefix: str = "spill") -> None:
        """
        binding: PI name → RowRef (DRow/CRow) or Port (state entry location).
        out_targets: output name → DRow destination (None = keep in cells).
        state_outputs: output name → state name (value must survive to end).
        """
        self.mig = mig
        self.binding = binding
        self.out_targets = out_targets
        self.state_outputs = state_outputs
        self.cells = [CellInfo() for _ in range(N_B_CELLS)]
        self.ops: list = []
        self.spills: dict[Value, DRow] = {}
        self.n_spills = 0
        self.scratch_prefix = scratch_prefix
        self._prepare()

    # ------------------------------------------------------------------ prep
    def _prepare(self) -> None:
        g = self.mig
        self.order = [n for n in g.topo_order() if g.nodes[n].kind == MAJ]
        self.uses: dict[Value, int] = {}
        self.neg_uses: dict[Value, int] = {}
        self.pi_value: dict[int, Value] = {}
        for nid in g.topo_order():
            node = g.nodes[nid]
            if node.kind == PI:
                self.pi_value[nid] = f"pi:{node.name}"
        for nid in self.order:
            for f in self.mig.nodes[nid].fanin:
                v = self._val_of(f)
                if v is None:
                    continue
                self.uses[v] = self.uses.get(v, 0) + 1
                if lit_neg(f):
                    self.neg_uses[v] = self.neg_uses.get(v, 0) + 1
        for name, o in g.outputs:
            v = self._val_of(o)
            if v is None:
                continue
            self.uses[v] = self.uses.get(v, 0) + 1
            if lit_neg(o):
                self.neg_uses[v] = self.neg_uses.get(v, 0) + 1
        # seed state entry locations
        for pi_name, ref in self.binding.items():
            if isinstance(ref, Port):
                cell = ref.cell
                self.cells[cell] = CellInfo(f"pi:{pi_name}", ref.neg)

    def _val_of(self, literal: int) -> Value | None:
        nid = lit_node(literal)
        node = self.mig.nodes[nid]
        if node.kind == PI:
            return self.pi_value[nid]
        if node.kind == MAJ:
            return nid
        return None  # constant

    # ------------------------------------------------------------- utilities
    def _readable_ports(self, v: Value, neg: bool) -> list[Port]:
        """All ports currently reading value (neg ? ¬v : v)."""
        ports = []
        for cell, info in enumerate(self.cells):
            if info.value != v:
                continue
            if cell in DCC_CELLS:
                # positive port reads info stored polarity; neg port flips
                ports.append(Port(cell, neg=(info.neg != neg)))
            elif info.neg == neg:
                ports.append(Port(cell))
        return [p for p in ports if not (p.neg and p.cell not in DCC_CELLS)]

    def _cells_holding(self, v: Value) -> list[int]:
        return [c for c, info in enumerate(self.cells) if info.value == v]

    def _source_for(self, v: Value, neg: bool):
        """A copy source (RowRef) for value v with polarity neg, or None."""
        ports = self._readable_ports(v, neg)
        if ports:
            return ports[0]
        if isinstance(v, str) and v.startswith("const:"):
            one = v.endswith("1")
            return (C0 if one else C1) if neg else (C1 if one else C0)
        if isinstance(v, str) and v.startswith("pi:"):
            ref = self.binding[v[3:]]
            if isinstance(ref, (DRow, CRow)) and not neg:
                return ref
            if isinstance(ref, CRow) and neg:
                return C1 if not ref.one else C0
        if v in self.spills:
            row, spill_neg = self.spills[v]
            if spill_neg == neg:
                return row
        return None

    def _is_recopyable(self, v: Value) -> bool:
        """Values that live in D/C rows can always be re-materialized."""
        if isinstance(v, str) and v.startswith("const:"):
            return True
        if isinstance(v, str) and v.startswith("pi:"):
            return isinstance(self.binding[v[3:]], (DRow, CRow))
        return v in self.spills

    def _reserved_cells(self, protect: set[int]) -> set[int]:
        """One surviving cell per live, non-recopyable value (otherwise two
        cells holding the same value each treat the other as a backup and
        both get reallocated, losing the value entirely)."""
        reserved: set[int] = set()
        by_value: dict[Value, list[int]] = {}
        for cell, info in enumerate(self.cells):
            if info.value is not None:
                by_value.setdefault(info.value, []).append(cell)
        for v, cells in by_value.items():
            if self.uses.get(v, 0) <= 0 or self._is_recopyable(v):
                continue
            keep = [c for c in cells if c not in protect] or cells
            # prefer keeping a DCC copy if the value still has negated uses
            if self.neg_uses.get(v, 0) > 0:
                dcc = [c for c in keep if c in DCC_CELLS]
                keep = dcc or keep
            reserved.add(keep[0])
        return reserved

    def _free_cells(self, protect: set[int]) -> list[int]:
        reserved = self._reserved_cells(protect)
        free = [c for c in range(N_B_CELLS)
                if c not in protect and c not in reserved]

        # prefer truly-dead cells first, T cells before DCC
        def rank(c):
            info = self.cells[c]
            dead = info.value is None or self.uses.get(info.value, 0) <= 0
            return (0 if dead else 1, 0 if c in T_CELLS else 1)
        return sorted(free, key=rank)

    def _emit_copy(self, src, dst_ports: tuple[Port, ...]) -> None:
        self.ops.append(AAP(src, tuple(dst_ports)))

    def _copy_into(self, v: Value, neg: bool, want_dcc: bool,
                   protect: set[int], extra_copies: int = 0) -> Port:
        """Materialize value v (polarity ``neg``) into a fresh cell; returns
        the port to read it from.  ``extra_copies``>0 requests pair-address
        coalescing (paper Case 1) when another copy of the same value will be
        needed."""
        src = self._source_for(v, False)
        src_neg = False
        if src is None:
            src = self._source_for(v, True)
            src_neg = True
        if src is None:
            raise AllocationError(f"value {v} is not materializable")
        # reading src gives (v ⊕ src_neg); we want polarity `neg` at the port.
        # If polarities mismatch and we must flip, route through a DCC cell.
        need_flip = (src_neg != neg)
        must_dcc = need_flip or want_dcc
        free = self._free_cells(protect)
        dcc_free = [c for c in free if c in DCC_CELLS]
        t_free = [c for c in free if c in T_CELLS]
        if must_dcc and not dcc_free:
            if need_flip:
                # a DCC row is mandatory: spill a DCC resident to free one
                self._make_room(protect, need_dcc=True)
                dcc_free = [c for c in self._free_cells(protect)
                            if c in DCC_CELLS]
                if not dcc_free:
                    raise AllocationError("no DCC cell free for negated operand")
            else:
                # fall back: copy through a T cell (no polarity flip needed)
                must_dcc = False
        pool = dcc_free if must_dcc else (t_free or dcc_free)
        if not pool:
            # Alg. 1 Case 3: the phase is full — free a row by spilling the
            # live value with the most distant next use to a D-group scratch
            # row, then retry.
            self._make_room(protect, need_dcc=must_dcc)
            free = self._free_cells(protect)
            dcc_free = [c for c in free if c in DCC_CELLS]
            t_free = [c for c in free if c in T_CELLS]
            pool = dcc_free if must_dcc else (t_free or dcc_free)
            if not pool:
                raise AllocationError("no free compute row (phase overflow)")
        dst = pool[0]
        dsts = [Port(dst)]
        if extra_copies > 0:
            # paper Case-1 coalescing: same source into a fixed pair address
            for pair in PAIR_ADDRESSES:
                cells = {p.cell for p in pair}
                if dst in cells:
                    other = (cells - {dst}).pop()
                    if other in free and other not in protect:
                        dsts = list(pair)
                        break
        self._emit_copy(src, tuple(dsts))
        for p in dsts:
            # cell stores bitline (=v⊕src_neg) through port polarity
            self.cells[p.cell] = CellInfo(v, neg=(src_neg != p.neg))
        ports = self._readable_ports(v, neg)
        ports = [p for p in ports if p.cell in {d.cell for d in dsts}]
        if not ports:
            raise AllocationError("copy did not yield requested polarity")
        return ports[0]

    # ------------------------------------------------------------- main pass
    def run(self) -> None:
        self._cursor = 0
        for i, nid in enumerate(self.order):
            self._cursor = i
            self._schedule_node(nid)
        self._cursor = len(self.order)
        self._emit_outputs()

    def _future_copy_need(self, v: Value, from_node_idx: int) -> int:
        """How many additional positive-polarity materializations of v the
        remaining nodes will need (drives pair coalescing)."""
        need = 0
        for nid in self.order[from_node_idx:]:
            for f in self.mig.nodes[nid].fanin:
                if self._val_of(f) == v and not lit_neg(f):
                    need += 1
        return need

    def _schedule_node(self, nid: int) -> None:
        g = self.mig
        node = g.nodes[nid]
        idx = self.order.index(nid)
        # does this node's RESULT need a future negated read?  if so, one
        # operand should sit in a DCC cell so the result lands there.
        result_needs_neg = self.neg_uses.get(nid, 0) > 0
        ports: list[Port] = []
        used_cells: set[int] = set()
        operands = []
        for f in node.fanin:
            v = self._val_of(f)
            operands.append((v, lit_neg(f)))
        # preservation (Alg.1 Case 3 / phase handling): if this AP will
        # consume the last live copy of a value still needed later and the
        # value cannot be re-copied from a D row, save it first.
        self._preserve_live_values(operands, used_cells)
        have_dcc = False
        # first pass: satisfy from existing cells
        pending = []
        for v, neg in operands:
            if v is None:
                pending.append((v, neg, None))
                continue
            cand = [p for p in self._readable_ports(v, neg) if p.cell not in used_cells]
            if cand:
                # consume a *surplus* copy if possible: reading a cell through
                # a TRA destroys it, so prefer cells that are not the value's
                # reserved survivor (unless this is its final use), and avoid
                # burning a DCC that negated uses still need.
                uses_after = self.uses.get(v, 0) - 1
                reserved = self._reserved_cells(used_cells) if uses_after > 0 else set()
                cand.sort(key=lambda p: (p.cell in reserved, p.cell in DCC_CELLS))
                p = cand[0]
                ports.append(p)
                used_cells.add(p.cell)
                have_dcc = have_dcc or p.cell in DCC_CELLS
                self.uses[v] -= 1
                pending.append(None)
            else:
                pending.append((v, neg, "copy"))
        # second pass: constants and copies — materialize negated operands
        # first (they are the ones that must land in scarce DCC cells)
        pend_order = sorted((k for k, x in enumerate(pending) if x is not None),
                            key=lambda k: not pending[k][1])
        for k in pend_order:
            item = pending[k]
            v, neg, _ = item
            if v is None:  # constant input (C-group row copied into a T row)
                one = lit_neg(node.fanin[k])
                p = self._copy_into(f"const:{int(one)}", False, False, used_cells)
                ports.append(p)
                used_cells.add(p.cell)
                continue
            want_dcc = (result_needs_neg and not have_dcc and not neg)
            extra = self._future_copy_need(v, idx + 1) if not neg else 0
            p = self._copy_into(v, neg, want_dcc or neg, used_cells,
                                extra_copies=extra)
            ports.append(p)
            used_cells.add(p.cell)
            have_dcc = have_dcc or p.cell in DCC_CELLS
            self.uses[v] -= 1
        if len({p.cell for p in ports}) != 3:
            raise AllocationError(f"node {nid}: could not place 3 operands")
        self.ops.append(AP(tuple(ports)))
        for p in ports:
            self.cells[p.cell] = CellInfo(nid, neg=p.neg)

    def _preserve_live_values(self, operands, protect: set[int]) -> None:
        """Before an AP, copy out any value whose last cell copy the AP will
        destroy while later uses remain and no D-row source exists.

        Preservation copies are added to ``protect`` (shared with the node's
        port selection) so that (a) a later operand's preservation cannot
        clobber them and (b) the AP does not consume the survivor."""
        # how many DCC cells must stay available for this node's own negated,
        # non-resident operands (they can only be materialized through a DCC)
        dcc_demand = sum(
            1 for v, neg in operands
            if v is not None and neg and not self._readable_ports(v, True))
        seen: set[Value] = set()
        for v, _neg in operands:
            if v is None or v in seen or self._is_recopyable(v):
                continue
            seen.add(v)
            holding = self._cells_holding(v)
            n_operand_uses = sum(1 for (vv, _) in operands if vv == v)
            uses_after = self.uses.get(v, 0) - n_operand_uses
            if uses_after <= 0:
                continue
            # cells of v that are protected (outside this AP) survive
            survivors = len([c for c in holding if c in protect])
            consumable = len(holding) - survivors
            if survivors >= 1 or consumable > n_operand_uses:
                continue
            free_dcc = sum(1 for c in self._free_cells(set(holding) | protect)
                           if c in DCC_CELLS)
            neg_needed = (self.neg_uses.get(v, 0) > 0
                          and free_dcc > dcc_demand)
            try:
                p = self._copy_into(v, False, want_dcc=neg_needed,
                                    protect=set(holding) | protect,
                                    extra_copies=uses_after - 1)
                protect.add(p.cell)
            except AllocationError:
                self._spill(v, protect=set(holding) | protect)

    def _spill(self, v: Value, protect: set[int]) -> None:
        spill_neg = False
        src = self._source_for(v, False)
        if src is None:
            src = self._source_for(v, True)   # spill the complement instead
            spill_neg = True
        if src is None:
            raise AllocationError(f"cannot spill {v}: no source")
        row = DRow(f"{self.scratch_prefix}{self.n_spills}", 0, fixed=True)
        self.n_spills += 1
        self._emit_copy(src, (row,))
        self.spills[v] = (row, spill_neg)

    def _make_room(self, protect: set[int], need_dcc: bool) -> None:
        """Spill the live, non-recopyable value with the most distant next
        use so one of its cells becomes free (Alg. 1 phase boundary)."""
        victims: list[tuple[int, Value]] = []
        for cell, info in enumerate(self.cells):
            if cell in protect or info.value is None:
                continue
            if need_dcc and cell not in DCC_CELLS:
                continue
            v = info.value
            if self.uses.get(v, 0) <= 0 or self._is_recopyable(v):
                continue
            victims.append((self._next_use_distance(v), v))
        if not victims:
            raise AllocationError("no spill victim available")
        victims.sort(reverse=True)
        self._spill(victims[0][1], protect)

    def _next_use_distance(self, v: Value) -> int:
        for d, nid in enumerate(self.order[getattr(self, "_cursor", 0):]):
            for f in self.mig.nodes[nid].fanin:
                if self._val_of(f) == v:
                    return d
        return 1 << 30

    # ------------------------------------------------------------- outputs
    def _emit_outputs(self) -> None:
        for name, o in self.mig.outputs:
            target = self.out_targets.get(name)
            if target is None:
                continue
            v = self._val_of(o)
            neg = lit_neg(o)
            if v is None:  # constant output
                self._emit_copy(C1 if neg else C0, (target,))
                continue
            src = self._source_for(v, neg)
            if src is None:
                # flip through DCC
                p = self._copy_into(v, neg, want_dcc=True, protect=set())
                src = p
            self._emit_copy(src, (target,))
            self.uses[v] -= 1

    def end_cells_of(self, v: Value) -> list[tuple[int, bool]]:
        return [(c, info.neg) for c, info in enumerate(self.cells) if info.value == v]


# ---------------------------------------------------------------------------
# Peephole: paper Case-2 coalescing (AP followed by AAP reading the result)
# ---------------------------------------------------------------------------

def coalesce_case2(ops: list) -> list:
    out: list = []
    for u in ops:
        if (isinstance(u, AAP) and isinstance(u.src, Port) and out
                and isinstance(out[-1], AP)):
            ap = out[-1]
            match = [q for q in ap.ports if q.cell == u.src.cell]
            if match and match[0].neg == u.src.neg:
                # the AAP reads exactly the TRA bitline → fuse
                out[-1] = AAP(ap.ports, u.dsts)
                continue
        out.append(u)
    return out


# ---------------------------------------------------------------------------
# Slice-op compilation driver (n-bit loop generalization)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SliceSpec:
    """A 1-bit slice of an n-bit operation (paper: 'MIG represents a
    1-bit-wide computation')."""
    name: str
    build: object                  # fn(g: LogicGraph) -> None
    arrays_in: tuple[str, ...]     # PIs bound to DRow(array, i)
    invariants: dict = dataclasses.field(default_factory=dict)  # PI → DRow fixed
    states: dict = dataclasses.field(default_factory=dict)      # state → init (0/1)
    out_array: str | None = "out"  # per-bit output PI target array
    epilogue_outputs: dict = dataclasses.field(default_factory=dict)
    # output name → (array, bit): written once after the loop (e.g. borrow)


STATE_HOME_GUESS = [3, 2, 1, 0]  # T3, T2, T1, T0


def compile_slice(spec: SliceSpec, n_bits: int, optimize: bool = True,
                  mig: LogicGraph | None = None) -> UProgram:
    """Compile a slice MIG into an n-bit μProgram with steady-state homes."""
    from .synthesis import aoig_to_mig_naive, optimize_mig

    g = LogicGraph()
    spec.build(g)
    # Step 1: optimize=True is the SIMDRAM pipeline; optimize=False keeps the
    # naive AND/OR→MAJ substitution (the paper's Ambit baseline).
    g = optimize_mig(g) if optimize else aoig_to_mig_naive(g)
    state_names = list(spec.states)

    def schedule(homes: dict[str, tuple[int, bool]]):
        binding: dict[str, object] = {}
        for a in spec.arrays_in:
            binding[a] = DRow(a, 0)
        for pi, row in spec.invariants.items():
            binding[pi] = row
        for s in state_names:
            cell, neg = homes[s]
            binding[s] = Port(cell, neg=neg and cell in DCC_CELLS)
        out_targets: dict[str, object] = {}
        state_out_map: dict[str, str] = {}
        for name, _ in g.outputs:
            if name in spec.states:
                state_out_map[name] = name
                out_targets[name] = None
            elif spec.out_array is not None and name not in spec.epilogue_outputs:
                out_targets[name] = DRow(spec.out_array, 0)
        sched = Scheduler(g, binding, out_targets, state_out_map,
                          scratch_prefix=f"{spec.name}_sp")
        sched.run()
        return sched

    # fixpoint on state home cells: the body is rescheduled until each
    # loop-carried value naturally ends the iteration in the cell the next
    # iteration reads it from; if the fixpoint does not converge, explicit
    # fix-up copies are appended to the body instead.
    def state_end_locs(sched):
        locs = {}
        taken: set[int] = set()
        for name, o in g.outputs:
            if name not in spec.states:
                continue
            v = sched._val_of(o)
            want_neg = lit_neg(o)
            cands = []
            for c, cell_neg in sched.end_cells_of(v):
                if c in taken:
                    continue
                eff_neg = cell_neg != want_neg  # True → cell stores ¬state
                if not eff_neg or c in DCC_CELLS:
                    cands.append((c, eff_neg))
            locs[name] = cands
        return locs

    homes = {s: (STATE_HOME_GUESS[i % 4], False) for i, s in enumerate(state_names)}
    sched = schedule(homes)
    for _ in range(4):
        locs = state_end_locs(sched)
        new_homes = dict(homes)
        taken: set[int] = set()
        converged = True
        for name in state_names:
            cands = [c for c in locs.get(name, []) if c[0] not in taken]
            if not cands:
                converged = False
                continue
            best = homes[name] if homes[name] in cands else cands[0]
            taken.add(best[0])
            new_homes[name] = best
            if best != homes[name]:
                converged = False
        if converged:
            break
        homes = new_homes
        sched = schedule(homes)
    # verify; append fix-up copies for any state not ending at its home
    fixups: list = []
    locs = state_end_locs(sched)
    for name in state_names:
        home = homes[name]
        cands = locs.get(name, [])
        if home in cands:
            continue
        if not cands:
            raise AllocationError(f"state {name} does not survive the body")
        c, eff_neg = cands[0]
        src = Port(c, neg=False) if not eff_neg else Port(c, neg=True)
        cell, want_store_neg = home
        dst = Port(cell, neg=want_store_neg and cell in DCC_CELLS)
        if want_store_neg and cell not in DCC_CELLS:
            raise AllocationError(f"state {name}: fix-up needs DCC home")
        fixups.append(AAP(src, (dst,)))

    body = coalesce_case2(sched.ops) + fixups
    # prologue: state init (from C-group constant rows, or from a D row for
    # data-dependent initial state such as abs' sign-extend carry)
    prologue: list = []
    for s in state_names:
        cell, neg = homes[s]
        init = spec.states[s]
        if isinstance(init, DRow):
            if neg and cell not in DCC_CELLS:
                raise AllocationError(f"state {s}: negated init needs a DCC home")
            prologue.append(AAP(init, (Port(cell, neg=neg),)))
        else:
            src = (C0 if init else C1) if neg else (C1 if init else C0)
            prologue.append(AAP(src, (Port(cell),)))
    epilogue: list = []
    for name, (arr, bit) in spec.epilogue_outputs.items():
        o = dict(g.outputs)[name]
        v = sched._val_of(o)
        locs = sched.end_cells_of(v)
        want_neg = lit_neg(o)
        port = None
        for c, cell_neg in locs:
            if cell_neg == want_neg:
                port = Port(c)
                break
            if c in DCC_CELLS:
                port = Port(c, neg=True)
                break
        if port is None and locs:
            # bounce through a dual-contact cell to obtain the complement
            c, cell_neg = locs[0]
            bounce = DCC_CELLS[0] if locs[0][0] != DCC_CELLS[0] else DCC_CELLS[1]
            epilogue.append(AAP(Port(c), (Port(bounce),)))
            port = Port(bounce, neg=(cell_neg == want_neg) is False)
        if port is None:
            raise AllocationError(f"epilogue output {name} unreadable")
        epilogue.append(AAP(port, (DRow(arr, bit, fixed=True),)))

    scratch = tuple(sorted({r.array for u in body + prologue + epilogue
                            for r in _drows(u) if r.array.endswith("_sp0") or
                            "_sp" in r.array}))
    inputs = tuple(spec.arrays_in) + tuple(
        r.array for r in (spec.invariants or {}).values() if isinstance(r, DRow))
    return UProgram(name=spec.name, n_bits=n_bits, prologue=prologue,
                    body=body, epilogue=epilogue, inputs=inputs,
                    outputs=(spec.out_array,) if spec.out_array else
                    tuple(a for a, _ in spec.epilogue_outputs.values()),
                    scratch=scratch)


def _drows(u) -> list[DRow]:
    rows = []
    if isinstance(u, AAP):
        if isinstance(u.src, DRow):
            rows.append(u.src)
        rows.extend(d for d in u.dsts if isinstance(d, DRow))
    return rows


def compile_flat(name: str, g: LogicGraph, binding: dict[str, object],
                 out_targets: dict[str, object], n_bits: int,
                 optimize: bool = True) -> UProgram:
    """Compile a full (non-looped) MIG: used by tree-structured ops
    (reductions, bitcount) and as a building block for class-3 ops."""
    from .synthesis import aoig_to_mig_naive, optimize_mig
    g = optimize_mig(g) if optimize else aoig_to_mig_naive(g)
    sched = Scheduler(g, binding, out_targets, {}, scratch_prefix=f"{name}_sp")
    sched.run()
    ops = coalesce_case2(sched.ops)
    return UProgram(name=name, n_bits=n_bits, prologue=ops, body=[],
                    epilogue=[], body_reps=0)


# ---------------------------------------------------------------------------
# Cross-op trace fusion (ROADMAP item 5): whole pipelines → one μProgram
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChainStage:
    """One op application inside a fused pipeline, in SSA form.

    ``op`` names a registered operation; ``inputs`` are value names —
    chain-external operands or earlier stages' outputs — bound
    *positionally* to the op's declared operand arrays; ``output`` names
    the value this stage produces (single-assignment: no value may be
    defined twice)."""
    op: str
    inputs: tuple[str, ...]
    output: str


def _as_stage(s) -> ChainStage:
    """Coerce ``ChainStage`` | ``(op, inputs, output)`` (inputs may be a
    bare string for unary ops) to a normalized :class:`ChainStage`."""
    if isinstance(s, ChainStage):
        return ChainStage(str(s.op), tuple(str(i) for i in s.inputs),
                          str(s.output))
    op, ins, out = s
    if isinstance(ins, str):
        ins = (ins,)
    return ChainStage(str(op), tuple(str(i) for i in ins), str(out))


def chain_signature(stages, outputs=None) -> str:
    """Canonical cache-key string for a fused chain: the constituent op
    names plus the full value wiring (and the requested outputs, when
    explicit) — everything :func:`compile_chain` consumes besides the
    width/optimize pair that completes the cache key."""
    stages = [_as_stage(s) for s in stages]
    sig = "chain:" + "|".join(
        f"{st.op}({','.join(st.inputs)})->{st.output}" for st in stages)
    if outputs is not None:
        sig += ">>" + ",".join(outputs)
    return sig


def _check_value_name(v: str) -> None:
    if v == "cell" or v.startswith("_fuse"):
        raise ValueError(f"chain value name {v!r} is reserved ('cell' "
                         "collides with B-group row keys; '_fuse*' is the "
                         "fused per-stage scratch namespace)")


def compile_chain(stages, n_bits: int, optimize: bool = True,
                  compile_fn=None, outputs=None,
                  name: str | None = None) -> UProgram:
    """Fuse a pipeline of registered ops into ONE μProgram (the cross-op
    half of SIMDRAM Step 2, which the paper runs per operation only).

    Each stage's μProgram is compiled (``compile_fn(op, n_bits, optimize)``
    — default: the process-wide registry), flattened, and renamed into a
    shared value namespace: the stage's declared operand arrays become the
    stage's input value names, its output array becomes the stage's output
    value, and every other array it touches moves to a private
    ``_fuse{k}_*`` namespace.  Row-allocation reuse falls out of the
    renaming — a producer's output rows and its consumer's input rows are
    now the *same* symbolic rows, so one :func:`~repro_torch.core.trace
    .lower_program` call binds them to the same physical rows and no
    inter-op copy (no LISA hop) remains at the seam.  Two seam
    optimizations then run over the concatenated stream:
    :func:`~repro_torch.core.uprogram.dedupe_const_stores` (a stage
    re-initializing a B-cell to a constant the boundary already left
    there) and :func:`~repro_torch.core.uprogram.eliminate_dead_writes` (rows
    only the per-op contract kept alive, e.g. an unconsumed epilogue
    output).

    ``outputs=None`` keeps the chain's *leaves* (values produced but never
    consumed); pass an explicit tuple to keep intermediates readable too.
    The returned program carries ``chain`` metadata (per-stage μOp spans,
    constituent ops, elision counters) that lowering converts to
    :class:`~repro_torch.core.trace.ChainInfo` seam metadata.
    """
    stages = tuple(_as_stage(s) for s in stages)
    if not stages:
        raise ValueError("compile_chain needs at least one stage")
    if compile_fn is None:
        from .circuits import compile_operation as compile_fn
    # SSA validation + external-input discovery (first-use order)
    produced: list[str] = []
    external: list[str] = []
    for st in stages:
        for v in st.inputs:
            _check_value_name(v)
            if v not in produced and v not in external:
                external.append(v)
        _check_value_name(st.output)
        if st.output in produced or st.output in external:
            raise ValueError(f"chain value {st.output!r} is redefined — "
                             "chain values are single-assignment")
        produced.append(st.output)
    consumed = {v for st in stages for v in st.inputs}
    if outputs is None:
        outs = tuple(v for v in produced if v not in consumed)
    else:
        outs = tuple(outputs)
        unknown = [o for o in outs if o not in produced]
        if unknown:
            raise ValueError(f"requested chain outputs {unknown} are not "
                             "produced by any stage")
    # per-stage compile → flatten → rename into the shared value namespace
    streams: list[list] = []
    unfused_rows = 0        # Σ per-stage row footprints (per-op lowering)
    for k, st in enumerate(stages):
        prog = compile_fn(st.op, n_bits, optimize)
        names = tuple(dict.fromkeys(prog.inputs))
        if len(st.inputs) != len(names):
            raise ValueError(
                f"chain stage {k} ({st.op!r}) takes {len(names)} operands "
                f"{names}, got {len(st.inputs)}")
        if len(prog.outputs) != 1:
            raise ValueError(
                f"chain stage {k} ({st.op!r}) has outputs {prog.outputs} — "
                "fusion chains single-output ops")
        ops = prog.flatten()
        renames = dict(zip(names, st.inputs))
        renames[prog.outputs[0]] = st.output
        for u in ops:
            for r in _drows(u):
                if r.array not in renames:
                    renames[r.array] = f"_fuse{k}_{r.array}"
        unfused_rows += len({(r.array, r.bit) for u in ops
                             for r in _drows(u)})
        streams.append(rename_uops(ops, renames))
    # concatenate + seam optimizations, tracking original indices so the
    # per-stage spans survive into the optimized stream
    starts = [0]
    for ops in streams:
        starts.append(starts[-1] + len(ops))
    flat = [u for ops in streams for u in ops]
    n_raw = len(flat)
    flat, k1 = dedupe_const_stores(flat)
    flat, k2 = eliminate_dead_writes(flat, outs + tuple(external))
    kept = [k1[j] for j in k2]
    spans = tuple(
        (st.op, st.output,
         bisect.bisect_left(kept, starts[k]),
         bisect.bisect_left(kept, starts[k + 1]))
        for k, st in enumerate(stages))
    arrays = {(r.array, r.bit) for u in flat for r in _drows(u)}
    chain_meta = {
        "stages": spans,
        "ops": tuple(dict.fromkeys(st.op for st in stages)),
        "elided_rows": unfused_rows - len(arrays),
        "elided_seqs": n_raw - len(flat),
    }
    scratch = tuple(sorted({a for a, _ in arrays}
                           - set(external) - set(outs)))
    cname = name or "chain(" + "+".join(st.op for st in stages) + ")"
    return UProgram(name=cname, n_bits=n_bits, prologue=flat, body=[],
                    epilogue=[], body_reps=0, inputs=tuple(external),
                    outputs=outs, scratch=scratch, chain=chain_meta)


def fuse_chain(specs, n_bits: int, optimize: bool = True, compile_fn=None,
               outputs=None, name: str | None = None):
    """Compile a pipeline spec straight to one executable
    :class:`~repro_torch.core.trace.LoweredTrace` (``compile_chain`` +
    ``lower_program``); the trace carries
    :class:`~repro_torch.core.trace.ChainInfo` seam metadata.  Cached variants
    live in :meth:`~repro_torch.core.trace.TraceCache.get_chain`."""
    from .trace import lower_program
    return lower_program(compile_chain(specs, n_bits, optimize=optimize,
                                       compile_fn=compile_fn,
                                       outputs=outputs, name=name))
