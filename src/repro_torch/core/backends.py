"""Pluggable μProgram execution backends (the Step-3 seam).

Every ``execute_program`` call lowers its compiled
:class:`~repro_torch.core.uprogram.UProgram` (once, memoized) to the shared
command-trace IR — :class:`~repro_torch.core.trace.LoweredTrace` — and every
backend consumes that same trace with the same plane-level operand format:
``name → int32[n_bits, W]`` bit planes (optionally
``int32[banks, n_bits, W]`` for the paper's multi-bank scaling).
Registered backends:

* ``kernel``    — the Fig.-7 control-unit FSM
  (:func:`repro_torch.kernels.ops.run_trace_kernel`): the trace's int32
  command stream driving a row file, in the hand-written CUDA kernel on a
  CUDA tensor (banks folded into one launch) and in its plain PyTorch
  version on a CPU tensor.  The default.
* ``unrolled``  — :func:`repro_torch.core.unrolled.run_trace_unrolled`:
  the trace walked in Python as eager bitwise torch over plane words (COPY
  aliases, MAJ is bitwise majority), on whatever device the planes live
  on; the bank axis rides along in every op.
* ``reference`` — decodes the trace back to μOps and runs them on the
  faithful numpy :class:`~repro_torch.core.executor.Subarray` model: exact
  AAP/AP semantics, destructive TRAs, DCC ports.  The oracle.

New substrates plug in with :func:`register_backend` — a ``BackendFn``
takes ``(trace, operands, out_bits=...)`` — and are immediately usable from
every ``bbop_*`` and from :class:`~repro_torch.ops.bbops.simdram_pipeline`
via ``backend="name"``.  A backend that takes the bank axis itself sets
``fn.banked = True``; the others run once per bank.

Timed execution.  :func:`timed` opens a scope in which every
:func:`execute_program` call — on *any* registered substrate — charges its
modeled DRAM cost to a :class:`PerfStats` accumulator: μProgram command
latency/energy from :class:`~repro_torch.simdram.timing.SimdramPerfModel`,
inter-op operand relocation from its ``MovementModel`` (intra-bank LISA
hops, inter-bank RowClone-PSM transfers via the layout movement hooks),
and every transposition-unit pass (``to_bitplanes``/``from_bitplanes``)
from its ``TranspositionModel``.  Charging is trace-level, like
``TRANSPOSE_STATS``: it reflects the command stream the chain *issues*,
independent of which substrate executes it — the paper's §7 methodology
(sum of AAP/AP command-sequence latencies), reported per live pipeline.

``timed(mode="replay")`` (or ``simdram_pipeline(timed=True,
model="replay")``) additionally replays every lowered trace on the
cycle-accurate per-bank FSM
(:class:`~repro_torch.simdram.timing.TraceReplayTiming`) and accumulates the
replayed ns/nJ next to the analytic ones — measured-style timing behind the
same accumulator surface.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch

from .. import telemetry
from ..simdram.layout import (LANE_WORD, register_movement_hook,
                              register_transpose_hook)
from ..simdram.timing import SimdramPerfModel
from .trace import GLOBAL_TRACE_CACHE, LoweredTrace, lower_program
from .uprogram import UProgram

# backend: (trace, operands: dict[str, int32[n_bits, W]], out_bits) → outputs
BackendFn = Callable[..., dict]

_REGISTRY: dict[str, BackendFn] = {}
_DEFAULT = "kernel"


def register_backend(name: str, fn: BackendFn) -> None:
    _REGISTRY[name] = fn


def list_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_backend(name: str | None = None) -> BackendFn:
    key = name or _DEFAULT
    try:
        return _REGISTRY[key]
    except KeyError:
        raise KeyError(f"unknown backend {key!r}; registered: "
                       f"{list_backends()}") from None


def default_backend() -> str:
    return _DEFAULT


# bumped on every set_default_backend so use_backend can tell "still the
# default I set" from "somebody re-set it inside my scope" (a plain name
# comparison cannot: set_default_backend(<the scope's own name>) must win)
_DEFAULT_EPOCH = 0


def set_default_backend(name: str) -> None:
    global _DEFAULT, _DEFAULT_EPOCH
    if name not in _REGISTRY:
        raise KeyError(f"unknown backend {name!r}; registered: "
                       f"{list_backends()}")
    _DEFAULT = name
    _DEFAULT_EPOCH += 1


@contextlib.contextmanager
def use_backend(name: str):
    """Scoped default-backend override: ``with use_backend("reference"): ...``

    On exit the previous default is restored *only if* no
    ``set_default_backend`` call was made inside the scope — an explicit
    set survives the scope instead of being silently discarded.
    """
    global _DEFAULT, _DEFAULT_EPOCH
    prev = _DEFAULT
    epoch_at_entry = _DEFAULT_EPOCH
    set_default_backend(name)
    token = _DEFAULT_EPOCH
    try:
        yield
    finally:
        if _DEFAULT_EPOCH == token:
            # restoring rewinds the epoch too, so enclosing scopes still
            # see "unchanged" and restore in turn
            _DEFAULT = prev
            _DEFAULT_EPOCH = epoch_at_entry


# ---------------------------------------------------------------------------
# Timed execution: modeled-DRAM cost accounting for any substrate
# ---------------------------------------------------------------------------

# PerfStats currently charging (a stack: nested timed scopes all observe;
# the same accumulator registered twice still charges once).  Accumulators
# *owned* by a SimdramMachine only observe work executed by that machine —
# two interleaved machine sessions never cross-charge.
_ACTIVE_STATS: list["PerfStats"] = []


# replaced by repro_torch.simdram.machine at import with its current_machine();
# kept injectable so this module never imports the machine layer eagerly
def _current_machine():
    return None


def _charging_stats(machine=None) -> list["PerfStats"]:
    """Active accumulators that should observe work executed by
    ``machine`` (None = the innermost open machine session, if any)."""
    if not _ACTIVE_STATS:
        return _ACTIVE_STATS
    eff = machine if machine is not None else _current_machine()
    return [st for st in _ACTIVE_STATS
            if st.owner is None or st.owner is eff]

# op outputs tracked for movement charging are bounded: consumers only ever
# reach a handful of ops back, and an unbounded map would pin every
# intermediate plane of a long timed region in memory
_RESIDENT_CAP = 64

# the per-accumulator μProgram/trace cost memos are bounded the same way:
# a long-lived accumulator (e.g. one threaded through a whole decode
# service) would otherwise pin every ad-hoc program and trace it ever
# charged, forever, by id — FIFO-capped like _RESIDENT_CAP bounds _resident
_COST_CAP = 256


@dataclasses.dataclass
class PerfStats:
    """Modeled-DRAM cost accumulator for a timed execution scope.

    Three meters, analytic by default (paper §7 methodology):

    * ``exec_ns`` / ``exec_nj`` — per ``execute_program`` call, the
      μProgram's summed AAP/AP command-sequence latency and energy
      (:meth:`SimdramPerfModel.latency_ns` / ``energy_nj``).  Banks run the
      command stream in lockstep, so latency is charged once per call and
      energy × banks.
    * movement — per in-DRAM operand relocation, broken out per kind: when
      an op consumes another op's output planes directly, its ``n_bits``
      result rows are charged one *intra-bank* LISA hop each
      (``MovementModel.intra_bank_ns``); bank redistributions
      (``BitplaneArray.rebank`` via the layout movement hooks) charge
      *inter-bank* RowClone-PSM transfers (``inter_bank_ns``).  Plane-level
      rewrites (``flip_msb``/``split_lanes``/``astype_bits``) produce new
      arrays and are *not* tracked — they are free row re-indexing.
    * transposition — per transposition-unit pass inside the scope
      (``TranspositionModel.first_subarray_ns``), broken out per direction
      (``to_bitplanes`` loads vs ``from_bitplanes`` stores).

    With ``mode="replay"`` every executed trace is *additionally* replayed
    on the cycle-accurate per-bank FSM array
    (:class:`~repro_torch.simdram.timing.TraceReplayTiming`): ``replay_ns`` /
    ``replay_nj`` accumulate next to the analytic meters (replay ≥ analytic
    always — the FSMs can only add stall cycles, and stalls burn background
    power), so replayed-vs-analytic deltas are attributable per op.  The
    replay runs one FSM per engaged bank under the rank-level constraints
    the ``DRAMTiming`` enables (tRRD, the four-activate tFAW window,
    tREFI/tRFC refresh windows; ``desync_policy="lockstep"`` restores the
    legacy broadcast FSM), and the per-bank breakdown accumulates here:
    ``replay_tfaw_ns`` / ``replay_refresh_ns`` attribute stall time to the
    two rank mechanisms and ``replay_bank_spread_ns`` sums each op's
    slowest-minus-fastest bank finish gap.  An inter-bank
    ``BitplaneArray.rebank`` scatter serializes each bank's planes over
    the internal bus, giving each bank a data-arrival skew; the layout
    movement hook records it here *keyed to the scattered plane array*,
    and the replayed op that consumes those planes issues each bank's
    stream at that offset (consumed once).

    Charging is trace-level, like ``TRANSPOSE_STATS``: one charge per
    executed trace, whatever the substrate.  Movement/transposition *energy* is not
    modeled (the paper provides no figures for either); ``total_nj`` is
    execution energy only.
    """

    model: SimdramPerfModel = dataclasses.field(
        default_factory=SimdramPerfModel)
    mode: str = "analytic"             # or "replay"
    # replay mode only: thread the accumulated replay clock into each op's
    # refresh-window grid, so refresh windows are anchored in pipeline time
    # instead of per-op t=0 and ops shorter than tREFI still accrue their
    # share of refresh stall across a long chain (the cross-op refresh
    # phase).  Phase threading only ever moves windows *earlier* in an
    # op's local time, so phased replay_ns >= per-op-anchored replay_ns
    # for chains whose individual ops fit inside one tREFI interval.
    refresh_phase: bool = False
    # the SimdramMachine this accumulator belongs to, if any: an owned
    # accumulator only observes its own machine's work even while other
    # sessions' timed scopes are open (see _charging_stats)
    owner: object = dataclasses.field(default=None, repr=False, compare=False)
    exec_ns: float = 0.0
    exec_nj: float = 0.0
    replay_ns: float = 0.0
    replay_nj: float = 0.0
    replay_stall_ns: float = 0.0
    replay_tfaw_ns: float = 0.0        # stall attributed to the tFAW window
    replay_refresh_ns: float = 0.0     # stall attributed to refresh windows
    replay_bank_spread_ns: float = 0.0  # Σ per-op (max − min) bank finish
    movement_intra_ns: float = 0.0
    movement_inter_ns: float = 0.0
    transpose_to_ns: float = 0.0
    transpose_from_ns: float = 0.0
    n_programs: int = 0
    n_commands: int = 0
    n_moves_intra: int = 0
    n_moves_inter: int = 0
    n_moves_elided: int = 0    # inter-op hops the fusion allocator removed
    n_transposes_to: int = 0
    n_transposes_from: int = 0
    elem_ops: int = 0
    max_banks: int = 1
    per_op: dict = dataclasses.field(default_factory=dict)
    # tenant name → child PerfStats: per-tenant attribution for scheduled
    # (submit/drain) execution.  Children share this accumulator's owner,
    # and are *additionally* registered only while their tenant's
    # submissions execute, so concurrent tenants never cross-charge and
    # the tenant rollup sums to this accumulator's totals.
    tenants: dict = dataclasses.field(default_factory=dict)
    # id(planes) → planes for the most recent op outputs of this scope
    # (strong refs so ids cannot be recycled, FIFO-bounded by
    # _RESIDENT_CAP); consumed ids trigger movement charges
    _resident: dict = dataclasses.field(default_factory=dict, repr=False)
    # trace.fingerprint → (latency_ns, energy_nj, n_commands) — scoped to
    # this accumulator so cache entries die with it, FIFO-bounded by
    # _COST_CAP.  Content-keyed: an ``id()`` key could alias once the entry
    # no longer pins its program and the allocator reuses the address for a
    # new one, and it missed on every recompile of the same op anyway.
    _prog_costs: dict = dataclasses.field(default_factory=dict, repr=False)
    # (trace.fingerprint, banks, offsets, phase) → ReplayResult, same bounds
    _replay_costs: dict = dataclasses.field(default_factory=dict, repr=False)
    # id(planes) → (per-bank issue offsets, planes) for inter-bank scatters
    # (data-arrival skew; strong refs keep ids stable, FIFO-bounded like
    # _resident) — consumed by the op that consumes the scattered planes
    _bank_skew: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self) -> None:
        if self.mode not in ("analytic", "replay"):
            raise ValueError(f"unknown timing mode {self.mode!r} "
                             "(expected 'analytic' or 'replay')")

    def _prog_cost(self, prog: UProgram, trace: LoweredTrace) -> tuple:
        hit = self._prog_costs.get(trace.fingerprint)
        if hit is None:
            mix = prog.command_mix()
            hit = (self.model.latency_ns(prog), self.model.energy_nj(prog),
                   mix["AAP"] + mix["AP"])
            self._prog_costs[trace.fingerprint] = hit
            while len(self._prog_costs) > _COST_CAP:
                del self._prog_costs[next(iter(self._prog_costs))]
        return hit

    def _replay_cost(self, trace: LoweredTrace, banks: int, offsets,
                     phase_ns: float = 0.0):
        key = (trace.fingerprint, banks, offsets, round(phase_ns, 3))
        hit = self._replay_costs.get(key)
        if hit is None:
            # L2: the TraceCache replay memo (the owner machine's memory,
            # else the process-wide cache) — persists across accumulator
            # lifetimes, so a fresh timed() scope replays warm traces as
            # a table lookup
            memory = getattr(self.owner, "memory", None)
            if memory is None:
                memory = GLOBAL_TRACE_CACHE
            hit = self.model.replay_result(trace, banks=banks,
                                           offsets_ns=offsets,
                                           refresh_phase_ns=phase_ns,
                                           cache=memory)
            self._replay_costs[key] = hit
            while len(self._replay_costs) > _COST_CAP:
                del self._replay_costs[next(iter(self._replay_costs))]
        return hit

    def _op_shares(self, prog: UProgram,
                   trace: LoweredTrace) -> tuple[list, int]:
        """Per-op charge split for one trace: ``([(per_op key, fraction)],
        n_stage_ops)``.  Fused chain traces split proportionally by each
        stage's share of command sequences and perform one element-op per
        stage per lane; plain traces map to their own name."""
        chain = getattr(trace, "chain", None)
        stages = getattr(chain, "stages", ()) if chain is not None else ()
        if stages:
            total = max(1, sum(s.seq_end - s.seq_start for s in stages))
            return ([(f"{s.op}/{prog.n_bits}b",
                      (s.seq_end - s.seq_start) / total)
                     for s in stages], len(stages))
        return ([(f"{prog.name}/{prog.n_bits}b", 1.0)], 1)

    # -- charging (called by execute_program / the layout hooks) ------------
    def charge_program(self, prog: UProgram, banks: int, lanes: int,
                       trace: LoweredTrace | None = None,
                       offsets=None) -> None:
        replayable = trace is not None
        if trace is None:
            # analytic-only callers: the lowering memo makes this cheap,
            # and the trace fingerprint is the stable cost-memo key
            trace = lower_program(prog)
        lat, en, cmds = self._prog_cost(prog, trace)
        self.exec_ns += lat
        self.exec_nj += en * banks
        self.n_programs += 1
        self.n_commands += cmds
        self.max_banks = max(self.max_banks, banks)
        # fused chain traces attribute per_op charges to the constituent
        # stages (proportional to each stage's share of command sequences),
        # so per-op stall attribution survives fusion — the aggregate
        # chain gets no row of its own (it would double-count)
        shares, n_stage_ops = self._op_shares(prog, trace)
        self.elem_ops += lanes * banks * n_stage_ops
        entries = []
        for key, frac in shares:
            d = self.per_op.setdefault(key,
                                       {"calls": 0, "ns": 0.0, "nj": 0.0,
                                        "replay_ns": 0.0})
            d["calls"] += 1
            d["ns"] += lat * frac
            d["nj"] += en * banks * frac
            entries.append((d, frac))
        if self.mode == "replay" and replayable:
            # phase = the replay clock *before* this op starts
            phase_ns = self.replay_ns if self.refresh_phase else 0.0
            res = self._replay_cost(trace, banks, offsets, phase_ns)
            self.replay_ns += res.ns
            self.replay_stall_ns += res.stall_ns
            self.replay_tfaw_ns += res.tfaw_stall_ns
            self.replay_refresh_ns += res.refresh_stall_ns
            self.replay_bank_spread_ns += res.bank_spread_ns
            self.replay_nj += self.model.replay_energy_nj(
                prog, trace, banks=banks, result=res)
            for d, frac in entries:
                d["replay_ns"] += res.ns * frac

    def charge_banked_share(self, prog: UProgram, trace: LoweredTrace,
                            banks_total: int, banks_own: int,
                            lanes: int) -> None:
        """Charge this accumulator its *share* of one banked dispatch that
        several requests rode together (the batched drain path:
        :meth:`~repro_torch.simdram.machine.SimdramMachine.drain` with
        ``batch=True``).

        The stacked execute issues ONE command stream to ``banks_total``
        banks and the machine accumulator takes the full banked
        :meth:`charge_program`; each rider owns ``banks_own`` of those
        banks.  Latency — a shared, overlapped quantity — is apportioned
        by bank fraction, and per-bank energy / element-ops are charged
        for the rider's own banks, so summing ``exec_ns`` / ``exec_nj`` /
        ``elem_ops`` (and, under the default per-op-anchored refresh
        phase, the replay meters) over all riders reproduces the banked
        machine charge exactly.  Counters (``n_programs``,
        ``n_commands``, ``per_op["calls"]``) count per rider — each rider
        did submit a request — so in batched drains the tenant-summed
        counters intentionally exceed the machine's dispatch counts.
        """
        lat, en, cmds = self._prog_cost(prog, trace)
        frac = banks_own / max(1, banks_total)
        self.exec_ns += lat * frac
        self.exec_nj += en * banks_own
        self.n_programs += 1
        self.n_commands += cmds
        self.max_banks = max(self.max_banks, banks_own)
        shares, n_stage_ops = self._op_shares(prog, trace)
        self.elem_ops += lanes * banks_own * n_stage_ops
        entries = []
        for key, share in shares:
            d = self.per_op.setdefault(key,
                                       {"calls": 0, "ns": 0.0, "nj": 0.0,
                                        "replay_ns": 0.0})
            d["calls"] += 1
            d["ns"] += lat * frac * share
            d["nj"] += en * banks_own * share
            entries.append((d, share))
        if self.mode == "replay":
            phase_ns = self.replay_ns if self.refresh_phase else 0.0
            res = self._replay_cost(trace, banks_total, None, phase_ns)
            self.replay_ns += res.ns * frac
            self.replay_stall_ns += res.stall_ns * frac
            self.replay_tfaw_ns += res.tfaw_stall_ns * frac
            self.replay_refresh_ns += res.refresh_stall_ns * frac
            self.replay_bank_spread_ns += res.bank_spread_ns * frac
            self.replay_nj += self.model.replay_energy_nj(
                prog, trace, banks=banks_total, result=res) * frac
            for d, share in entries:
                d["replay_ns"] += res.ns * frac * share

    def note_elided_movement(self, n_rows: int) -> None:
        """Count an inter-op relocation the fusion allocator removed:
        metered (so fused-vs-unfused hop deltas are provable from one
        snapshot) but never charged — the whole point of eliding it."""
        del n_rows          # the hop never happens; only its count matters
        self.n_moves_elided += 1

    def charge_movement(self, n_rows: int, inter_bank: bool = False) -> None:
        if inter_bank:
            self.movement_inter_ns += self.model.movement.inter_bank_ns(
                n_rows)
            self.n_moves_inter += 1
        else:
            self.movement_intra_ns += self.model.movement.intra_bank_ns(
                n_rows)
            self.n_moves_intra += 1

    def charge_transpose(self, n_bits: int, lanes: int,
                         kind: str = "to") -> None:
        ns = self.model.transposition.first_subarray_ns(n_bits, lanes)
        if kind == "from":
            self.transpose_from_ns += ns
            self.n_transposes_from += 1
        else:
            self.transpose_to_ns += ns
            self.n_transposes_to += 1

    def note_output(self, planes) -> None:
        """Track an op output for movement charging (FIFO-bounded)."""
        self._resident[id(planes)] = planes
        while len(self._resident) > _RESIDENT_CAP:
            del self._resident[next(iter(self._resident))]

    def note_bank_skew(self, banks: int, n_rows: int, planes,
                       machine=None) -> None:
        """Record the per-bank data-arrival skew of an inter-bank scatter,
        keyed to the scattered plane array: the redistributed rows ride the
        shared internal bus serially, so bank *k*'s plane stack is complete
        ``k × rows_per_bank × t_PSM`` after bank 0's.  The replayed program
        that *consumes those planes* takes the skew as its per-bank issue
        offsets (a one-shot: once the banks have executed an op they are
        back in step up to the FSM's own desynchronization).  The skew is
        scoped to the machine session it was recorded under (``machine``):
        a different machine replaying the same planes must not consume
        another session's offsets."""
        if self.mode != "replay" or banks <= 1 or planes is None:
            return      # analytic accumulators never read offsets
        per_bank_ns = self.model.movement.inter_bank_ns(n_rows) / banks
        skew = tuple(k * per_bank_ns for k in range(banks))
        self._bank_skew[id(planes)] = (skew, planes, machine)
        while len(self._bank_skew) > _RESIDENT_CAP:
            del self._bank_skew[next(iter(self._bank_skew))]

    def take_bank_skew(self, planes_id: int, banks: int, machine=None):
        """Consume the skew recorded for a scattered plane array (if its
        bank count matches the consuming op's).  A pending skew recorded
        under a *different* machine's session is left pending — the
        rightful machine's next replayed op still consumes it."""
        hit = self._bank_skew.get(planes_id)
        if hit is None or hit[2] is not machine:
            return None
        del self._bank_skew[planes_id]
        return hit[0] if len(hit[0]) == banks else None

    # -- aggregates ---------------------------------------------------------
    @property
    def movement_ns(self) -> float:
        return self.movement_intra_ns + self.movement_inter_ns

    @property
    def n_moves(self) -> int:
        return self.n_moves_intra + self.n_moves_inter

    @property
    def transpose_ns(self) -> float:
        return self.transpose_to_ns + self.transpose_from_ns

    @property
    def n_transposes(self) -> int:
        return self.n_transposes_to + self.n_transposes_from

    @property
    def total_ns(self) -> float:
        return self.exec_ns + self.movement_ns + self.transpose_ns

    @property
    def total_nj(self) -> float:
        return self.exec_nj

    @property
    def replay_total_ns(self) -> float:
        """Replayed end-to-end latency: FSM-replayed execution plus the
        (mode-independent) movement/transposition charges."""
        return self.replay_ns + self.movement_ns + self.transpose_ns

    def gops(self) -> float:
        """Effective element-ops per modeled nanosecond (= GOps/s), counting
        every engaged SIMD lane × bank and *all* modeled overheads."""
        return self.elem_ops / self.total_ns if self.total_ns else 0.0

    def gops_per_bank(self) -> float:
        return self.gops() / max(1, self.max_banks)

    def reset(self) -> None:
        fresh = PerfStats(model=self.model, mode=self.mode,
                          refresh_phase=self.refresh_phase)
        for f in dataclasses.fields(self):
            if f.name not in ("model", "mode", "refresh_phase", "owner"):
                setattr(self, f.name, getattr(fresh, f.name))

    def snapshot(self) -> dict:
        """Structured, machine-readable view of every meter — per-kind
        movement and transposition breakdowns, replay stall attribution,
        and the per-tenant rollup.  :meth:`report` renders from this;
        benchmarks and serving layers should consume the snapshot instead
        of parsing report text.  Values are plain floats/ints/dicts
        (recursively so for ``tenants``), safe to serialize as JSON."""
        snap = {
            "mode": self.mode,
            "refresh_phase": self.refresh_phase,
            "totals": {
                "ns": self.total_ns, "nj": self.total_nj,
                "gops": self.gops(), "gops_per_bank": self.gops_per_bank(),
                "elem_ops": self.elem_ops, "max_banks": self.max_banks,
                "replay_total_ns": self.replay_total_ns,
            },
            "execute": {
                "ns": self.exec_ns, "nj": self.exec_nj,
                "n_programs": self.n_programs,
                "n_commands": self.n_commands,
            },
            "replay": {
                "ns": self.replay_ns, "nj": self.replay_nj,
                "stall_ns": self.replay_stall_ns,
                "tfaw_stall_ns": self.replay_tfaw_ns,
                "refresh_stall_ns": self.replay_refresh_ns,
                "bank_spread_ns": self.replay_bank_spread_ns,
            },
            "movement": {
                "ns": self.movement_ns, "n": self.n_moves,
                "per_kind": {
                    "intra": {"ns": self.movement_intra_ns,
                              "n": self.n_moves_intra},
                    "inter": {"ns": self.movement_inter_ns,
                              "n": self.n_moves_inter},
                    "elided": {"ns": 0.0, "n": self.n_moves_elided},
                },
            },
            "transposition": {
                "ns": self.transpose_ns, "n": self.n_transposes,
                "per_kind": {
                    "to": {"ns": self.transpose_to_ns,
                           "n": self.n_transposes_to},
                    "from": {"ns": self.transpose_from_ns,
                             "n": self.n_transposes_from},
                },
            },
            "per_op": {op: dict(d) for op, d in self.per_op.items()},
            "tenants": {name: st.snapshot()
                        for name, st in self.tenants.items()},
        }
        return snap

    def report(self) -> str:
        snap = self.snapshot()
        tot, ex = snap["totals"], snap["execute"]
        mv, tr = snap["movement"], snap["transposition"]
        lines = [
            f"modeled DRAM cost: {tot['ns']:.1f} ns / "
            f"{tot['nj']:.1f} nJ  ({ex['n_programs']} μPrograms, "
            f"{ex['n_commands']} command sequences, "
            f"banks={tot['max_banks']})",
            f"  execute    {ex['ns']:12.1f} ns  {ex['nj']:10.1f} nJ",
        ]
        if snap["mode"] == "replay":
            rp = snap["replay"]
            lines += [
                f"  replayed   {rp['ns']:12.1f} ns  "
                f"{rp['nj']:10.1f} nJ  "
                f"(+{rp['stall_ns']:.1f} ns stall vs analytic)",
                f"    tFAW stalls     {rp['tfaw_stall_ns']:9.1f} ns   "
                f"refresh stalls {rp['refresh_stall_ns']:9.1f} ns "
                f"({'phase-threaded' if snap['refresh_phase'] else 'per-op anchored'})",
                f"    bank finish spread {rp['bank_spread_ns']:6.1f} ns"
                f"  (Σ per-op slowest − fastest bank)",
            ]
        lines += [
            f"  movement   {mv['ns']:12.1f} ns  "
            f"({mv['n']} relocations)",
            f"    intra-bank LISA {mv['per_kind']['intra']['ns']:9.1f} ns  "
            f"({mv['per_kind']['intra']['n']} hops)",
            f"    inter-bank PSM  {mv['per_kind']['inter']['ns']:9.1f} ns  "
            f"({mv['per_kind']['inter']['n']} transfers)",
        ]
        if mv["per_kind"]["elided"]["n"]:
            lines.append(
                f"    fusion-elided         0.0 ns  "
                f"({mv['per_kind']['elided']['n']} hops removed)")
        lines += [
            f"  transpose  {tr['ns']:12.1f} ns  "
            f"({tr['n']} passes)",
            f"    to_bitplanes    {tr['per_kind']['to']['ns']:9.1f} ns  "
            f"({tr['per_kind']['to']['n']} passes)",
            f"    from_bitplanes  {tr['per_kind']['from']['ns']:9.1f} ns  "
            f"({tr['per_kind']['from']['n']} passes)",
            f"  effective  {tot['gops']:.4f} GOps/s "
            f"({tot['gops_per_bank']:.4f} per bank)",
        ]
        for op, d in sorted(snap["per_op"].items()):
            extra = (f" {d['replay_ns']:10.1f} ns replayed"
                     if snap["mode"] == "replay" else "")
            lines.append(f"    {op:<24} ×{d['calls']:<4} {d['ns']:10.1f} ns "
                         f"{d['nj']:10.1f} nJ{extra}")
        for name, t in sorted(snap["tenants"].items()):
            lines.append(
                f"  tenant {name:<17} {t['totals']['ns']:10.1f} ns  "
                f"{t['totals']['nj']:10.1f} nJ  "
                f"({t['execute']['n_programs']} μPrograms, "
                f"{t['totals']['gops']:.4f} GOps/s)")
        return "\n".join(lines)


def active_stats() -> tuple["PerfStats", ...]:
    """The PerfStats currently charging (outermost first)."""
    return tuple(_ACTIVE_STATS)


def _default_model() -> SimdramPerfModel:
    """The perf model fresh accumulators charge with when none is given —
    the default machine's, so the ambient ``timed()`` surface and
    :class:`~repro_torch.simdram.machine.SimdramMachine` sessions agree."""
    from ..simdram.machine import default_machine
    return default_machine().model


@contextlib.contextmanager
def timed(backend: str | None = None, stats: PerfStats | None = None,
          model: SimdramPerfModel | None = None, mode: str | None = None,
          refresh_phase: bool | None = None):
    """Scoped timed execution: every ``execute_program`` call and every
    transposition-unit pass inside the scope charges its modeled DRAM cost.

    ::

        with timed(backend="kernel") as stats:
            out = bbop_add(a, b, 8)
        print(stats.report())

    ``mode="replay"`` meters the cycle-accurate trace-replay substrate next
    to the analytic model (``stats.replay_ns`` / ``replay_nj``): one FSM
    per engaged bank, coupled by the rank-level tRRD/tFAW activation
    windows and tREFI/tRFC refresh windows of the model's ``DRAMTiming``
    (disable with ``tFAW_ns=0`` / ``tREFI_ns=0``; ``desync_policy=
    "lockstep"`` restores the legacy broadcast FSM).  The per-bank
    breakdown lands in ``replay_tfaw_ns`` / ``replay_refresh_ns`` /
    ``replay_bank_spread_ns`` and in ``report()``.  ``refresh_phase=True``
    (replay mode) threads the accumulated replay clock into each op's
    refresh-window grid, so refresh stall accrues across op boundaries in
    long chains instead of re-anchoring at every op's t=0.  Pass an
    existing ``stats`` to keep accumulating across scopes (e.g. one
    accumulator for a whole decode loop); nested scopes each observe every
    charge.  Yields the :class:`PerfStats`.
    """
    if stats is not None and model is not None and stats.model is not model:
        raise ValueError(
            "pass either an existing stats accumulator (charged with its "
            "own model) or a model for a fresh one, not both — a shared "
            "accumulator cannot switch models mid-flight")
    if stats is not None and mode is not None and stats.mode != mode:
        raise ValueError(
            f"stats accumulator runs in {stats.mode!r} mode; it cannot "
            f"switch to {mode!r} mid-flight — pass a fresh accumulator")
    if stats is not None and refresh_phase is not None \
            and stats.refresh_phase != refresh_phase:
        raise ValueError(
            "stats accumulator cannot switch refresh-phase threading "
            "mid-flight — pass a fresh accumulator")
    st = stats if stats is not None else PerfStats(
        model=model or _default_model(), mode=mode or "analytic",
        refresh_phase=bool(refresh_phase))
    ctx = use_backend(backend) if backend is not None \
        else contextlib.nullcontext()
    with ctx:
        # an accumulator already active (shared across nested scopes) is
        # not re-registered — it must charge once, not once per scope
        fresh = not any(s is st for s in _ACTIVE_STATS)
        if fresh:
            _ACTIVE_STATS.append(st)
        try:
            yield st
        finally:
            if fresh:
                for i in range(len(_ACTIVE_STATS) - 1, -1, -1):
                    if _ACTIVE_STATS[i] is st:
                        del _ACTIVE_STATS[i]
                        break
                # movement tracking is scoped: op outputs stop being
                # "resident" (and their memory is released) when the
                # accumulator's outermost scope closes; unconsumed scatter
                # skew dies with the scope too
                st._resident.clear()
                st._bank_skew.clear()


def _transpose_hook(kind: str, n_bits: int, lanes: int) -> None:
    for st in _charging_stats():
        st.charge_transpose(n_bits, lanes, kind=kind)


def _movement_hook(kind: str, n_rows: int, banks: int | None = None,
                   planes=None) -> None:
    inter = kind == "inter"
    eff = _current_machine()
    for st in _charging_stats(eff):
        if kind == "elided":
            # a hop the fusion allocator removed: counted, never charged
            st.note_elided_movement(n_rows)
            continue
        st.charge_movement(n_rows, inter_bank=inter)
        if inter and banks:
            # scatter: the serialized bus transfer desynchronizes the
            # banks; the skew is keyed to the session that scattered them
            st.note_bank_skew(banks, n_rows, planes, machine=eff)


register_transpose_hook(_transpose_hook)
register_movement_hook(_movement_hook)


def execute_program(prog: UProgram, operands: dict, out_bits=None,
                    backend: str | None = None) -> dict:
    """Lower a μProgram to its command trace (memoized) and dispatch it to
    a backend; banked operands run over every bank.

    ``operands``: name → int32[n_bits, W] or int32[banks, n_bits, W];
    all operands must agree on bankedness.  Returns planes with a matching
    leading bank axis when the inputs were banked.  Inside a :func:`timed`
    scope, the call charges its modeled DRAM cost before dispatch (and, in
    replay mode, the FSM-replayed cost of the same trace).
    """
    return execute_lowered(prog, lower_program(prog), operands,
                           out_bits=out_bits, backend=backend)


def execute_lowered(prog: UProgram, trace: LoweredTrace, operands: dict,
                    out_bits=None, backend: str | None = None,
                    machine=None) -> dict:
    """Dispatch an already-lowered ``(μProgram, trace)`` pair to a backend.

    The seam per-machine μProgram Memories execute through: a
    :class:`~repro_torch.core.trace.TraceCache` hands back its cached pair and
    nothing re-lowers.  Semantics are identical to :func:`execute_program`
    (which is this plus the process-wide lowering memo).  ``machine``
    attributes the work for accumulator filtering: machine-owned PerfStats
    only charge for their own machine's executions.
    """
    fn = get_backend(backend)
    first = next(iter(operands.values()))
    banked = first.ndim == 3
    if banked and any(v.ndim != 3 for v in operands.values()):
        raise ValueError("banked execution needs every operand banked")
    banks = first.shape[0] if banked else 1
    eff = machine if machine is not None else _current_machine()
    with telemetry.span("machine.meter"):
        charging = _charging_stats(eff)
        for st in charging:
            offsets = None
            for planes in operands.values():
                if id(planes) in st._resident:
                    # direct reuse of a prior op's output planes stays inside
                    # the bank: an intra-bank LISA relocation per result row.
                    # Inter-bank PSM traffic is charged where it actually
                    # happens — BitplaneArray.rebank via the layout movement
                    # hooks (bank layouts cannot silently change between an
                    # op's output and a consumer's operand; rebank creates a
                    # new array).
                    st.charge_movement(int(planes.shape[-2]))
                skew = st.take_bank_skew(id(planes), banks, machine=eff)
                if skew is not None:
                    # this op consumes freshly scattered planes: its per-bank
                    # streams cannot start before each bank's data arrived
                    # (two scattered operands gate on the later arrival)
                    offsets = skew if offsets is None else tuple(
                        max(a, b) for a, b in zip(offsets, skew))
            st.charge_program(prog, banks, int(first.shape[-1]) * LANE_WORD,
                              trace=trace, offsets=offsets)
    if banked and not getattr(fn, "banked", False):
        # bank axis: one subarray per bank, for backends without a native
        # bank axis (the numpy oracle)
        per = [fn(trace, {k: v[i] for k, v in operands.items()},
                  out_bits=out_bits) for i in range(banks)]
        outs = {k: torch.stack([p[k] for p in per]) for k in per[0]}
    else:
        outs = fn(trace, operands, out_bits=out_bits)
    for st in charging:
        for arr in outs.values():
            st.note_output(arr)
    return outs


def execute_heterogeneous(items, machine=None) -> list:
    """Execute a heterogeneous batch of lowered programs — the execution
    half of bank-level scheduling (:class:`~repro_torch.simdram.scheduler
    .BankScheduler` models the timing half).

    ``items`` is a sequence of ``(prog, trace, operands, out_bits,
    backend)`` tuples with plane-level operands (``name →
    int32[n_bits, W]``, unbanked).  Returns one output dict per item, in
    order.  Adjacent items that share the same trace, backend, out_bits
    and operand layout are *stacked along the bank axis* and dispatched as
    one banked :func:`execute_lowered` call — a tenant's stream of
    identical requests collapses into a handful of banked executions
    instead of one dispatch per request, exactly the bank-parallel
    placement the scheduler models.  The modeled charge is the banked
    charge (latency once, energy × the stacked width); per-request timing
    comes from the scheduler, not from here.
    """
    items = list(items)
    results: list = [None] * len(items)

    def _sig(item):
        prog, trace, ops, ob, be = item
        if any(v.ndim != 2 for v in ops.values()):
            return None              # banked operands: dispatch solo
        shapes = tuple((k, tuple(ops[k].shape), str(ops[k].dtype))
                       for k in sorted(ops))
        frozen_ob = None if ob is None else tuple(sorted(ob.items()))
        return (id(trace), be, frozen_ob, shapes)

    i = 0
    while i < len(items):
        prog, trace, ops, ob, be = items[i]
        sig = _sig(items[i])
        j = i + 1
        while sig is not None and j < len(items) and _sig(items[j]) == sig:
            j += 1
        if j - i > 1:
            stacked = {k: torch.stack([items[x][2][k] for x in range(i, j)])
                       for k in ops}
            outs = execute_lowered(prog, trace, stacked, out_bits=ob,
                                   backend=be, machine=machine)
            for x in range(i, j):
                results[x] = {k: v[x - i] for k, v in outs.items()}
        else:
            results[i] = execute_lowered(prog, trace, ops, out_bits=ob,
                                         backend=be, machine=machine)
        i = j
    return results


# ---------------------------------------------------------------------------
# Built-in backends
# ---------------------------------------------------------------------------


def _kernel_execute(trace: LoweredTrace, operands: dict,
                    out_bits=None) -> dict:
    from ..kernels.ops import run_trace_kernel
    return run_trace_kernel(trace, operands, out_bits=out_bits)


_kernel_execute.banked = True


def _unrolled_execute(trace: LoweredTrace, operands: dict,
                      out_bits=None) -> dict:
    from .unrolled import run_trace_unrolled
    return run_trace_unrolled(trace, operands, out_bits=out_bits)


_unrolled_execute.banked = True


def _reference_execute(trace: LoweredTrace, operands: dict,
                       out_bits=None) -> dict:
    """Planes → horizontal numpy values → faithful Subarray run → planes.

    The trace is *decoded* back to μOps (:meth:`LoweredTrace.to_uprogram`)
    and executed on the stateful Subarray — exercising the IR's round-trip
    on every oracle run.  Conversions use the numpy layout twins (not the
    transposition-unit path) so reference execution never perturbs
    TRANSPOSE_STATS.
    """
    from ..core.executor import from_planes, run_program
    from ..simdram.layout import LANE_WORD, np_from_bitplanes, np_to_bitplanes

    prog = trace.to_uprogram()
    vals = {}
    lanes = None
    device = next(iter(operands.values())).device
    for name, planes in operands.items():
        p = planes.cpu().numpy().view(np.uint32)
        lanes = p.shape[1] * LANE_WORD
        vals[name] = np_from_bitplanes(p).astype(np.int64)
    # the Subarray packs 64 lanes per word — round the lane count up
    run_lanes = ((lanes + 63) // 64) * 64
    if run_lanes != lanes:
        vals = {k: np.pad(v, (0, run_lanes - lanes)) for k, v in vals.items()}
    outs, _ = run_program(prog, vals, lanes=run_lanes, out_bits=out_bits)
    out_bits = out_bits or {}
    result = {}
    for name, planes64 in outs.items():
        nb = out_bits.get(name, prog.n_bits)
        horizontal = from_planes(planes64, run_lanes)[:lanes]
        planes = np_to_bitplanes(horizontal.astype(np.uint64), nb)
        result[name] = torch.from_numpy(planes.view(np.int32)).to(device)
    return result


register_backend("kernel", _kernel_execute)
register_backend("unrolled", _unrolled_execute)
register_backend("reference", _reference_execute)
