"""Lowered command-trace IR — the single form every substrate executes.

The paper's control unit (Fig. 7) executes one thing: a linear stream of
AAP/AP command sequences.  :class:`LoweredTrace` is that stream as data —
an int32 command array plus the row-index map that binds symbolic row
references (D rows, C rows, B-group cells) to physical row numbers — and is
produced exactly once per compiled μProgram.  All registered backends
consume it: the ``reference`` oracle decodes it back to μOps, the
``kernel`` backend scans the command array directly, and the trace-replay timing
substrate (:mod:`repro_torch.simdram.timing`) replays it against per-bank DRAM
timing state machines.

Command encoding (int32[N, 4], shared with the CUDA FSM kernel in
:mod:`repro_torch.kernels.uprog_executor`)::

    (op, a, b, c)
    op = CMD_COPY (0): row|a| ← read(b)                               (AAP)
    op = CMD_MAJ  (1): rows |a|,|b|,|c| ← MAJ(read(a),read(b),read(c)) (AP)

Row operands are 1-based; a negative index reads/writes through a
dual-contact cell's n-wordline (complement).  The C0/C1 constant rows are
ordinary rows pre-filled with zeros/ones.

Because a multi-destination AAP lowers to several COPY commands and a
Case-2 fused AAP lowers to MAJ + COPY, the executable array alone cannot
reproduce command-sequence structure (which both the Table-5 accounting and
the DRAM timing FSM need: one AAP is one ACT-ACT-PRE regardless of how many
destination rows its pair address covers).  ``seqs`` therefore records, per
original command sequence, its kind and its span of command rows::

    seqs int32[M, 3] = (kind, start, end)       # cmds[start:end]
    kind = SEQ_AAP (0) | SEQ_AP (1) | SEQ_AAP_TRA (2, Case-2 fused)

The module also owns the process-wide **compile/lower cache**: the paper's
μProgram Memory holds the 16 compiled operations once, and
:func:`compile_trace` mirrors it — synthesis, row allocation and lowering
run once per ``(op, n_bits, optimize)`` and every later ``bbop_*`` call
(including chained pipelines and ``greedy_decode`` sampling) fetches the
finished trace.  Hit/miss counters are exposed for the benchmark gate.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
import time
import weakref

import numpy as np

from .. import telemetry
from .uprogram import (AAP, AP, C0, C1, CRow, DRow, N_B_CELLS, Port,
                       UProgram, normalize_uop)

# command opcodes (shared with the CUDA FSM kernel)
CMD_COPY, CMD_MAJ = 0, 1
# command-sequence kinds
SEQ_AAP, SEQ_AP, SEQ_AAP_TRA = 0, 1, 2

# per-ACT gap-kind codes (see :meth:`LoweredTrace.act_structure`) — the
# timing-independent skeleton the vectorized replay engine compiles each
# trace to.  Code k tells how the k-th activation follows its predecessor
# on the same bank: the stream's first ACT has no predecessor (START), the
# back-to-back second ACT of an AAP issues tRAS later (RAS), and the first
# ACT of every later sequence issues tRC after the previous sequence's
# final ACT (RC).  The replay engine maps codes to cycle counts for its
# own DRAMTiming, so one compiled structure serves every timing.
ACT_GAP_START, ACT_GAP_RAS, ACT_GAP_RC = 0, 1, 2


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def _encode_ref(ref, row_index: dict) -> int:
    if isinstance(ref, Port):
        base = row_index[("cell", ref.cell)]
        return -base if ref.neg else base
    if isinstance(ref, CRow):
        return row_index["C1"] if ref.one else row_index["C0"]
    if isinstance(ref, DRow):
        return row_index[(ref.array, ref.bit)]
    raise TypeError(ref)


def encode_uops(uops, row_index: dict) -> tuple[np.ndarray, np.ndarray]:
    """Flattened μOps → (cmds int32[N,4], seqs int32[M,3])."""
    def tra_ports(ports) -> tuple:
        # triple-row-activation addresses decode B-group μRegisters only
        # (paper §3.1) — a clear error here beats a KeyError mid-encode
        if not all(isinstance(p, Port) for p in ports):
            raise TypeError(f"TRA operands must be B-group ports, got "
                            f"{tuple(map(str, ports))}")
        return tuple(_encode_ref(p, row_index) for p in ports)

    cmds: list[tuple[int, int, int, int]] = []
    seqs: list[tuple[int, int, int]] = []
    for u in uops:
        start = len(cmds)
        if isinstance(u, AP):
            a, b, c = tra_ports(u.ports)
            cmds.append((CMD_MAJ, a, b, c))
            kind = SEQ_AP
        elif isinstance(u, AAP):
            if isinstance(u.src, tuple):
                a, b, c = tra_ports(u.src)
                cmds.append((CMD_MAJ, a, b, c))
                src = a
                kind = SEQ_AAP_TRA
            else:
                src = _encode_ref(u.src, row_index)
                kind = SEQ_AAP
            for d in u.dsts:
                cmds.append((CMD_COPY, _encode_ref(d, row_index), src, src))
        else:
            raise TypeError(u)
        seqs.append((kind, start, len(cmds)))
    return (np.asarray(cmds, np.int32).reshape(-1, 4),
            np.asarray(seqs, np.int32).reshape(-1, 3))


def _uop_drows(u) -> list[DRow]:
    rows = []
    if isinstance(u, AAP):
        if isinstance(u.src, DRow):
            rows.append(u.src)
        rows.extend(d for d in u.dsts if isinstance(d, DRow))
    return rows


# ---------------------------------------------------------------------------
# The IR
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChainStageInfo:
    """One fused stage's seam spans inside a chain trace:
    ``seqs[seq_start:seq_end]`` / ``cmds[cmd_start:cmd_end]`` are the
    command sequences this stage contributed after seam optimization, and
    ``value`` is the SSA value name the stage produces."""
    op: str
    value: str
    seq_start: int
    seq_end: int
    cmd_start: int
    cmd_end: int


@dataclasses.dataclass(frozen=True)
class ChainInfo:
    """Seam metadata on a fused cross-op trace (see
    :func:`repro_torch.core.compiler.compile_chain`): per-stage command-sequence
    spans so replay timing, TraceLint and per-op stall attribution still
    see op boundaries; the constituent ``ops`` (the cache-invalidation
    keys — redefining any of them must evict the fused entry); and the
    rows/sequences the cross-op allocator elided versus per-op lowering."""
    stages: tuple
    ops: tuple
    elided_rows: int = 0
    elided_seqs: int = 0

    @property
    def n_stages(self) -> int:
        return len(self.stages)


def _chain_info(meta, seqs) -> "ChainInfo | None":
    """μProgram chain metadata (flattened-μOp spans) → trace seam metadata.
    One flattened μOp encodes to exactly one ``seqs`` row (see
    :func:`encode_uops`), so μOp spans ARE sequence spans; command spans
    read off the seqs table."""
    if not meta:
        return None
    stages = []
    for op, value, s, e in meta["stages"]:
        if s < e:
            cs, ce = int(seqs[s, 1]), int(seqs[e - 1, 2])
        else:  # stage fully elided by seam optimization: empty span
            cs = ce = int(seqs[s - 1, 2]) if s > 0 else 0
        stages.append(ChainStageInfo(str(op), str(value), int(s), int(e),
                                     cs, ce))
    return ChainInfo(stages=tuple(stages), ops=tuple(meta["ops"]),
                     elided_rows=int(meta.get("elided_rows", 0)),
                     elided_seqs=int(meta.get("elided_seqs", 0)))


@dataclasses.dataclass
class LoweredTrace:
    """A μProgram lowered to the executable command-trace form.

    ``row_index`` maps row keys to 1-based physical row numbers:
    ``(array, bit)`` for D-group rows, ``("cell", c)`` for the six B-group
    compute cells, and ``"C0"``/``"C1"`` for the constant rows.  ``d_rows``
    lists the D-group keys in row order (operand loading).  Metadata
    (``inputs``/``outputs``/``scratch``) is carried over from the source
    μProgram so backends need nothing else.
    """

    name: str
    n_bits: int
    cmds: np.ndarray                       # int32[N, 4]
    seqs: np.ndarray                       # int32[M, 3] (kind, start, end)
    row_index: dict
    d_rows: tuple
    inputs: tuple = ()
    outputs: tuple = ()
    scratch: tuple = ()
    chain: object = None                   # ChainInfo for fused chain traces
    _decoded: object = dataclasses.field(default=None, repr=False)
    _lint: object = dataclasses.field(default=None, repr=False)
    _fingerprint: object = dataclasses.field(default=None, repr=False)
    _act_struct: object = dataclasses.field(default=None, repr=False)

    @property
    def n_rows(self) -> int:
        return len(self.row_index)

    @property
    def fingerprint(self) -> str:
        """Stable content hash of the trace (commands, seqs, row map and
        metadata) — identical traces share it across object identities, so
        it is the key for cost memos that must survive recompiles and can
        never alias the way a recycled ``id()`` can."""
        if self._fingerprint is None:
            h = hashlib.blake2b(digest_size=16)
            h.update(repr((self.name, self.n_bits, self.d_rows, self.inputs,
                           self.outputs, self.scratch, self.chain)).encode())
            h.update(np.ascontiguousarray(self.cmds, np.int32).tobytes())
            h.update(np.ascontiguousarray(self.seqs, np.int32).tobytes())
            self._fingerprint = h.hexdigest()
        return self._fingerprint

    def act_structure(self) -> np.ndarray:
        """The trace's per-ACT gap-kind codes (int8[n_acts]) — its compiled
        replay structure.

        Every command sequence issues a fixed activation pattern (AP: one
        TRA; AAP: source ACT then back-to-back destination ACT), so the
        whole trace flattens to one per-bank ACT stream whose inter-ACT
        gaps depend only on the sequence kinds: ``ACT_GAP_START`` /
        ``ACT_GAP_RAS`` / ``ACT_GAP_RC``.  The vectorized replay engine
        turns these codes into cycle vectors and solves the stall
        recurrences with prefix scans instead of stepping the FSM.
        Timing-independent, hence memoized here on the trace (one
        structure serves every DRAMTiming and bank count)."""
        if self._act_struct is None:
            kinds = self.seqs[:, 0]
            if kinds.size == 0:
                self._act_struct = np.zeros(0, np.int8)
                return self._act_struct
            acts_per_seq = np.where(kinds == SEQ_AP, 1, 2)
            starts = np.concatenate(([0], np.cumsum(acts_per_seq)[:-1]))
            codes = np.full(int(acts_per_seq.sum()), ACT_GAP_RAS, np.int8)
            codes[starts] = ACT_GAP_RC
            codes[0] = ACT_GAP_START
            self._act_struct = codes
        return self._act_struct

    def lint(self, max_diagnostics: int = 100):
        """Statically verify this trace (see :mod:`repro_torch.core.tracelint`);
        the :class:`~repro_torch.core.tracelint.LintReport` is memoized on the
        trace, so cached compiles pay for verification exactly once."""
        if self._lint is None:
            from .tracelint import lint_trace
            self._lint = lint_trace(self, max_diagnostics)
        return self._lint

    @property
    def n_commands(self) -> int:
        """Command *sequences* (the paper's Table-5 metric), not cmd rows."""
        return int(self.seqs.shape[0])

    def command_mix(self) -> dict:
        """(n_AAP, n_AP, n_TRA) — identical to ``UProgram.command_mix``."""
        kinds = self.seqs[:, 0]
        n_ap = int((kinds == SEQ_AP).sum())
        n_fused = int((kinds == SEQ_AAP_TRA).sum())
        n_aap = int((kinds == SEQ_AAP).sum()) + n_fused
        return {"AAP": n_aap, "AP": n_ap, "TRA": n_ap + n_fused}

    def out_row_ids(self, name: str, n_bits: int) -> list[int]:
        """0-based row indices holding bits 0..n_bits-1 of output ``name``
        (missing bits resolve to the all-zeros C0 row)."""
        c0 = self.row_index["C0"]
        return [self.row_index.get((name, i), c0) - 1 for i in range(n_bits)]

    # -- decoding ------------------------------------------------------------
    def decode(self) -> list:
        """Reconstruct the (normalized) μOp sequence this trace was lowered
        from — the inverse of :func:`lower_program` up to
        :func:`~repro_torch.core.uprogram.normalize_uop` (the ``fixed``
        loop-invariance mark on D rows names the same physical row and is
        consumed by flattening, so it does not survive lowering)."""
        inv = {idx: key for key, idx in self.row_index.items()}

        def ref(code: int):
            key = inv[abs(int(code))]
            if key == "C0":
                return C0
            if key == "C1":
                return C1
            if isinstance(key, tuple) and key[0] == "cell":
                return Port(key[1], neg=code < 0)
            return DRow(key[0], key[1])

        uops: list = []
        for kind, start, end in self.seqs.tolist():
            if kind == SEQ_AP:
                uops.append(AP(tuple(ref(c) for c in self.cmds[start, 1:4])))
            elif kind == SEQ_AAP_TRA:
                src = tuple(ref(c) for c in self.cmds[start, 1:4])
                dsts = tuple(ref(self.cmds[i, 1])
                             for i in range(start + 1, end))
                uops.append(AAP(src, dsts))
            else:
                src = ref(self.cmds[start, 2])
                dsts = tuple(ref(self.cmds[i, 1]) for i in range(start, end))
                uops.append(AAP(src, dsts))
        return uops

    def to_uprogram(self) -> UProgram:
        """Decoded μOps re-wrapped as a flat μProgram (what the ``reference``
        backend feeds the faithful ``Subarray`` executor); memoized, since
        banked oracle runs decode once per bank otherwise."""
        if self._decoded is None:
            self._decoded = UProgram(
                name=self.name, n_bits=self.n_bits, prologue=self.decode(),
                body=[], epilogue=[], body_reps=0, inputs=self.inputs,
                outputs=self.outputs, scratch=self.scratch)
        return self._decoded


# ---------------------------------------------------------------------------
# Lowering (memoized per program object)
# ---------------------------------------------------------------------------

# id(prog) → (prog, trace); strong refs keep ids stable, LRU-bounded (a
# hit refreshes recency) so ad-hoc programs (tests, experiments) cannot
# grow it without bound and a sustained mixed workload cannot evict its
# hottest program first.  Guarded by a lock: per-machine compile caches
# share this memo, so concurrent sessions race on it otherwise.
_LOWER_MEMO: dict[int, tuple[UProgram, "LoweredTrace"]] = {}
_LOWER_MEMO_CAP = 256
_LOWER_LOCK = threading.Lock()


def lower_program(prog: UProgram) -> LoweredTrace:
    """Lower a compiled μProgram to its command trace (once per object)."""
    with _LOWER_LOCK:
        hit = _LOWER_MEMO.get(id(prog))
        if hit is not None:
            # LRU move-to-end: eviction order is recency, not insertion —
            # FIFO evicted the hottest program first under mixed workloads
            _LOWER_MEMO[id(prog)] = _LOWER_MEMO.pop(id(prog))
            return hit[1]
    flat = prog.flatten()
    drows = sorted({(r.array, r.bit) for u in flat for r in _uop_drows(u)})
    if any(arr == "cell" for arr, _ in drows):
        raise ValueError('operand array name "cell" collides with the '
                         "B-group row keys")
    row_index: dict = {}
    for key in drows:
        row_index[key] = len(row_index) + 1
    row_index["C0"] = len(row_index) + 1
    row_index["C1"] = len(row_index) + 1
    for cell in range(N_B_CELLS):
        row_index[("cell", cell)] = len(row_index) + 1
    cmds, seqs = encode_uops(flat, row_index)
    trace = LoweredTrace(name=prog.name, n_bits=prog.n_bits, cmds=cmds,
                         seqs=seqs, row_index=row_index,
                         d_rows=tuple(drows), inputs=tuple(prog.inputs),
                         outputs=tuple(prog.outputs),
                         scratch=tuple(prog.scratch),
                         chain=_chain_info(getattr(prog, "chain", None),
                                           seqs))
    with _LOWER_LOCK:
        # re-check: another thread may have lowered the same program while
        # we computed — keep the first trace so every caller sees one object
        prior = _LOWER_MEMO.get(id(prog))
        if prior is not None:
            return prior[1]
        _LOWER_MEMO[id(prog)] = (prog, trace)
        while len(_LOWER_MEMO) > _LOWER_MEMO_CAP:
            del _LOWER_MEMO[next(iter(_LOWER_MEMO))]
    return trace


def canonical_uops(prog: UProgram) -> list:
    """``prog.flatten()`` in the normal form lowering preserves (see
    :meth:`LoweredTrace.decode`)."""
    return [normalize_uop(u) for u in prog.flatten()]


# ---------------------------------------------------------------------------
# The μProgram Memory: an instantiable compile/lower cache
# ---------------------------------------------------------------------------


def _count_compile(t0: int) -> None:
    """One μProgram Memory miss resolved (compile, lower, lint) since
    ``t0`` (ns): the ``memory.compile_ns`` counter (the misses themselves
    are each cache's own counters)."""
    telemetry.count("memory.compile_ns", time.perf_counter_ns() - t0)


class TraceCache:
    """A μProgram Memory: compile + lower once per ``(op, n_bits, optimize)``.

    The paper's control unit keeps the finished μPrograms in a small
    scratchpad (Fig. 7); this class mirrors it as a bounded LRU cache over
    ``(UProgram, LoweredTrace)`` pairs with hit/miss/eviction counters.
    One process-wide instance backs :func:`compile_trace` (and the default
    :class:`~repro_torch.simdram.machine.SimdramMachine`); every other machine
    owns a private instance, so concurrent sessions never share compiles
    or counters.

    ``compile_fn(name, n_bits, optimize) → UProgram`` resolves a miss —
    ``None`` means the process-wide op registry
    (:func:`repro_torch.core.circuits.compile_operation`).  ``capacity=None``
    is unbounded.  ``verify=True`` (default) statically verifies every
    freshly lowered trace (:mod:`repro_torch.core.tracelint`) before it enters
    the cache: a trace with lint errors raises
    :class:`~repro_torch.core.tracelint.TraceLintError` and is never cached, and
    because the report is memoized on the trace the cached hot path never
    pays for verification again.  All access is lock-guarded: hammering one cache from
    many threads keeps counters exact and never compiles a key twice.
    (The lock is deliberately held across the compile itself, so a cold
    miss serializes other misses on the same cache — the workloads this
    models compile a handful of keys once and then only hit; exactly-once
    compiles and exact counters are worth more here than cold-path
    concurrency.)
    """

    def __init__(self, capacity: int | None = None, compile_fn=None,
                 verify: bool = True,
                 replay_capacity: int | None = 512,
                 schedule_capacity: int | None = 256) -> None:
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1 or None, got {capacity}")
        if replay_capacity is not None and replay_capacity < 1:
            raise ValueError(f"replay_capacity must be >= 1 or None, "
                             f"got {replay_capacity}")
        if schedule_capacity is not None and schedule_capacity < 1:
            raise ValueError(f"schedule_capacity must be >= 1 or None, "
                             f"got {schedule_capacity}")
        self.capacity = capacity
        self.verify = verify
        self._compile_fn = compile_fn
        self._entries: collections.OrderedDict[
            tuple, tuple[UProgram, LoweredTrace]] = collections.OrderedDict()
        # closed-form ReplayResult memo (the μProgram Memory's second
        # table): keyed by (trace.fingerprint, banks, offsets signature,
        # refresh-phase bucket, policy/engine, timing signature) — content
        # hashes, so entries never go stale across recompiles and need no
        # invalidate() hook.  LRU-bounded separately from the compile
        # entries: replay keys fan out per (banks, offsets, phase) and
        # must not evict compiled programs.
        self._replays: collections.OrderedDict[tuple, object] = \
            collections.OrderedDict()
        self.replay_capacity = replay_capacity
        # whole-schedule memo (the μProgram Memory's third table): a
        # BankScheduler busy period is fully determined by its request set
        # — (trace fingerprint, bank placement, stream arrival cycles) per
        # request — plus the controller policies, bank count, refresh
        # phase and timing signature.  A decode server re-issuing the same
        # batch shape every step gets the whole stepped event loop back as
        # a table lookup.  Content-keyed like the replay memo, so entries
        # never go stale across recompiles.
        self._schedules: collections.OrderedDict[tuple, object] = \
            collections.OrderedDict()
        self.schedule_capacity = schedule_capacity
        self._lock = threading.RLock()
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._replay_hits = 0
        self._replay_misses = 0
        self._schedule_hits = 0
        self._schedule_misses = 0
        _ALL_CACHES.add(self)

    def _compile(self, name: str, n_bits: int, optimize: bool) -> UProgram:
        if self._compile_fn is not None:
            return self._compile_fn(name, n_bits, optimize)
        from .circuits import compile_operation
        return compile_operation(name, n_bits, optimize=optimize)

    def get(self, name: str, n_bits: int, optimize: bool = True,
            verify: bool | None = None) -> tuple[UProgram, LoweredTrace]:
        """Fetch-or-compile the ``(UProgram, LoweredTrace)`` pair.

        ``verify=None`` uses the cache's default (see the class docstring);
        a trace that fails verification raises
        :class:`~repro_torch.core.tracelint.TraceLintError` and never enters the
        cache."""
        key = (name, int(n_bits), bool(optimize))
        # the whole miss path holds the lock: compiling outside it would
        # let two threads synthesize the same key concurrently and tear
        # the hit/miss counters
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._hits += 1
                self._entries.move_to_end(key)
                if self.verify if verify is None else verify:
                    # memoized on the trace — a no-op unless the entry was
                    # inserted with verify=False and has errors
                    hit[1].lint().raise_for_errors()
                return hit
            self._misses += 1
            t0 = time.perf_counter_ns()
            prog = self._compile(name, n_bits, bool(optimize))
            trace = lower_program(prog)
            if self.verify if verify is None else verify:
                trace.lint().raise_for_errors()
            _count_compile(t0)
            entry = (prog, trace)
            self._entries[key] = entry
            while self.capacity is not None and \
                    len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self._evictions += 1
            return entry

    def get_chain(self, stages, n_bits: int, optimize: bool = True,
                  verify: bool | None = None, outputs=None,
                  name: str | None = None
                  ) -> tuple[UProgram, LoweredTrace]:
        """Fetch-or-compile a fused cross-op chain (see
        :func:`repro_torch.core.compiler.compile_chain`).

        Keyed by the chain *signature* — the constituent op names plus the
        full value wiring — rather than the display name, and the lowered
        trace records its constituent ops in ``trace.chain.ops``, so
        :meth:`invalidate` on ANY constituent op evicts the fused entry.
        The per-stage compiles resolve through this cache's own compile
        function, so machine-local op definitions fuse correctly."""
        from .compiler import chain_signature, compile_chain
        key = (chain_signature(stages, outputs), int(n_bits), bool(optimize))
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._hits += 1
                self._entries.move_to_end(key)
                if self.verify if verify is None else verify:
                    hit[1].lint().raise_for_errors()
                return hit
            self._misses += 1
            t0 = time.perf_counter_ns()
            prog = compile_chain(stages, n_bits, optimize=bool(optimize),
                                 compile_fn=self._compile, outputs=outputs,
                                 name=name)
            trace = lower_program(prog)
            if self.verify if verify is None else verify:
                trace.lint().raise_for_errors()
            _count_compile(t0)
            entry = (prog, trace)
            self._entries[key] = entry
            while self.capacity is not None and \
                    len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self._evictions += 1
            return entry

    def replay_get(self, key: tuple):
        """Fetch a memoized closed-form ReplayResult (None on miss)."""
        with self._lock:
            hit = self._replays.get(key)
            if hit is None:
                self._replay_misses += 1
                return None
            self._replay_hits += 1
            self._replays.move_to_end(key)
            return hit

    def replay_put(self, key: tuple, result) -> None:
        """Memoize one replay outcome under its full stall-structure key."""
        with self._lock:
            self._replays[key] = result
            self._replays.move_to_end(key)
            while self.replay_capacity is not None and \
                    len(self._replays) > self.replay_capacity:
                self._replays.popitem(last=False)

    def schedule_get(self, key: tuple):
        """Fetch a memoized whole-schedule outcome (None on miss)."""
        with self._lock:
            hit = self._schedules.get(key)
            if hit is None:
                self._schedule_misses += 1
                return None
            self._schedule_hits += 1
            self._schedules.move_to_end(key)
            return hit

    def schedule_put(self, key: tuple, result) -> None:
        """Memoize one scheduler busy period under its full request-set
        key (see :meth:`BankScheduler.run`'s memo hook)."""
        with self._lock:
            self._schedules[key] = result
            self._schedules.move_to_end(key)
            while self.schedule_capacity is not None and \
                    len(self._schedules) > self.schedule_capacity:
                self._schedules.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: tuple) -> bool:
        with self._lock:
            return key in self._entries

    def stats(self) -> dict:
        """{hits, misses, entries, hit_rate, capacity, evictions} plus the
        replay-memo counters (replay_hits, replay_misses, replay_entries)
        and the schedule-memo counters (schedule_hits, schedule_misses,
        schedule_entries)."""
        with self._lock:
            h, m = self._hits, self._misses
            return {"hits": h, "misses": m, "entries": len(self._entries),
                    "hit_rate": h / (h + m) if h + m else 0.0,
                    "capacity": self.capacity, "evictions": self._evictions,
                    "replay_hits": self._replay_hits,
                    "replay_misses": self._replay_misses,
                    "replay_entries": len(self._replays),
                    "schedule_hits": self._schedule_hits,
                    "schedule_misses": self._schedule_misses,
                    "schedule_entries": len(self._schedules)}

    def invalidate(self, name: str) -> int:
        """Drop every cached width/optimize variant of one operation —
        called when an op is (re)registered or unregistered so a stale
        compile can never execute under the new definition.  Fused chain
        entries are evicted when *any* constituent op (``trace.chain.ops``)
        is invalidated, not only on a key match — a chain compiled against
        the old definition is exactly as stale as the op itself.  Returns
        the number of entries dropped."""
        with self._lock:
            victims = []
            for k, (_prog, trace) in self._entries.items():
                chain = getattr(trace, "chain", None)
                if k[0] == name or (chain is not None and name in chain.ops):
                    victims.append(k)
            for k in victims:
                del self._entries[k]
            return len(victims)

    def reset_stats(self) -> None:
        with self._lock:
            self._hits = self._misses = self._evictions = 0
            self._replay_hits = self._replay_misses = 0
            self._schedule_hits = self._schedule_misses = 0

    def clear(self) -> None:
        """Drop entries and counters (in place — aliases stay valid)."""
        with self._lock:
            self._entries.clear()
            self._replays.clear()
            self._schedules.clear()
            self.reset_stats()


# every live TraceCache (weak refs: caches die with their machines) — a
# process-wide op (re)registration must be able to evict stale compiles
# from ALL of them, not just the global cache, because private machine
# memories fall back to the process registry for names they don't define
_ALL_CACHES: "weakref.WeakSet[TraceCache]" = weakref.WeakSet()


def invalidate_everywhere(name: str) -> None:
    """Drop every cached compile of ``name`` from every live TraceCache
    (called by the op registry on re-registration/unregistration)."""
    for cache in list(_ALL_CACHES):
        cache.invalidate(name)


# ---------------------------------------------------------------------------
# Process-wide compile/lower cache (the default machine's μProgram Memory)
# ---------------------------------------------------------------------------

GLOBAL_TRACE_CACHE = TraceCache()
# legacy alias (tests/benchmarks introspect the raw mapping)
_COMPILE_CACHE = GLOBAL_TRACE_CACHE._entries


def compile_trace(name: str, n_bits: int, optimize: bool = True,
                  verify: bool | None = None
                  ) -> tuple[UProgram, LoweredTrace]:
    """Compile + lower an operation once per ``(op, n_bits, optimize)``.

    Returns the cached ``(UProgram, LoweredTrace)`` pair from the
    process-wide :data:`GLOBAL_TRACE_CACHE`; synthesis, row allocation and
    lowering never re-run for a cached key.  Fresh traces are statically
    verified by default (``verify=``, see :mod:`repro_torch.core.tracelint`);
    the memoized report makes this free on every later fetch.
    """
    return GLOBAL_TRACE_CACHE.get(name, n_bits, optimize, verify=verify)


def compile_chain_trace(stages, n_bits: int, optimize: bool = True,
                        verify: bool | None = None, outputs=None,
                        name: str | None = None
                        ) -> tuple[UProgram, LoweredTrace]:
    """Fuse + lower a cross-op chain once per (signature, n_bits, optimize)
    via the process-wide cache (see :meth:`TraceCache.get_chain`)."""
    return GLOBAL_TRACE_CACHE.get_chain(stages, n_bits, optimize,
                                        verify=verify, outputs=outputs,
                                        name=name)


def trace_cache_stats() -> dict:
    """{hits, misses, entries, hit_rate, ...} of the process-wide cache."""
    return GLOBAL_TRACE_CACHE.stats()


def reset_trace_cache_stats() -> None:
    GLOBAL_TRACE_CACHE.reset_stats()


def clear_trace_cache() -> None:
    """Drop every cached compile (and the counters) — benchmarks use this to
    measure a cold compile path.  The lowering memo is dropped too: a
    "cold compile" that still fetched memoized lowerings measured only cold
    synthesis, not the genuinely cold compile-and-lower path."""
    GLOBAL_TRACE_CACHE.clear()
    with _LOWER_LOCK:
        _LOWER_MEMO.clear()
