"""Multi-tenant bank-level scheduler: per-bank μProgram queues under the
rank-coupled FSM array (ROADMAP item 1 — the "heavy traffic" unlock).

The SIMDRAM control unit lives *inside the memory controller*, yet the
trace-replay substrate (:class:`~repro_torch.simdram.timing.TraceReplayTiming`)
still broadcasts ONE lowered trace to every engaged bank.  A controller
serving real traffic instead packs *independent* requests across banks —
bank-level parallelism — and arbitrates their activations under the shared
rank state: the tRRD ACT→ACT gap, the sliding four-activate tFAW window,
and the periodic tREFI/tRFC all-bank refresh.  :class:`BankScheduler` is
that controller model, the same task-queue-plus-state-machine shape as a
conventional DRAM controller front end:

* **per-bank μProgram queues** — :meth:`enqueue` places a request's lowered
  trace on one or more bank queues (explicit ``bank_ids`` or least-loaded
  assignment); queues hold *heterogeneous* traces, one FIFO per bank.
* **FR-FCFS-style issue** — :meth:`run` replays every queue on the per-bank
  ACT/PRE FSMs, coupled by one :class:`~repro_torch.simdram.timing._RankState`.
  Each arbitration round picks the *first-ready* activation (the bank FSM
  whose next ACT is locally legal earliest — an in-flight AAP's second ACT
  is ready after tRAS while a fresh sequence waits out tRC, so row-hit-
  first falls out of the FSM timing); ties break oldest-request-first,
  then lowest bank.  Issuing globally-earliest-first keeps the shared
  rank bookkeeping (the 4-deep tFAW activation window) in time order.
* **refresh-aware scheduling** — an Ambit-style charge-sharing sequence
  cannot survive an all-bank refresh (every row is precharged mid-flight),
  so the default policy pauses *between* command sequences: before a
  sequence's first ACT the scheduler checks its full busy span against the
  refresh-window grid (:meth:`_RankState.clear_of_refresh`) and holds
  issue until the sequence fits.  Two alternatives quantify the choice:
  ``"stall"`` issues eagerly and *aborts + restarts* a sequence whose
  mid-sequence ACT lands in a window (the wasted activation still consumed
  rank ACT slots), and ``"defer"`` reproduces the replay substrate's
  optimistic mid-sequence deferral exactly — the property-tested
  equivalence anchor (single tenant × identical traces on all banks under
  ``"defer"`` equals :meth:`TraceReplayTiming.replay` cycle-for-cycle,
  whichever ``replay_engine`` the timing selects: the engines are
  cycle-identical, so the anchor is engine-independent).

The event loop always *steps*: an interleaved multi-trace schedule has no
per-trace closed form to memoize, unlike the single-trace replays the
vectorized engine (``DRAMTiming(replay_engine="vectorized")``) compiles
and the :class:`~repro_torch.core.trace.TraceCache` replay memo serves warm.
What CAN be memoized is the whole busy period: a run's outcome is fully
determined by its request set — per request the trace fingerprint, bank
placement and stream arrival cycles — plus the controller policies, bank
count, refresh phase and timing signature.  Pass ``memo=`` (a
:class:`~repro_torch.core.trace.TraceCache`) and :meth:`run` serves a repeated
busy period as a table lookup (re-labeled with the new requests' names /
tenants / lanes), so a decode server re-issuing the same batch shape
every step does not re-step the Python event loop per step.

The scheduler is a pure timing model: it consumes lowered traces and
produces a :class:`ScheduleResult` (makespan, per-request
:class:`RequestTiming`, per-tenant rollups, stall attribution).  Execution
of the corresponding μPrograms is a separate concern —
:meth:`~repro_torch.simdram.machine.SimdramMachine.submit` /
:meth:`~repro_torch.simdram.machine.SimdramMachine.drain` pair this model with
:func:`~repro_torch.core.backends.execute_heterogeneous` and per-tenant
:class:`~repro_torch.core.backends.PerfStats` attribution.
"""
from __future__ import annotations

import dataclasses
import math

from ..core.trace import SEQ_AP
from .timing import DRAMTiming, ReplayResult, TraceReplayTiming

_REFRESH_POLICIES = ("aware", "stall", "defer")
_ISSUE_POLICIES = ("frfcfs",)


@dataclasses.dataclass(frozen=True)
class RequestTiming:
    """Modeled timing of one scheduled request (one enqueued trace).

    ``start_ns`` is the request's first activation, ``finish_ns`` the
    completion of its last stream's final precharge; ``queue_ns`` /
    ``service_ns`` split the end-to-end latency at that first ACT.  Stall
    fields attribute the request's share of the rank-level mechanisms:
    the four-activate window (``tfaw_stall_ns``), refresh deferrals /
    aware pauses (``refresh_stall_ns``), and — under the ``"stall"``
    refresh policy — sequences aborted by a mid-sequence refresh and
    re-issued from scratch (``n_restarts``; the wasted activations are
    included in ``n_acts``)."""
    index: int
    name: str
    tenant: str
    bank_ids: tuple[int, ...]
    arrival_ns: float
    start_ns: float
    finish_ns: float
    analytic_ns: float
    tfaw_stall_ns: float = 0.0
    refresh_stall_ns: float = 0.0
    n_refresh_stalls: int = 0
    n_restarts: int = 0
    n_acts: int = 0
    n_seqs: int = 0
    lanes: int = 0
    stream_finish_ns: tuple[float, ...] = ()
    # (op, n_seqs) per constituent stage when the request's trace is a
    # fused chain — one FR-FCFS unit, but per-op attribution survives
    fused_stages: tuple[tuple[str, int], ...] = ()

    @property
    def queue_ns(self) -> float:
        """Time spent waiting for the first activation."""
        return self.start_ns - self.arrival_ns

    @property
    def service_ns(self) -> float:
        """First activation → final precharge complete."""
        return self.finish_ns - self.start_ns

    def stage_split(self) -> dict[str, float]:
        """Service time attributed per constituent op.

        A fused chain scheduled as one request still reports per-op
        timing: ``service_ns`` split proportionally by each stage's share
        of command sequences (the replay-gap structure makes sequence
        count the first-order cost driver).  Unfused requests map their
        whole service time to their own name."""
        if not self.fused_stages:
            return {self.name: self.service_ns}
        total = max(1, sum(n for _, n in self.fused_stages))
        out: dict[str, float] = {}
        for op, n in self.fused_stages:
            out[op] = out.get(op, 0.0) + self.service_ns * n / total
        return out

    def replay_result(self) -> ReplayResult:
        """This request's timing as a :class:`ReplayResult` — the same
        shape a standalone :meth:`TraceReplayTiming.replay` of its trace
        would return, so futures expose scheduled timing through the
        familiar replay surface."""
        rel = [f - self.start_ns for f in self.stream_finish_ns] or [0.0]
        return ReplayResult(
            ns=self.service_ns,
            stall_ns=max(0.0, self.service_ns - self.analytic_ns),
            cycles=0, n_seqs=self.n_seqs, n_acts=self.n_acts,
            banks=len(self.bank_ids),
            max_bank_ns=max(rel), min_bank_ns=min(rel),
            tfaw_stall_ns=self.tfaw_stall_ns,
            refresh_stall_ns=self.refresh_stall_ns,
            n_refresh_stalls=self.n_refresh_stalls)


@dataclasses.dataclass(frozen=True)
class ScheduleResult:
    """Outcome of one :meth:`BankScheduler.run` event loop.

    ``ns`` is the makespan (last request finish); ``requests`` holds one
    :class:`RequestTiming` per enqueued request, in submission order.
    Rank-level stall attribution mirrors :class:`ReplayResult`; restarts
    count sequences aborted by mid-sequence refresh under the ``"stall"``
    policy."""
    ns: float
    cycles: int
    n_requests: int
    n_acts: int
    tfaw_stall_ns: float
    refresh_stall_ns: float
    n_refresh_stalls: int
    n_restarts: int
    requests: tuple[RequestTiming, ...]
    bank_finish_ns: tuple[float, ...]

    def per_tenant(self) -> dict[str, dict]:
        """Per-tenant rollup: request count, summed queue/service time,
        latest finish, and stall attribution."""
        out: dict[str, dict] = {}
        for r in self.requests:
            d = out.setdefault(r.tenant, {
                "n_requests": 0, "queue_ns": 0.0, "service_ns": 0.0,
                "finish_ns": 0.0, "tfaw_stall_ns": 0.0,
                "refresh_stall_ns": 0.0, "n_restarts": 0, "lanes": 0})
            d["n_requests"] += 1
            d["queue_ns"] += r.queue_ns
            d["service_ns"] += r.service_ns
            d["finish_ns"] = max(d["finish_ns"], r.finish_ns)
            d["tfaw_stall_ns"] += r.tfaw_stall_ns
            d["refresh_stall_ns"] += r.refresh_stall_ns
            d["n_restarts"] += r.n_restarts
            d["lanes"] += r.lanes
        return out


class _Stream:
    """One request's command stream on one bank (the queue entry)."""

    __slots__ = ("rid", "order", "arrival", "seq_i", "phase")

    def __init__(self, rid: int, order: int, arrival: int) -> None:
        self.rid = rid
        self.order = order          # FCFS rank (submission order)
        self.arrival = arrival      # earliest issue cycle on this bank
        self.seq_i = 0
        self.phase = 0              # 1 = second ACT of an AAP pending


class _Request:
    """Shared bookkeeping for one enqueued request across its streams."""

    __slots__ = ("name", "tenant", "kinds", "analytic", "lanes", "bank_ids",
                 "arrival", "first_act", "finishes", "streams_left",
                 "tfaw", "refresh", "n_ref", "restarts", "acts", "fused",
                 "arrivals", "fingerprint")

    def __init__(self, name, tenant, kinds, analytic, lanes, bank_ids,
                 arrival, fused=()) -> None:
        self.name = name
        self.tenant = tenant
        self.kinds = kinds
        self.analytic = analytic
        self.lanes = lanes
        self.bank_ids = bank_ids
        self.arrival = arrival          # min over streams, cycles
        self.first_act: int | None = None
        self.finishes: list[int] = []
        self.streams_left = len(bank_ids)
        self.tfaw = 0
        self.refresh = 0
        self.n_ref = 0
        self.restarts = 0
        self.acts = 0
        self.fused = fused
        self.arrivals: tuple[int, ...] = ()   # per-stream issue cycles
        self.fingerprint = None               # trace content hash (memo key)


class BankScheduler:
    """Bank-level request scheduler over the per-bank ACT/PRE FSM array
    (see the module docstring for the model).

    Parameters
    ----------
    timing : DRAM substrate (DDR4-2400 default); cycle constants and the
        shared rank state come from a :class:`TraceReplayTiming` built on
        it.
    n_banks : banks served by this controller (default: the timing's
        ``banks_per_chip``).
    policy : ``"frfcfs"`` (first-ready, oldest-first ties) — the only
        issue policy; the parameter names the knob for future variants.
    refresh_policy : ``"aware"`` (pause between sequences — default),
        ``"stall"`` (eager issue, mid-sequence refresh aborts + restarts
        the sequence), or ``"defer"`` (optimistic mid-sequence deferral,
        the replay substrate's exact semantics).
    refresh_phase_ns : anchor the refresh-window grid this long after the
        previous refresh epoch (same convention as
        :meth:`TraceReplayTiming.replay`).
    verify : statically verify every enqueued trace
        (:mod:`repro_torch.core.tracelint` — memoized per trace, so cached
        compiles cost nothing here) and run the cross-trace packing pass:
        two co-scheduled requests from *different tenants* sharing a bank
        with overlapping D-row footprints are flagged as ``bank-overlap``
        warnings on :attr:`lint_diagnostics` (an append-only log across
        busy periods; per-period pairing state resets with :meth:`run`).
        A trace with lint *errors* is rejected at ``enqueue`` with
        :class:`~repro_torch.core.tracelint.TraceLintError`.
    memo : optional :class:`~repro_torch.core.trace.TraceCache` whose schedule
        memo serves repeated busy periods without re-stepping the event
        loop (see the module docstring).  Content-keyed, so a hit is
        cycle-exact; request names/tenants/lanes are re-labeled from the
        live request set.
    """

    def __init__(self, timing: DRAMTiming | None = None,
                 n_banks: int | None = None, policy: str = "frfcfs",
                 refresh_policy: str = "aware",
                 refresh_phase_ns: float = 0.0,
                 verify: bool = True, memo=None) -> None:
        if policy not in _ISSUE_POLICIES:
            raise ValueError(f"unknown issue policy {policy!r} "
                             f"(expected one of {_ISSUE_POLICIES})")
        if refresh_policy not in _REFRESH_POLICIES:
            raise ValueError(f"unknown refresh policy {refresh_policy!r} "
                             f"(expected one of {_REFRESH_POLICIES})")
        self._rt = TraceReplayTiming(timing)
        self.timing = self._rt.timing
        self.n_banks = int(n_banks) if n_banks is not None \
            else self.timing.banks_per_chip
        if self.n_banks < 1:
            raise ValueError(f"n_banks must be >= 1, got {self.n_banks}")
        self.policy = policy
        self.refresh_policy = refresh_policy
        self.refresh_phase_ns = refresh_phase_ns
        self._queues: list[list[_Stream]] = [[] for _ in range(self.n_banks)]
        self._load = [0] * self.n_banks      # enqueued ACT-cycles per bank
        self._requests: list[_Request] = []
        self.verify = verify
        self.memo = memo
        # (name, tenant, D-row footprint, bank set) per request this busy
        # period — the cross-trace bank-overlap lint pairs against these
        self._lint_entries: list[tuple[str, str, frozenset, set]] = []
        self.lint_diagnostics: list = []

    def __repr__(self) -> str:
        pending = sum(len(q) for q in self._queues)
        return (f"BankScheduler(n_banks={self.n_banks}, "
                f"policy={self.policy!r}, "
                f"refresh_policy={self.refresh_policy!r}, "
                f"queued_streams={pending})")

    # -- queueing ------------------------------------------------------------
    def enqueue(self, trace, banks: int = 1, tenant: str = "default",
                name: str = "?", arrival_ns: float = 0.0,
                offsets_ns=None, lanes: int = 0,
                bank_ids=None) -> int:
        """Queue one lowered ``trace`` as a request ``banks`` banks wide;
        returns the request index (key into the eventual
        :attr:`ScheduleResult.requests`).

        The request's identical command stream is queued on ``banks``
        distinct banks — explicit ``bank_ids``, or the least-loaded banks
        by enqueued activation cycles.  ``offsets_ns`` optionally skews
        each stream's earliest start (e.g. scatter data-arrival skew) on
        top of ``arrival_ns``; ``lanes`` is carried through to the result
        for throughput accounting."""
        banks = max(1, int(banks))
        if banks > self.n_banks:
            raise ValueError(f"request is {banks} banks wide but the "
                             f"scheduler serves {self.n_banks}")
        if bank_ids is not None:
            bank_ids = tuple(int(b) for b in bank_ids)
            if len(bank_ids) != banks:
                raise ValueError(f"{len(bank_ids)} bank_ids for a "
                                 f"{banks}-bank request")
            if not all(0 <= b < self.n_banks for b in bank_ids):
                raise ValueError(f"bank_ids {bank_ids} out of range for "
                                 f"{self.n_banks} banks")
        else:
            by_load = sorted(range(self.n_banks),
                             key=lambda k: (self._load[k], k))
            bank_ids = tuple(sorted(by_load[:banks]))
        if offsets_ns is not None and len(offsets_ns) != banks:
            raise ValueError(f"{len(offsets_ns)} issue offsets for "
                             f"{banks} banks")
        if self.verify:
            from ..core.tracelint import lint_packing, row_footprint
            # per-trace lint is memoized on the trace — a compiled trace
            # was already verified at compile time and costs nothing here
            trace.lint().raise_for_errors()
            entry = (name, tenant, row_footprint(trace), set(bank_ids))
            for prior in self._lint_entries:
                self.lint_diagnostics.extend(lint_packing([prior, entry]))
            self._lint_entries.append(entry)
        tck = self.timing.tCK_ns
        kinds = trace.seqs[:, 0].tolist()
        mix = trace.command_mix()
        analytic = (mix["AAP"] * self.timing.t_aap_ns
                    + mix["AP"] * self.timing.t_ap_ns)
        rid = len(self._requests)
        order = rid
        base = max(0, math.ceil(arrival_ns / tck))
        arrivals = [base] * banks if offsets_ns is None else \
            [max(base, math.ceil(o / tck)) for o in offsets_ns]
        # a fused chain trace enqueues as ONE request — a single FR-FCFS
        # unit — but carries its per-stage seq spans so RequestTiming can
        # still attribute service time per constituent op
        chain = getattr(trace, "chain", None)
        fused = tuple((s.op, s.seq_end - s.seq_start)
                      for s in getattr(chain, "stages", ()) or ())
        req = _Request(name, tenant, kinds, analytic, int(lanes), bank_ids,
                       min(arrivals) if arrivals else base, fused=fused)
        req.arrivals = tuple(arrivals)
        req.fingerprint = trace.fingerprint
        self._requests.append(req)
        if not kinds:
            # empty trace: completes on arrival, engages no bank
            req.streams_left = 0
            req.first_act = req.arrival
            req.finishes = list(arrivals)
            return rid
        est = sum(self._rt.c_rc + (self._rt.c_ras if k != SEQ_AP else 0)
                  for k in kinds)
        for a, b in zip(arrivals, bank_ids):
            self._queues[b].append(_Stream(rid, order, a))
            self._load[b] += est
        return rid

    @property
    def n_pending(self) -> int:
        """Streams still queued (across all banks)."""
        return sum(len(q) for q in self._queues)

    # -- the event loop ------------------------------------------------------
    def run(self) -> ScheduleResult:
        """Drain every queue through the FSM array and return the schedule.

        One-shot: the run starts a fresh rank clock at cycle 0, consumes
        everything enqueued so far, and resets the queues — a subsequent
        ``enqueue``/``run`` round models a new, independently-anchored
        busy period."""
        rt = self._rt
        tck = self.timing.tCK_ns
        c_ras, c_rp, c_rc = rt.c_ras, rt.c_rp, rt.c_rc
        phase = 0
        if rt.c_refi and self.refresh_phase_ns:
            phase = math.ceil(self.refresh_phase_ns / tck) % rt.c_refi
        memo_key = None
        if self.memo is not None and self._requests:
            # the busy period's full determinant: per-request content
            # (trace hash, placement, stream arrival cycles) + controller
            # configuration.  Names/tenants/lanes/fused labels are NOT in
            # the key — a hit is re-labeled from the live request set.
            memo_key = ("sched", self.policy, self.refresh_policy, phase,
                        self.n_banks, rt._sig,
                        tuple((r.fingerprint, r.bank_ids, r.arrivals)
                              for r in self._requests))
            hit = self.memo.schedule_get(memo_key)
            if hit is not None:
                relabeled = tuple(
                    dataclasses.replace(
                        cached, name=req.name, tenant=req.tenant,
                        lanes=req.lanes, fused_stages=req.fused)
                    for cached, req in zip(hit.requests, self._requests))
                self._reset()
                return dataclasses.replace(hit, requests=relabeled)
        rank = rt._rank(coupled=True, phase=phase)
        queues = self._queues
        requests = self._requests
        aware = self.refresh_policy == "aware"
        stall = self.refresh_policy == "stall"
        # per-bank FSM state (banks power up idle and precharged)
        n = self.n_banks
        now = [0] * n
        last_act = [-c_rc] * n
        last_pre = [-c_rp] * n
        head = [0] * n                   # FIFO cursor per bank queue
        bank_finish = [0] * n
        pending = sum(len(q) for q in queues)
        total_acts = 0
        total_restarts = 0
        while pending:
            # arbitration: the first-ready bank head (FR-FCFS) or the
            # oldest queued stream (FCFS); ties oldest-then-lowest-bank
            best = None
            for k in range(n):
                if head[k] >= len(queues[k]):
                    continue
                s = queues[k][head[k]]
                if s.phase:
                    t = last_act[k] + c_ras
                else:
                    t = max(now[k], last_pre[k] + c_rp, last_act[k] + c_rc,
                            s.arrival)
                # Under the eager ``"stall"`` policy, in-flight sequences
                # take strict priority (FR-FCFS row-hit-first): after an
                # all-bank refresh every aborted stream's fresh first ACT
                # is ready at the window end, perpetually outracing the
                # in-flight second ACTs (ready a tRAS later) — without the
                # priority no AAP ever completes between refresh windows
                # and the eager loop livelocks.  Rank ACT issue times stay
                # monotone regardless (constrain_act floors at the last
                # recorded ACT + tRRD), so the shared bookkeeping is safe.
                key = (0 if (stall and s.phase) else 1, t, s.order, k)
                if best is None or key < best[0]:
                    best = (key, k, s, t)
            _, k, s, t = best
            req = requests[s.rid]
            kind = req.kinds[s.seq_i]
            if aware and s.phase == 0 and kind != SEQ_AP:
                # pause-point: hold the sequence until every activation
                # clears the refresh grid — a window landing between the
                # ACTs would destroy the in-flight charge-sharing state.
                # (Single-ACT sequences need no lookahead: constrain_refresh
                # already keeps the lone ACT out of windows, and the FSM
                # model issues precharges unconstrained, matching the
                # replay substrate.)  A pause re-arbitrates instead of
                # issuing: another bank's ready activation takes the slot,
                # and the shared rank bookkeeping stays in time order.
                t2 = rank.clear_of_refresh(t, c_ras + 1)
                if t2 > t:
                    rank.refresh_stall += t2 - t
                    rank.n_refresh_stalls += 1
                    req.refresh += t2 - t
                    req.n_ref += 1
                    s.arrival = t2
                    continue
            tfaw0 = rank.tfaw_stall
            t = rank.constrain_act(t)
            req.tfaw += rank.tfaw_stall - tfaw0
            if stall and s.phase:
                ws = rank.next_refresh_start(last_act[k] + 1)
                if ws is not None and ws <= t:
                    # a refresh window opened between the sequence's
                    # activations: the all-bank refresh precharged the rank
                    # mid-sequence, destroying the in-flight charge-sharing
                    # state — the sequence aborts and re-issues after the
                    # window (the wasted activation already consumed its
                    # rank ACT slot)
                    s.phase = 0
                    req.restarts += 1
                    total_restarts += 1
                    we = ws + rank.c_rfc
                    if we > t:
                        req.refresh += we - t
                        req.n_ref += 1
                    now[k] = max(now[k], we)
                    continue
            ref0, nref0 = rank.refresh_stall, rank.n_refresh_stalls
            t = rank.constrain_refresh(t)
            req.refresh += rank.refresh_stall - ref0
            req.n_ref += rank.n_refresh_stalls - nref0
            rank.record(t)
            last_act[k] = t
            req.acts += 1
            total_acts += 1
            if req.first_act is None or t < req.first_act:
                req.first_act = t
            if s.phase == 0 and kind != SEQ_AP:
                s.phase = 1               # AAP / Case-2: back-to-back ACT
            else:
                pre = t + c_ras           # sequence retires with a PRECHARGE
                last_pre[k] = pre
                now[k] = pre
                s.phase = 0
                s.seq_i += 1
                if s.seq_i == len(req.kinds):
                    fin = pre + c_rp      # final precharge must complete
                    req.finishes.append(fin)
                    req.streams_left -= 1
                    bank_finish[k] = fin
                    head[k] += 1
                    pending -= 1
        # collect per-request timings in submission order
        out = []
        for rid, req in enumerate(requests):
            start = req.first_act if req.first_act is not None \
                else req.arrival
            finishes = req.finishes or [req.arrival]
            out.append(RequestTiming(
                index=rid, name=req.name, tenant=req.tenant,
                bank_ids=req.bank_ids,
                arrival_ns=req.arrival * tck, start_ns=start * tck,
                finish_ns=max(finishes) * tck, analytic_ns=req.analytic,
                tfaw_stall_ns=req.tfaw * tck,
                refresh_stall_ns=req.refresh * tck,
                n_refresh_stalls=req.n_ref, n_restarts=req.restarts,
                n_acts=req.acts, n_seqs=len(req.kinds) * len(req.bank_ids),
                lanes=req.lanes,
                stream_finish_ns=tuple(f * tck for f in finishes),
                fused_stages=req.fused))
        cycles = max((max(r.finishes) for r in requests if r.finishes),
                     default=0)
        result = ScheduleResult(
            ns=cycles * tck, cycles=cycles, n_requests=len(requests),
            n_acts=total_acts, tfaw_stall_ns=rank.tfaw_stall * tck,
            refresh_stall_ns=rank.refresh_stall * tck,
            n_refresh_stalls=rank.n_refresh_stalls,
            n_restarts=total_restarts, requests=tuple(out),
            bank_finish_ns=tuple(f * tck for f in bank_finish))
        if memo_key is not None:
            self.memo.schedule_put(memo_key, result)
        self._reset()
        return result

    def _reset(self) -> None:
        self._queues = [[] for _ in range(self.n_banks)]
        self._load = [0] * self.n_banks
        self._requests = []
        self._lint_entries = []
