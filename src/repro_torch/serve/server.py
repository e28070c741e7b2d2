"""``SimdramServer`` — the end-to-end serving layer.

The SIMDRAM paper evaluates operations; a *system* serves traffic.  This
module turns the repo's stack into one: concurrent decode sessions enter
through a thread-safe (and asyncio-friendly) request surface, shard
across a pool of isolated :class:`~repro_torch.simdram.machine.SimdramMachine`
instances (per-machine session isolation makes the pool safe in one process),
and each machine's :class:`~repro_torch.serve.batching.ContinuousBatcher`
continuously batches the resident sessions' decode steps into the bank
axis — new arrivals join at step boundaries, finished sequences retire,
and the re-packed steps flow through ``machine.submit()`` / the
:class:`~repro_torch.simdram.scheduler.BankScheduler` under FR-FCFS with the
chosen refresh policy.  Every prior subsystem is on the hot path:
compile/lower caching (μProgram Memory), the vectorized replay engine
and replay memo, the whole-schedule memo, trace lint, and per-tenant
PerfStats attribution.

Timing is *modeled*: each machine keeps a rank-clock in nanoseconds and
every latency below is derived from scheduler
:class:`~repro_torch.simdram.scheduler.RequestTiming`, never wall clock —
serving metrics are bit-exact across runs.  :class:`ServingStats` sits
on top of :meth:`~repro_torch.core.backends.PerfStats.snapshot` and reports
the SLO view: modeled p50/p99 ns-per-token, time-to-first-token
percentiles, and aggregate tokens/s at N concurrent users.

Every pooled machine runs on the server's ``device`` (``"cuda"`` by
default; a cuda server on a host without a card raises, as the machine
does), and the sessions' operand state lives there from admission on.

Typical use::

    server = SimdramServer(n_machines=2, n_banks=8)
    handles = [server.submit_session("qwen1_5_0_5b", n_tokens=8)
               for _ in range(8)]
    stats = server.run()            # steps until every session finishes
    print(stats.report())
    final_values = handles[0].result()
"""
from __future__ import annotations

import threading

import torch

from ..simdram.machine import SimdramMachine
from .batching import ContinuousBatcher, DecodeSession, percentile, \
    profile_for

__all__ = ["SimdramServer", "ServingStats", "SessionHandle"]


class SessionHandle:
    """Caller-side handle to one submitted decode session.

    ``wait``/``result`` block on a :class:`threading.Event` the serving
    loop sets at retirement; :meth:`wait_async` awaits the same event
    without blocking the event loop.  Timing properties are modeled ns.
    """

    def __init__(self, session: DecodeSession) -> None:
        self._session = session
        self._event = threading.Event()

    def __repr__(self) -> str:
        state = "done" if self.done() else "pending"
        return f"<SessionHandle {self._session.tenant} {state}>"

    @property
    def session(self) -> DecodeSession:
        return self._session

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the session retires (or ``timeout`` seconds of
        wall clock pass — the only wall-clock in this layer, and it never
        feeds a metric).  Returns whether the session is done."""
        return self._event.wait(timeout)

    async def wait_async(self) -> "SessionHandle":
        """Await retirement from an asyncio event loop (the serving loop
        itself may run in a worker thread)."""
        import asyncio
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self._event.wait)
        return self

    def result(self, timeout: float | None = None):
        """The session's final operand state (the decode recurrence after
        its last token, an ``int64`` tensor on the serving machine's
        device); raises if the session has not retired in time."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"session {self._session.tenant} still pending")
        return self._session.a

    @property
    def ttft_ns(self) -> float | None:
        return self._session.ttft_ns

    @property
    def finish_ns(self) -> float | None:
        return self._session.finish_ns

    @property
    def token_ns(self) -> tuple[float, ...]:
        return tuple(self._session.token_ns)


class ServingStats:
    """SLO-style rollup of one serving run (modeled ns only).

    Percentiles pool every completed session's per-token latencies;
    ``tokens_per_s`` is aggregate completed tokens over the serving span
    (earliest arrival → latest finish) at the run's concurrency.  The
    per-machine section embeds each machine's
    :meth:`~repro_torch.core.backends.PerfStats.snapshot` and μProgram-Memory
    counters, so the serving view composes with — instead of replacing —
    the existing perf instrumentation.
    """

    def __init__(self, server: "SimdramServer") -> None:
        sessions = list(server.completed)
        self.users = server.peak_concurrency
        self.n_sessions = len(sessions)
        self.total_tokens = sum(s.tokens_done for s in sessions)
        token_ns = [t for s in sessions for t in s.token_ns]
        ttfts = [s.ttft_ns for s in sessions if s.ttft_ns is not None]
        self.p50_token_ns = percentile(token_ns, 50) if token_ns else 0.0
        self.p99_token_ns = percentile(token_ns, 99) if token_ns else 0.0
        self.p50_ttft_ns = percentile(ttfts, 50) if ttfts else 0.0
        self.p99_ttft_ns = percentile(ttfts, 99) if ttfts else 0.0
        arrivals = [s.arrival_ns for s in sessions]
        finishes = [s.finish_ns for s in sessions
                    if s.finish_ns is not None]
        self.span_ns = (max(finishes) - min(arrivals)) \
            if arrivals and finishes else 0.0
        self.tokens_per_s = (self.total_tokens / self.span_ns * 1e9) \
            if self.span_ns > 0 else 0.0
        self.machines = [{
            "clock_ns": b.clock_ns,
            "steps": b.steps,
            "tokens": b.tokens,
            "sessions": sorted(s.tenant for s in sessions
                               if s.machine_index == i),
            "perf": b.machine.stats.snapshot(),
            "cache": b.machine.cache_stats(),
        } for i, b in enumerate(server.batchers)]

    def snapshot(self) -> dict:
        """JSON-safe dict of every serving metric + per-machine detail."""
        return {
            "users": self.users,
            "n_sessions": self.n_sessions,
            "total_tokens": self.total_tokens,
            "p50_token_ns": self.p50_token_ns,
            "p99_token_ns": self.p99_token_ns,
            "p50_ttft_ns": self.p50_ttft_ns,
            "p99_ttft_ns": self.p99_ttft_ns,
            "span_ns": self.span_ns,
            "tokens_per_s": self.tokens_per_s,
            "machines": self.machines,
        }

    def report(self) -> str:
        lines = [
            "SIMDRAM serving stats (modeled)",
            f"  users (peak)        : {self.users}",
            f"  sessions completed  : {self.n_sessions}",
            f"  tokens              : {self.total_tokens}",
            f"  ns/token p50 / p99  : {self.p50_token_ns:,.1f} / "
            f"{self.p99_token_ns:,.1f}",
            f"  TTFT p50 / p99 (ns) : {self.p50_ttft_ns:,.1f} / "
            f"{self.p99_ttft_ns:,.1f}",
            f"  serving span        : {self.span_ns:,.1f} ns",
            f"  throughput          : {self.tokens_per_s:,.1f} tokens/s",
        ]
        for i, m in enumerate(self.machines):
            sched = m["cache"]
            lines.append(
                f"  machine[{i}]          : {m['tokens']} tokens / "
                f"{m['steps']} steps, clock {m['clock_ns']:,.1f} ns, "
                f"schedule memo {sched['schedule_hits']}h/"
                f"{sched['schedule_misses']}m")
        return "\n".join(lines)


class SimdramServer:
    """Continuous-batching decode server over a pool of bank-sharded
    SIMDRAM machines (see the module docstring).

    Parameters
    ----------
    n_machines : pool size; sessions shard to the least-active machine
        at admission (each machine is a fully isolated
        :class:`SimdramMachine`: own μProgram Memory, own PerfStats).
    n_banks : modeled controller width per machine — the continuous
        batch packs up to this many compatible sessions per dispatch.
    refresh_policy : scheduler refresh policy for every step
        (``"aware"`` / ``"stall"`` / ``"defer"``).
    backend / mode / timing / device : forwarded to each pooled machine
        (``device`` is ``"cuda"`` unless the caller asks for the CPU).
    machines : a ready pool, used in place of building one.
    """

    def __init__(self, n_machines: int = 2, n_banks: int = 8,
                 refresh_policy: str = "aware",
                 backend: str | None = None, mode: str = "analytic",
                 timing=None, machines=None,
                 device: str | torch.device = "cuda") -> None:
        if machines is None:
            if n_machines < 1:
                raise ValueError(f"n_machines must be >= 1, "
                                 f"got {n_machines}")
            machines = [SimdramMachine(timing=timing, backend=backend,
                                       mode=mode, device=device)
                        for _ in range(n_machines)]
        self.batchers = [ContinuousBatcher(m, n_banks=n_banks,
                                           refresh_policy=refresh_policy)
                         for m in machines]
        self._lock = threading.Lock()
        self._pending: list[tuple[DecodeSession, SessionHandle]] = []
        self._handles: dict[int, SessionHandle] = {}
        self._n_sessions = 0
        self.completed: list[DecodeSession] = []
        self.peak_concurrency = 0

    def __repr__(self) -> str:
        active = sum(len(b.active) for b in self.batchers)
        return (f"SimdramServer(machines={len(self.batchers)}, "
                f"active={active}, pending={len(self._pending)}, "
                f"completed={len(self.completed)})")

    @property
    def machines(self) -> list[SimdramMachine]:
        return [b.machine for b in self.batchers]

    # -- request surface (thread-safe) ---------------------------------------
    def submit_session(self, config: str = "qwen1_5_0_5b",
                       n_tokens: int = 8, arrival_ns: float = 0.0,
                       priority: int = 0, n_bits: int = 8,
                       seed: int | None = None) -> SessionHandle:
        """Admit one decode session (any thread); returns its
        :class:`SessionHandle`.  ``config`` names a model-zoo entry (its
        :func:`~repro_torch.serve.batching.profile_for` profile defines the
        per-token work); ``arrival_ns`` stamps the session's arrival on
        the modeled clock; ``priority`` is its latency class."""
        profile = profile_for(config, n_bits=n_bits)
        with self._lock:
            sid = self._n_sessions
            self._n_sessions += 1
            session = DecodeSession(sid, profile, n_tokens,
                                    arrival_ns=arrival_ns,
                                    priority=priority, seed=seed)
            handle = SessionHandle(session)
            self._pending.append((session, handle))
            self._handles[sid] = handle
        return handle

    # -- the serving loop ----------------------------------------------------
    def _admit(self) -> None:
        """Join pending sessions at a step boundary: least-active machine
        first; an idle machine fast-forwards its clock to the arrival,
        a busy one admits only sessions that have already arrived on its
        modeled clock (future arrivals keep pending until the clock
        catches up)."""
        with self._lock:
            pending = self._pending
            self._pending = []
        still_pending = []
        for session, handle in sorted(
                pending, key=lambda p: (p[0].arrival_ns, p[0].sid)):
            order = sorted(range(len(self.batchers)),
                           key=lambda i: (len(self.batchers[i].active), i))
            placed = False
            for i in order:
                b = self.batchers[i]
                if not b.active or session.arrival_ns <= b.clock_ns:
                    session.machine_index = i
                    b.admit(session)
                    placed = True
                    break
            if not placed:
                still_pending.append((session, handle))
        if still_pending:
            with self._lock:
                self._pending = still_pending + self._pending
        live = sum(len(b.active) for b in self.batchers)
        self.peak_concurrency = max(self.peak_concurrency, live)

    def has_work(self) -> bool:
        with self._lock:
            if self._pending:
                return True
        return any(b.active for b in self.batchers)

    def step(self) -> int:
        """One serving step: admit pending sessions at the boundary, run
        every machine's continuous batch one decode step, retire finished
        sessions (setting their handles).  Returns the number of sessions
        retired this step."""
        self._admit()
        retired = 0
        for b in self.batchers:
            for session in b.step():
                self.completed.append(session)
                handle = self._handles.pop(session.sid, None)
                if handle is not None:
                    handle._event.set()
                retired += 1
        return retired

    def run(self, max_steps: int | None = None) -> ServingStats:
        """Step until every submitted session has retired (or
        ``max_steps``); returns the run's :class:`ServingStats`."""
        steps = 0
        while self.has_work():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self.stats()

    async def run_async(self, max_steps: int | None = None) -> ServingStats:
        """Run the serving loop in a worker thread and await completion —
        the asyncio face of :meth:`run` (handles stay awaitable via
        :meth:`SessionHandle.wait_async`)."""
        import asyncio
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, lambda: self.run(max_steps))

    def stats(self) -> ServingStats:
        return ServingStats(self)
