"""Continuous-batching primitives for the SIMDRAM serving layer.

A decode session is a stream of dependent single-token steps: each step
issues one bit-serial μProgram whose output feeds the next step's input
(the recurrence that makes decode latency-bound).  Continuous batching —
the vLLM-style serving discipline — packs the *independent* sessions'
current steps together instead: at every step boundary compatible
sessions stack along the bank axis into one bank-parallel request,
finished sessions retire, and newly arrived sessions join, so the rank
is never idle waiting for the slowest sequence.

This module holds the machine-local half of that discipline:

* :func:`profile_for` — maps a model-zoo config to a
  :class:`RequestProfile` (which μProgram a session issues per token, at
  which width and lane count), so the zoo supplies request-mix diversity
  without hauling full model graphs through the scheduler.
* :class:`DecodeSession` — one admitted request: its operand state (the
  value recurrence), progress, and modeled per-token timing.
* :class:`ContinuousBatcher` — drives ONE
  :class:`~repro_torch.simdram.machine.SimdramMachine` step by step: submit
  every active session's token op (per-session tenant + priority),
  ``drain(batch=True)`` so compatible sessions ride one banked dispatch,
  advance the modeled clock by the step makespan, retire finished
  sessions.
* :func:`percentile` — the deterministic linear-interpolation percentile
  the SLO metrics use (golden-tested; no numpy dependency surprises).

Sharding sessions across a *pool* of machines and the request-loop
surface live in :mod:`repro_torch.serve.server`.  All timing here is modeled
nanoseconds on each machine's rank clock — never wall clock — so serving
metrics are exactly reproducible.

A session's operand state is drawn with numpy from its seed (so it equals
the reference's bit for bit) and moves to the serving machine's device
once, at admission; from then on the recurrence stays there as ``int64``
tensors, with no copy back to the host per token.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..configs import get_reduced

__all__ = ["RequestProfile", "profile_for", "DecodeSession",
           "ContinuousBatcher", "percentile"]


def percentile(values, q: float) -> float:
    """The q-th percentile of ``values`` by linear interpolation between
    closest ranks (the numpy default), implemented deterministically for
    the serving SLO metrics: ``percentile([1..100], 50) == 50.5``."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of an empty sequence")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"q must be in [0, 100], got {q}")
    pos = (len(xs) - 1) * (q / 100.0)
    lo = math.floor(pos)
    hi = math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


@dataclasses.dataclass(frozen=True)
class RequestProfile:
    """Per-token work one decode session issues, derived from a model-zoo
    config: each decode step of ``config`` is represented by one ``op``
    μProgram at ``n_bits`` over ``lanes`` SIMD lanes."""
    config: str
    family: str
    op: str
    n_bits: int
    lanes: int

    @property
    def batch_key(self) -> tuple:
        """Sessions with equal keys are bank-compatible: same trace and
        operand shape, so their steps stack into one banked dispatch."""
        return (self.op, self.n_bits, self.lanes)


# family → the μProgram standing in for one decode step of that family;
# a fixed map keeps the request mix deterministic per config
_FAMILY_OPS = {
    "dense": "addition",
    "moe": "maximum",
    "ssm": "multiplication",
    "audio": "subtraction",
    "vlm": "greater",
    "hybrid": "minimum",
}


def profile_for(config: str, n_bits: int = 8) -> RequestProfile:
    """The :class:`RequestProfile` of a model-zoo config (reduced size):
    op by model family, lane count from the reduced ``d_model`` (rounded
    up to a 32-lane granule, clamped to [32, 128])."""
    cfg = get_reduced(config)
    op = _FAMILY_OPS.get(cfg.family, "addition")
    lanes = min(128, max(32, ((cfg.d_model + 31) // 32) * 32))
    return RequestProfile(config=config, family=cfg.family, op=op,
                          n_bits=n_bits, lanes=lanes)


class DecodeSession:
    """One admitted decode request: ``n_tokens`` dependent steps of the
    session's :class:`RequestProfile`, with the op output feeding the
    next step's first operand (the decode recurrence).

    All clocks are modeled ns on the serving machine's rank clock:
    ``arrival_ns`` is stamped at submission, ``first_token_ns`` /
    ``finish_ns`` are absolute completion times, and ``token_ns`` holds
    each token's latency (arrival→finish for the first token, step
    issue→finish for steady-state tokens).
    """

    def __init__(self, sid: int, profile: RequestProfile, n_tokens: int,
                 arrival_ns: float = 0.0, priority: int = 0,
                 seed: int | None = None) -> None:
        if n_tokens < 1:
            raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
        self.sid = sid
        self.tenant = f"s{sid}"
        self.profile = profile
        self.n_tokens = int(n_tokens)
        self.arrival_ns = float(arrival_ns)
        self.priority = int(priority)
        rng = np.random.default_rng(sid if seed is None else seed)
        hi = 1 << profile.n_bits
        self.a = rng.integers(0, hi, profile.lanes, dtype=np.int64)
        self.b = rng.integers(1, hi, profile.lanes, dtype=np.int64)
        self.tokens_done = 0
        self.first_token_ns: float | None = None
        self.finish_ns: float | None = None
        self.token_ns: list[float] = []
        self.queue_ns = 0.0         # summed per-token queue time
        self.machine_index: int | None = None

    def __repr__(self) -> str:
        return (f"<DecodeSession {self.tenant} {self.profile.config} "
                f"{self.tokens_done}/{self.n_tokens} tokens>")

    @property
    def done(self) -> bool:
        return self.tokens_done >= self.n_tokens

    def place(self, device) -> None:
        """Move the operand state to ``device`` as ``int64`` tensors (once,
        when the session joins a machine)."""
        self.a = torch.as_tensor(self.a, dtype=torch.int64, device=device)
        self.b = torch.as_tensor(self.b, dtype=torch.int64, device=device)

    def advance(self, value, timing, step_start_ns: float) -> None:
        """Record one completed token: fold the op output back into the
        recurrence and stamp the token's modeled latency from its
        :class:`~repro_torch.simdram.scheduler.RequestTiming` (relative to the
        step's start on the machine clock).  ``value`` stays on its device."""
        self.a = value.to(torch.int64) & ((1 << self.profile.n_bits) - 1)
        finish_abs = step_start_ns + timing.finish_ns
        if self.first_token_ns is None:
            self.first_token_ns = finish_abs
            # TTFT token: latency measured from the session's arrival
            self.token_ns.append(finish_abs - self.arrival_ns)
        else:
            self.token_ns.append(timing.finish_ns)
        self.queue_ns += timing.queue_ns
        self.tokens_done += 1
        if self.done:
            self.finish_ns = finish_abs

    @property
    def ttft_ns(self) -> float | None:
        """Time-to-first-token: arrival → first token complete."""
        if self.first_token_ns is None:
            return None
        return self.first_token_ns - self.arrival_ns


class ContinuousBatcher:
    """Step-boundary continuous batching over ONE machine.

    Each :meth:`step` submits every active session's current token op to
    the machine (per-session tenant for PerfStats isolation, the
    session's priority as its latency class) and drains with
    ``batch=True``: compatible sessions (equal
    :attr:`RequestProfile.batch_key`) stack along the bank axis into one
    scheduler request + one banked dispatch; incompatible ones still
    pack the same rank under FR-FCFS.  The modeled clock advances by the
    step's makespan, finished sessions retire, and the server admits new
    arrivals before the next step — never mid-step, matching the
    continuous-batching discipline.
    """

    def __init__(self, machine, n_banks: int | None = None,
                 refresh_policy: str = "aware") -> None:
        self.machine = machine
        self.n_banks = n_banks if n_banks is not None \
            else (machine.banks if machine.banks > 1
                  else machine.timing.banks_per_chip)
        self.refresh_policy = refresh_policy
        self.active: list[DecodeSession] = []
        self.clock_ns = 0.0          # this machine's modeled serving clock
        self.steps = 0
        self.tokens = 0

    def __repr__(self) -> str:
        return (f"<ContinuousBatcher machine={self.machine!r} "
                f"active={len(self.active)} clock={self.clock_ns:.0f}ns>")

    def admit(self, session: DecodeSession) -> None:
        """Join a session at the next step boundary.  An idle machine
        fast-forwards its clock to the session's arrival; on a busy one
        the caller admits only once the clock has reached the arrival
        (the server's admission rule), so a session never issues work
        before it exists.  The session's operands move to the machine's
        device here."""
        session.place(self.machine.device)
        if not self.active:
            self.clock_ns = max(self.clock_ns, session.arrival_ns)
        self.active.append(session)

    def step(self) -> list[DecodeSession]:
        """Run one decode step for every active session; returns the
        sessions that finished (already retired from :attr:`active`)."""
        if not self.active:
            return []
        step_start = self.clock_ns
        futs = []
        for s in self.active:
            fut = self.machine.submit(
                s.profile.op, s.a, s.b, n_bits=s.profile.n_bits,
                tenant=s.tenant, priority=s.priority,
                arrival_ns=max(0.0, s.arrival_ns - step_start))
            futs.append((s, fut))
        res = self.machine.drain(n_banks=self.n_banks,
                                 refresh_policy=self.refresh_policy,
                                 batch=True)
        self.clock_ns = step_start + res.ns
        self.steps += 1
        finished = []
        for s, fut in futs:
            s.advance(fut.result(), fut.timing, step_start)
            self.tokens += 1
            if s.done:
                finished.append(s)
        self.active = [s for s in self.active if not s.done]
        return finished
