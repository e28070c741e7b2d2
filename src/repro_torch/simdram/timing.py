"""DRAM timing, throughput and energy model (paper §6, §7.1, §7.2).

The paper's methodology: an operation's latency is the sum of its AAP/AP
command-sequence latencies under DDR4-2400 timing; throughput is
``SIMD lanes × banks / latency``; energy follows the Micron power model with
Ambit's observation that each additional simultaneously-activated row costs
+22% activation energy [131].

Baselines (paper Table 2): the CPU (16-core Skylake, AVX-512, 4-channel
DDR4-2400) and GPU (Titan V, HBM2) are modeled at their *memory-bandwidth
roofline* for these streaming, memory-bound kernels — the paper itself
classifies the target workloads as memory-bound, so the bandwidth roofline is
the right analytic stand-in for measured hardware we do not have.  All
constants are documented here and surfaced in benchmark output.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..core.trace import ACT_GAP_RAS, ACT_GAP_RC, ACT_GAP_START, SEQ_AP
from ..core.uprogram import UProgram


@dataclasses.dataclass(frozen=True)
class DRAMTiming:
    """DDR4-2400 (per paper Table 2).

    Beyond the per-bank row-cycle parameters, the replay substrate obeys the
    rank-level activation windows real chips enforce: ``tRRD`` (minimum gap
    between ACTs to different banks of a rank), ``tFAW`` (at most four ACTs
    per sliding window — the four-activate window), and periodic refresh
    (one ``tRFC``-long all-bank refresh every ``tREFI``).  Set ``tFAW_ns=0``
    / ``tRRD_ns=0`` to lift the activation windows and ``tREFI_ns=0`` to
    disable refresh.  ``desync_policy`` selects how multi-bank replay runs:
    ``"desync"`` (default) replays one FSM per bank with the rank windows
    coupling them; ``"lockstep"`` replays the legacy single broadcast FSM
    that assumes banks mirror each other for free (no tRRD/tFAW).

    ``replay_engine`` selects how traces replay: ``"vectorized"``
    (default) compiles each trace's stall structure to arrays and solves
    the timing recurrences with prefix scans, falling back to the FSM for
    the configurations it cannot prove exact; ``"stepped"`` always steps
    the per-edge FSM (the oracle).  Both produce cycle-identical
    :class:`ReplayResult`\\ s.
    """
    tCK_ns: float = 0.833
    tRCD_ns: float = 14.16
    tRP_ns: float = 14.16
    tRAS_ns: float = 32.0
    row_bits: int = 8 * 1024 * 8          # 8 kB row = 65536 bitlines/SIMD lanes
    banks_per_chip: int = 16
    # rank-level activation windows + refresh (DDR4-2400 x8 datasheet values)
    tRRD_ns: float = 4.9                  # ACT→ACT, different banks (tRRD_L)
    tFAW_ns: float = 30.0                 # four-activate window
    tREFI_ns: float = 7812.5              # avg refresh interval (64 ms / 8192)
    tRFC_ns: float = 350.0                # refresh cycle time (8 Gb die)
    desync_policy: str = "desync"         # "desync" | "lockstep"
    replay_engine: str = "vectorized"     # "vectorized" | "stepped"

    # command-sequence latencies (Ambit/RowClone command structure):
    #   AP  = ACTIVATE(triple) → PRECHARGE                = tRAS + tRP
    #   AAP = ACTIVATE → ACTIVATE → PRECHARGE             = 2·tRAS + tRP
    @property
    def t_ap_ns(self) -> float:
        return self.tRAS_ns + self.tRP_ns

    @property
    def t_aap_ns(self) -> float:
        return 2 * self.tRAS_ns + self.tRP_ns


@dataclasses.dataclass(frozen=True)
class DRAMEnergy:
    """Activation energy per 8 kB row (derived from the Micron TN-41-01 power
    model for DDR4-2400 x8: (IDD0−IDD3N)·tRC·VDD·devices_per_rank)."""
    e_act_nj: float = 5.8          # one full-row ACTIVATE+PRECHARGE pair
    tra_row_penalty: float = 0.22  # +22% per extra simultaneous row [131]
    background_w: float = 0.15     # per-bank background/peripheral power

    def e_ap_nj(self) -> float:
        # triple-row activation: 1 + 2·22% of a single activation
        return self.e_act_nj * (1 + 2 * self.tra_row_penalty)

    def e_aap_nj(self) -> float:
        return self.e_act_nj * 2   # two back-to-back activations


@dataclasses.dataclass(frozen=True)
class BaselineModel:
    """Memory-bandwidth-roofline models for the CPU/GPU baselines."""
    cpu_bw_gbs: float = 76.8       # 4 ch × DDR4-2400 (Table 2)
    gpu_bw_gbs: float = 652.8      # Titan V HBM2
    cpu_tdp_w: float = 165.0       # Skylake 16-core package
    gpu_tdp_w: float = 250.0       # Titan V board power
    # per-op stream profile: (input arrays, output arrays)
    streams: dict = dataclasses.field(default_factory=lambda: dict(
        default=(2, 1), relu=(1, 1), abs=(1, 1), bitcount=(1, 1),
        and_reduction=(3, 1), or_reduction=(3, 1), xor_reduction=(3, 1),
        if_else=(3, 1),
    ))

    def throughput_gops(self, op: str, n_bits: int, gpu: bool = False) -> float:
        ins, outs = self.streams.get(op, self.streams["default"])
        # computed in bits: the paper evaluates arbitrary precisions, and
        # ``n_bits // 8`` floors to 0 bytes for sub-byte elements
        bytes_per_elem = (ins + outs) * n_bits / 8
        bw = self.gpu_bw_gbs if gpu else self.cpu_bw_gbs
        return bw / bytes_per_elem

    def power_w(self, gpu: bool = False) -> float:
        return self.gpu_tdp_w if gpu else self.cpu_tdp_w


@dataclasses.dataclass(frozen=True)
class MovementModel:
    """In-DRAM data movement (paper §7.6): LISA for intra-bank inter-subarray
    row copies, RowClone PSM for inter-bank copies over the internal bus."""
    t_lisa_row_ns: float = 90.5          # LISA RBM hop (LISA paper, ~1.6 tRC)
    t_psm_row_ns: float = 8 * 1024 / 8 * 0.833  # PSM: row serialized over bus

    def intra_bank_ns(self, n_rows: int) -> float:
        return n_rows * self.t_lisa_row_ns

    def inter_bank_ns(self, n_rows: int) -> float:
        return n_rows * self.t_psm_row_ns


@dataclasses.dataclass(frozen=True)
class TranspositionModel:
    """Transposition-unit overhead (paper §5.1, §7.7): each 64 B cache line
    transposes in one 4 GHz core cycle through the transpose buffer; the
    critical path is the DRAM write of the first subarray's object slices
    (later subarrays overlap with compute)."""
    cacheline_bits: int = 512
    t_buffer_ns: float = 0.25            # 1 cycle @ 4 GHz
    dram_ch_bw_gbs: float = 19.2         # one DDR4-2400 channel

    def first_subarray_ns(self, n_bits: int, lanes: int) -> float:
        # ceiling division: a partial cache line still takes a full buffer
        # pass and a full line write (flooring reported *zero* transposition
        # cost for lanes < 512 and undercounted non-multiples)
        lines_per_plane = -(-lanes // self.cacheline_bits)
        n_lines = n_bits * lines_per_plane
        bytes_moved = n_lines * self.cacheline_bits / 8
        return n_lines * self.t_buffer_ns + bytes_moved / self.dram_ch_bw_gbs


# ---------------------------------------------------------------------------
# Trace-replay timing substrate (DRAMsim-style)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReplayResult:
    """Outcome of replaying one lowered trace on the bank FSM array.

    ``ns`` is the overall finish (the slowest bank); the per-bank breakdown
    records how desynchronized the banks ended up (``max_bank_ns`` −
    ``min_bank_ns``) and attributes stall time to the two rank-level
    mechanisms: the four-activate window (``tfaw_stall_ns``) and refresh
    windows (``refresh_stall_ns``).  Stall attributions are summed over
    every issued command (per-bank streams) or over the broadcast timeline
    (lockstep policy).
    """
    ns: float            # replayed latency (cycle-quantized, with stalls)
    stall_ns: float      # replayed − analytic (≥ 0: replay only adds stalls)
    cycles: int          # DRAM clock cycles consumed (slowest bank)
    n_seqs: int          # command sequences replayed (all banks)
    n_acts: int          # row activations issued (all banks)
    banks: int = 1
    max_bank_ns: float = 0.0      # slowest bank's finish time (== ns)
    min_bank_ns: float = 0.0      # fastest bank's finish time
    tfaw_stall_ns: float = 0.0    # ACTs deferred by the four-activate window
    refresh_stall_ns: float = 0.0  # ACTs deferred by refresh windows
    n_refresh_stalls: int = 0     # ACT issues pushed past a refresh window

    @property
    def bank_spread_ns(self) -> float:
        """Finish-time spread between the slowest and fastest bank."""
        return self.max_bank_ns - self.min_bank_ns


class _RankState:
    """Rank-level issue constraints shared by every bank FSM of a rank.

    Tracks the three mechanisms the per-bank FSMs cannot see alone: the
    minimum ACT→ACT gap across banks (tRRD), the sliding four-activate
    window (tFAW — at most four ACTs per window), and periodic refresh
    (ACTs may not issue inside ``[k·tREFI, k·tREFI + tRFC)``).  All three
    only ever *delay* an ACT, so replay latency remains a superset of the
    analytic command sum.

    ``phase`` shifts the refresh-window grid: refresh windows are anchored
    in *rank* time, not per-op time, so a replay that starts ``phase``
    cycles after the previous refresh epoch sees its first window after
    ``tREFI − phase`` local cycles instead of ``tREFI``.  The timed
    execution layer threads its accumulated replay clock through here
    (``PerfStats(refresh_phase=True)``) so ops shorter than tREFI still
    accrue their share of refresh stall inside long pipelines.
    """

    __slots__ = ("c_rrd", "c_faw", "c_refi", "c_rfc", "phase", "last_act",
                 "acts", "tfaw_stall", "refresh_stall", "n_refresh_stalls")

    def __init__(self, c_rrd: int, c_faw: int, c_refi: int,
                 c_rfc: int, phase: int = 0) -> None:
        self.c_rrd = c_rrd
        self.c_faw = c_faw
        self.c_refi = c_refi
        self.c_rfc = c_rfc
        self.phase = phase
        self.last_act: int | None = None
        self.acts: list[int] = []          # issue cycles of the last 4 ACTs
        self.tfaw_stall = 0
        self.refresh_stall = 0
        self.n_refresh_stalls = 0

    def constrain_act(self, t: int) -> int:
        """Earliest cycle ≥ ``t`` satisfying the rank's ACT-slot windows —
        the tRRD ACT→ACT gap and the sliding four-activate tFAW window.
        Refresh is *not* consulted (see :meth:`constrain_refresh`); the
        split lets queue-aware schedulers interleave their own refresh
        policy between the two checks."""
        if self.c_rrd and self.last_act is not None:
            t = max(t, self.last_act + self.c_rrd)
        if self.c_faw and len(self.acts) == 4:
            gate = self.acts[0] + self.c_faw
            if gate > t:
                self.tfaw_stall += gate - t
                t = gate
        return t

    def refresh_window(self, t: int) -> tuple[int, int] | None:
        """The ``(start, end)`` local-cycle bounds of the refresh window
        covering ``t``, or None when ``t`` is outside every active window.

        Rank time = local replay time + phase since the last epoch.
        ``k >= 1`` models the freshly-refreshed bank of a standalone
        replay (no window at its own t=0); with a threaded phase the
        epoch-0 window is real — an op whose clock lands just past a
        tREFI boundary starts *inside* that window and must stall out of
        it (phase > 0 lifts the guard for k == 0)."""
        if not self.c_refi:
            return None
        ta = t + self.phase
        k = ta // self.c_refi
        if (k >= 1 or self.phase) and ta < k * self.c_refi + self.c_rfc:
            return (k * self.c_refi - self.phase,
                    k * self.c_refi + self.c_rfc - self.phase)
        return None

    def next_refresh_start(self, t: int) -> int | None:
        """Local start cycle of the first *active* refresh window whose
        start is ≥ ``t`` (None when refresh is disabled).  The epoch-0
        window only exists under a threaded phase, matching
        :meth:`refresh_window`'s guard."""
        if not self.c_refi:
            return None
        k_min = 0 if self.phase else 1
        k = max(k_min, -(-(t + self.phase) // self.c_refi))
        return k * self.c_refi - self.phase

    def clear_of_refresh(self, t: int, span: int) -> int:
        """Earliest cycle ≥ ``t`` at which a busy period of ``span`` cycles
        fits entirely between refresh windows — the refresh-*aware*
        scheduler's pause-point: rather than letting a window interrupt an
        in-flight command sequence, issue is held until the whole sequence
        can run to completion.  A span too long to ever fit between two
        windows is returned unchanged; the caller falls back to
        mid-sequence refresh semantics."""
        if not self.c_refi or span >= self.c_refi - self.c_rfc:
            return t
        while True:
            win = self.refresh_window(t)
            if win is not None:
                t = win[1]
                continue
            nxt = self.next_refresh_start(t)
            if nxt is not None and nxt < t + span:
                t = nxt + self.c_rfc
                continue
            return t

    def constrain_refresh(self, t: int) -> int:
        """Earliest cycle ≥ ``t`` outside any refresh window (ACTs may not
        issue while the rank refreshes); deferral is metered as refresh
        stall."""
        win = self.refresh_window(t)
        if win is not None:
            self.refresh_stall += win[1] - t
            self.n_refresh_stalls += 1
            t = win[1]
        return t

    def constrain(self, t: int) -> int:
        """Earliest cycle ≥ ``t`` at which one more ACT may issue (ACT-slot
        windows first, then refresh)."""
        return self.constrain_refresh(self.constrain_act(t))

    def record(self, t: int) -> None:
        # tolerate slightly out-of-order records (a scheduler issuing a
        # prioritized in-flight ACT with tRRD disabled): the window
        # bookkeeping needs last_act/acts[0] to be the true max/min
        self.last_act = t if self.last_act is None else max(self.last_act, t)
        self.acts.append(t)
        if len(self.acts) > 1 and self.acts[-2] > t:
            self.acts.sort()
        if len(self.acts) > 4:
            del self.acts[0]


class TraceReplayTiming:
    """Cycle-accurate trace replay: every command sequence of a
    :class:`~repro_torch.core.trace.LoweredTrace` is issued to an array of
    per-bank ACT/PRE state machines on DRAM clock edges instead of being
    charged a flat analytic latency.

    Each bank FSM tracks the hazards the analytic per-command sum ignores:
    an ACT may only issue tRP after the bank's last PRECHARGE and tRC after
    its last ACTIVATE, and a PRECHARGE only tRAS after the row (or row
    group) activated; within an AAP the back-to-back ACTIVATE follows the
    source activation after tRAS (Ambit's command structure).  Banks of a
    rank are additionally coupled by the shared :class:`_RankState` — tRRD
    between ACTs to different banks, the four-activate tFAW window, and
    periodic tREFI/tRFC refresh windows that stall in-flight sequences —
    and each bank may start at its own issue offset (``offsets_ns``, e.g.
    the data-arrival skew of a preceding inter-bank redistribution).

    Commands issue on tCK boundaries, so each timing parameter rounds *up*
    to whole cycles; quantization, hazards, rank windows and offsets only
    ever *delay* commands, so the replayed latency is a superset of the
    analytic sum on every policy.  ``desync_policy="lockstep"`` restores
    the legacy broadcast model (one FSM replays for all banks, no
    tRRD/tFAW coupling) for A/B comparison.

    Two engines produce the same cycle-exact result.  ``"stepped"`` is
    the per-edge FSM above, the oracle.  ``"vectorized"`` (the default)
    compiles the trace's activation skeleton once
    (:meth:`~repro_torch.core.trace.LoweredTrace.act_structure`) and solves the
    per-bank ready chains, the tRRD/tFAW rank windows and the tREFI/tRFC
    refresh grid as a monotone fixpoint over cycle arrays — cummax prefix
    scans for the chain/rank closures, a pointwise jump for refresh —
    then reconstructs the stall attribution from the converged schedule.
    The rank-level arbitration order is itself solved as an outer
    fixpoint (solve times under a candidate order, re-sort by local
    readiness, repeat until stable) and *verified* against the FSM's
    arbitration rule on the converged schedule; the few configurations
    the solver cannot prove (``tRRD=0`` with ``tFAW`` active across
    desynchronized banks, or a non-converging fixpoint) transparently
    fall back to the stepped FSM, so the engine choice is never visible
    in results.
    """

    # fixpoint-iteration headroom beyond the refresh-window estimate; the
    # solver falls back to the stepped oracle if it fails to converge
    _BASE_ITERS = 64
    # rank-coupled order resolution is sequential per refresh window, so
    # schedules crossing more windows than this are cheaper to step
    _MAX_WINDOWS = 16

    def __init__(self, timing: DRAMTiming | None = None) -> None:
        self.timing = timing or DRAMTiming()
        t = self.timing
        tck = t.tCK_ns
        self.c_ras = math.ceil(t.tRAS_ns / tck)
        self.c_rp = math.ceil(t.tRP_ns / tck)
        self.c_rc = self.c_ras + self.c_rp        # ACT→ACT, same bank
        self.c_rrd = math.ceil(t.tRRD_ns / tck) if t.tRRD_ns > 0 else 0
        self.c_faw = math.ceil(t.tFAW_ns / tck) if t.tFAW_ns > 0 else 0
        refresh_on = t.tREFI_ns > 0 and t.tRFC_ns > 0
        self.c_refi = math.ceil(t.tREFI_ns / tck) if refresh_on else 0
        self.c_rfc = math.ceil(t.tRFC_ns / tck) if refresh_on else 0
        if self.c_refi and self.c_rfc >= self.c_refi:
            raise ValueError(
                f"tRFC ({t.tRFC_ns} ns) must be shorter than tREFI "
                f"({t.tREFI_ns} ns) — the bank would never leave refresh")
        if t.desync_policy not in ("desync", "lockstep"):
            raise ValueError(f"unknown desync policy {t.desync_policy!r} "
                             "(expected 'desync' or 'lockstep')")
        if t.replay_engine not in ("vectorized", "stepped"):
            raise ValueError(f"unknown replay engine {t.replay_engine!r} "
                             "(expected 'vectorized' or 'stepped')")
        # every scalar a ReplayResult depends on besides the trace/banks/
        # offsets/phase — the timing part of the TraceCache memo key (the
        # analytic baseline uses the raw ns values, hence both forms)
        self._sig = (tck, t.tRAS_ns, t.tRP_ns, self.c_rrd, self.c_faw,
                     self.c_refi, self.c_rfc)

    def _rank(self, coupled: bool, phase: int = 0) -> _RankState:
        return _RankState(self.c_rrd if coupled else 0,
                          self.c_faw if coupled else 0,
                          self.c_refi, self.c_rfc, phase=phase)

    def replay(self, trace, banks: int = 1, offsets_ns=None,
               policy: str | None = None, refresh_phase_ns: float = 0.0,
               engine: str | None = None, cache=None) -> ReplayResult:
        """Replay ``trace`` on ``banks`` per-bank FSMs.

        ``offsets_ns`` optionally gives each bank's issue offset (bank *k*'s
        stream may not start before ``offsets_ns[k]``); ``policy`` overrides
        the timing's ``desync_policy`` for this replay.  Refresh windows are
        anchored ``refresh_phase_ns`` after the previous refresh epoch —
        with the default 0, each op replays standalone from t=0, so only
        ops that individually span a tREFI interval accrue refresh stall;
        a replay-mode :class:`~repro_torch.core.backends.PerfStats` built with
        ``refresh_phase=True`` threads its accumulated pipeline clock
        through here instead, so refresh bites across op boundaries.

        ``engine`` overrides the timing's ``replay_engine`` for this call;
        ``cache`` optionally names a :class:`~repro_torch.core.trace.TraceCache`
        whose replay memo serves warm replays as a table lookup, keyed by
        ``(trace.fingerprint, banks, offsets, refresh-phase bucket,
        policy, engine, timing signature)``.
        """
        policy = policy or self.timing.desync_policy
        if policy not in ("desync", "lockstep"):
            raise ValueError(f"unknown desync policy {policy!r}")
        engine = engine or self.timing.replay_engine
        if engine not in ("vectorized", "stepped"):
            raise ValueError(f"unknown replay engine {engine!r}")
        banks = max(1, int(banks))
        tck = self.timing.tCK_ns
        if trace.seqs.shape[0] == 0:
            return ReplayResult(ns=0.0, stall_ns=0.0, cycles=0, n_seqs=0,
                                n_acts=0, banks=banks)
        if offsets_ns is not None and len(offsets_ns) != banks:
            raise ValueError(f"{len(offsets_ns)} issue offsets for "
                             f"{banks} banks")
        lockstep = policy == "lockstep"
        if lockstep:
            # legacy broadcast: one FSM stands in for every bank (banks
            # mirror for free — no tRRD/tFAW coupling, offsets ignored)
            offsets = [0]
        else:
            offsets = [0] * banks if offsets_ns is None else \
                [math.ceil(o / tck) for o in offsets_ns]
        ref_phase = 0
        if self.c_refi and refresh_phase_ns:
            ref_phase = math.ceil(refresh_phase_ns / tck) % self.c_refi
        key = None
        if cache is not None:
            key = (trace.fingerprint, banks, tuple(offsets), ref_phase,
                   policy, engine, self._sig)
            hit = cache.replay_get(key)
            if hit is not None:
                return hit
        res = None
        if engine == "vectorized":
            res = self._replay_vectorized(trace, banks, offsets, lockstep,
                                          ref_phase)
        if res is None:
            res = self._replay_stepped(trace, banks, offsets, lockstep,
                                       ref_phase)
        if key is not None:
            cache.replay_put(key, res)
        return res

    # -- stepped engine: the per-edge FSM oracle -----------------------------

    def _replay_stepped(self, trace, banks: int, offsets: list,
                        lockstep: bool, ref_phase: int) -> ReplayResult:
        kinds = trace.seqs[:, 0].tolist()
        tck = self.timing.tCK_ns
        n_banks = len(offsets)
        rank = self._rank(coupled=not lockstep, phase=ref_phase)
        c_ras, c_rp, c_rc = self.c_ras, self.c_rp, self.c_rc
        n_seq = len(kinds)
        # per-bank FSM state (the bank powers up idle and precharged)
        now = list(offsets)
        last_act = [o - c_rc for o in offsets]
        last_pre = [o - c_rp for o in offsets]
        seq_i = [0] * n_banks
        phase = [0] * n_banks            # 1 = second ACT of an AAP pending
        finish = [0] * n_banks
        n_acts = 0
        pending = n_banks
        while pending:
            # next activation: the bank whose FSM is locally ready first
            best_k = -1
            best_t = 0
            for k in range(n_banks):
                if seq_i[k] >= n_seq:
                    continue
                if phase[k]:
                    t = last_act[k] + c_ras
                else:
                    t = max(now[k], last_pre[k] + c_rp, last_act[k] + c_rc)
                if best_k < 0 or t < best_t:
                    best_k, best_t = k, t
            k = best_k
            t = rank.constrain(best_t)
            rank.record(t)
            last_act[k] = t
            n_acts += 1
            if phase[k] == 0 and kinds[seq_i[k]] != SEQ_AP:
                phase[k] = 1              # AAP / Case-2: back-to-back ACT
            else:
                pre = t + c_ras           # sequence retires with a PRECHARGE
                last_pre[k] = pre
                now[k] = pre
                phase[k] = 0
                seq_i[k] += 1
                if seq_i[k] == n_seq:
                    # the final precharge must complete before the op retires
                    finish[k] = pre + c_rp
                    pending -= 1
        return self._package(trace, banks, lockstep, max(finish),
                             min(finish), n_acts * (banks if lockstep else 1),
                             rank.tfaw_stall, rank.refresh_stall,
                             rank.n_refresh_stalls)

    # -- vectorized engine: prefix-scan fixpoint over cycle arrays -----------

    def _refresh_jump(self, t: np.ndarray, ref_phase: int) -> np.ndarray:
        """Vectorized :meth:`_RankState.constrain_refresh`: every element
        inside a refresh window jumps to that window's end (the least
        stable cycle ≥ t), elements outside pass through unchanged."""
        if not self.c_refi:
            return t
        ta = t + ref_phase
        k = ta // self.c_refi
        in_win = (((k >= 1) | (ref_phase > 0))
                  & (ta < k * self.c_refi + self.c_rfc))
        return np.where(in_win, k * self.c_refi + self.c_rfc - ref_phase, t)

    def _iter_cap(self, horizon: int) -> int:
        """Fixpoint-iteration budget: each sweep resolves at least the
        earliest unresolved refresh-window crossing, so the window count
        over the (stall-inflated) schedule horizon bounds the iterations
        needed; headroom on top, and the caller falls back to the stepped
        oracle if the budget is ever exhausted."""
        if not self.c_refi:
            return self._BASE_ITERS
        slack = max(1, self.c_refi - self.c_rfc)
        return self._BASE_ITERS + 4 * (int(horizon) // slack + 1)

    def _solve_chains(self, gaps: np.ndarray, offs: np.ndarray,
                      ref_phase: int):
        """Exact schedule for rank-uncoupled streams (no tRRD/tFAW): each
        bank is an independent ready chain ``r_i = jump(r_{i-1} + g_i)``,
        solved for all banks at once by alternating the refresh jump with
        a cummax chain closure until fixpoint.  Returns ``(R, tfaw=0,
        refresh_stall, n_refresh)`` with R of shape (banks, n_acts), or
        None if the iteration budget runs out."""
        cum = np.cumsum(gaps)
        base = offs[:, None] + cum[None, :]
        R = base
        for _ in range(self._iter_cap(int(base.max()))):
            j = self._refresh_jump(R, ref_phase)
            nxt = np.maximum.accumulate(j - cum[None, :], axis=1) \
                + cum[None, :]
            if np.array_equal(nxt, R):
                break
            R = nxt
        else:
            return None
        # stall attribution: re-derive each ACT's pre-refresh candidate
        # from its predecessor and meter the jumps, as the FSM does
        cand = np.empty_like(R)
        cand[:, 0] = offs
        cand[:, 1:] = R[:, :-1] + gaps[1:][None, :]
        j = self._refresh_jump(cand, ref_phase)
        if not np.array_equal(j, R):
            return None
        return R, 0, int((j - cand).sum()), int((j > cand).sum())

    def _solve_coupled(self, gaps: np.ndarray, offs: np.ndarray,
                       ref_phase: int, rrd: int, faw: int):
        """Exact schedule for rank-coupled per-bank streams.

        The FSM arbitrates by *local* readiness: the next ACT issued is
        the head with the least per-bank ready time (ties to the lowest
        bank).  Per-bank ready times are nondecreasing along each bank's
        own stream, so that arbitration order is exactly the k-way merge
        of the per-bank ready chains — i.e. the lexicographic sort of
        ``(ready, bank, position)``.  Along a *known* issue order π the
        issue times are the least fixpoint of monotone constraints

            r_{π(n)} = jump(max(l_{π(n)}, r_{π(n-1)} + tRRD,
                                r_{π(n-4)} + tFAW))

        (``l`` the per-bank gap chain, ``jump`` the refresh deferral),
        solved by Kleene-iterating four cummax/pointwise closures: the
        tRRD chain (one prefix cummax over the permuted order), the tFAW
        chain (four strided cummaxes, one per ``n mod 4`` residue), the
        refresh jump, and the per-bank gap chains.  The order itself is
        the outer fixpoint: solve under a candidate π, re-derive the
        ready times, re-sort; when the sort reproduces π, the candidate
        provably equals the FSM's arbitration and the times are exact.
        Each round certifies at least one more position of the final
        order (the common prefix of candidate and re-sort, plus the
        divergence point itself, is already the FSM's order), so the
        loop converges — but refresh windows must be order-resolved
        front to back, so the round count scales with the number of
        windows the schedule crosses.  Refresh-dominated schedules
        (``> _MAX_WINDOWS`` windows), a non-converging fixpoint, or an
        exhausted budget return None and the caller steps the oracle —
        this path is exact-or-absent, never approximate.  Returns
        ``(R, tfaw_stall, refresh_stall, n_refresh)`` with R of shape
        (n_acts, banks)."""
        a = len(gaps)
        b = len(offs)
        n = a * b
        cum = np.cumsum(gaps)
        base = offs[None, :] + cum[:, None]                    # (a, b)
        idx = np.arange(n, dtype=np.int64)
        k_flat = idx % b
        i_flat = idx // b
        rrd_ramp = idx * rrd
        faw_ramp = np.arange((n + 3) // 4, dtype=np.int64) * faw
        # the schedule horizon includes the rank serializers: n ACTs
        # cannot issue faster than one per tRRD nor four per tFAW
        horizon = int(base.max())
        if rrd:
            horizon = max(horizon, n * rrd)
        if faw:
            horizon = max(horizon, ((n + 3) // 4) * faw)
        windows = 0
        if self.c_refi:
            windows = horizon // max(1, self.c_refi - self.c_rfc) + 1
            if windows > self._MAX_WINDOWS:
                return None
        # chain↔window alternation can propagate as slowly as a few
        # positions per sweep, so the sweep budget scales with n; a sweep
        # costs about as much as stepping two ACTs, so the worst wasted
        # attempt stays well under one stepped replay.  The budget is
        # global across order rounds — prefix freezing (below) makes the
        # total suffix work amortize to roughly one full solve.
        budget = max(self._BASE_ITERS + 4 * windows, n // 4)
        outer_cap = 32 + 4 * windows

        def local_ready(r):
            ready = np.empty_like(r)
            ready[0, :] = offs
            ready[1:, :] = r[:-1, :] + gaps[1:, None]
            return ready

        def order_of(r):
            # arbitration order: by per-bank ready time, ties to the
            # lowest bank, then stream position (same-bank "ties" are
            # just the bank's own program order)
            return np.lexsort((i_flat, k_flat,
                               local_ready(r).reshape(-1)))

        def solve(perm, r):
            # Kleene iteration from below: each sweep applies the four
            # monotone closures once; a sweep that changes nothing means
            # the least fixpoint under this order has been reached
            nonlocal budget
            while budget > 0:
                budget -= 1
                prev = r
                flat = r.reshape(-1)[perm]
                if rrd:
                    flat = np.maximum.accumulate(flat - rrd_ramp) + rrd_ramp
                if faw:
                    for rho in range(min(4, n)):
                        s = flat[rho::4]
                        ramp = faw_ramp[:len(s)]
                        flat[rho::4] = np.maximum.accumulate(s - ramp) + ramp
                flat = self._refresh_jump(flat, ref_phase)
                nxt = np.empty(n, np.int64)
                nxt[perm] = flat
                r = nxt.reshape(a, b)
                r = np.maximum.accumulate(r - cum[:, None], axis=0) \
                    + cum[:, None]
                if np.array_equal(r, prev):
                    return r
            return None

        perm = order_of(base)
        r0 = base
        for j in range(outer_cap):         # outer: the issue-order fixpoint
            r = solve(perm, r0)
            if r is None:
                return None
            nperm = order_of(r)
            neq = np.nonzero(nperm != perm)[0]
            if neq.size == 0:
                break
            # the common prefix of the candidate and the re-derived order
            # already matches the FSM's arbitration, so those issue times
            # are final: freeze them and re-solve only the suffix from
            # below under the corrected order (the divergence point
            # itself is also certified, so each round makes progress)
            d = int(neq[0])
            if j >= 8 and d * outer_cap < n * (j + 1):
                # projecting the certified-prefix growth rate to the round
                # cap falls short of n — e.g. scrambled issue offsets that
                # deviate from every candidate roughly once per bank-round
                # — so bail out before burning the whole sweep budget
                return None
            perm = nperm
            r0 = base.copy()
            r0.reshape(-1)[perm[:d]] = r.reshape(-1)[perm[:d]]
        else:
            return None
        # stall attribution along the verified issue order, mirroring the
        # FSM's metering: the tFAW deferral is measured after the tRRD
        # floor, refresh jumps are measured last.  The tFAW gate reads the
        # 4th-latest issued ACT, which is position n-4 only on a monotone
        # schedule — guaranteed by the tRRD chain, verified anyway.
        flat_r = r.reshape(-1)[perm]
        if np.any(np.diff(flat_r) < 0):
            return None
        t = local_ready(r).reshape(-1)[perm]
        if rrd:
            t[1:] = np.maximum(t[1:], flat_r[:-1] + rrd)
        tfaw_stall = 0
        if faw and n > 4:
            gate = flat_r[:-4] + faw
            tfaw_stall = int(np.maximum(gate - t[4:], 0).sum())
            t[4:] = np.maximum(t[4:], gate)
        j = self._refresh_jump(t, ref_phase)
        if not np.array_equal(j, flat_r):
            return None
        return r, tfaw_stall, int((j - t).sum()), int((j > t).sum())

    def _replay_vectorized(self, trace, banks: int, offsets: list,
                           lockstep: bool, ref_phase: int
                           ) -> ReplayResult | None:
        """Closed-form replay of ``trace``; None where only the stepped
        oracle is exact (the dispatcher falls back)."""
        codes = trace.act_structure()
        a = len(codes)
        gap_of = np.zeros(3, np.int64)
        gap_of[ACT_GAP_START] = 0
        gap_of[ACT_GAP_RAS] = self.c_ras
        gap_of[ACT_GAP_RC] = self.c_rc
        gaps = gap_of[codes]
        offs = np.asarray(offsets, np.int64)
        rrd = 0 if lockstep else self.c_rrd
        faw = 0 if lockstep else self.c_faw
        if rrd == 0 and faw == 0:
            solved = self._solve_chains(gaps, offs, ref_phase)
            if solved is None:
                return None
            R, tfaw_stall, refresh_stall, n_refresh = solved
            finish = R[:, -1] + self.c_rc
        else:
            if len(offs) > 1 and rrd == 0:
                # a four-activate window without the tRRD serializer that
                # keeps issue order monotone has no provable closed-form
                # arbitration order — stepped is forced (see README)
                return None
            solved = self._solve_coupled(gaps, offs, ref_phase, rrd, faw)
            if solved is None:
                return None
            R, tfaw_stall, refresh_stall, n_refresh = solved
            finish = R[-1, :] + self.c_rc
        n_acts = a * banks
        return self._package(trace, banks, lockstep, int(finish.max()),
                             int(finish.min()), n_acts, tfaw_stall,
                             refresh_stall, n_refresh)

    def _package(self, trace, banks: int, lockstep: bool, cycles: int,
                 min_cycles: int, n_acts: int, tfaw_stall: int,
                 refresh_stall: int, n_refresh_stalls: int) -> ReplayResult:
        tck = self.timing.tCK_ns
        ns = cycles * tck
        mix = trace.command_mix()
        analytic = (mix["AAP"] * self.timing.t_aap_ns
                    + mix["AP"] * self.timing.t_ap_ns)
        return ReplayResult(
            ns=ns, stall_ns=max(0.0, ns - analytic), cycles=cycles,
            n_seqs=trace.seqs.shape[0] * banks, n_acts=n_acts,
            banks=banks, max_bank_ns=ns, min_bank_ns=min_cycles * tck,
            tfaw_stall_ns=tfaw_stall * tck,
            refresh_stall_ns=refresh_stall * tck,
            n_refresh_stalls=n_refresh_stalls)


class SimdramPerfModel:
    """Throughput / energy for a compiled μProgram (the paper's Fig. 9/10)."""

    def __init__(self, timing: DRAMTiming | None = None,
                 energy: DRAMEnergy | None = None,
                 baseline: BaselineModel | None = None,
                 movement: MovementModel | None = None,
                 transposition: TranspositionModel | None = None,
                 replay: TraceReplayTiming | None = None) -> None:
        self.timing = timing or DRAMTiming()
        self.energy = energy or DRAMEnergy()
        self.baseline = baseline or BaselineModel()
        self.movement = movement or MovementModel()
        self.transposition = transposition or TranspositionModel()
        self.replay_timing = replay or TraceReplayTiming(self.timing)

    def replay_result(self, trace, banks: int = 1, offsets_ns=None,
                      refresh_phase_ns: float = 0.0, engine: str | None = None,
                      cache=None) -> ReplayResult:
        """Replay a lowered trace on the per-bank FSM array (measured-style
        latency, tFAW/refresh windows, optional per-bank issue offsets and
        cross-op refresh phase).  ``engine`` overrides the timing's
        ``replay_engine``; ``cache`` (a TraceCache) memoizes the closed-form
        result so warm replays are a table lookup."""
        return self.replay_timing.replay(trace, banks=banks,
                                         offsets_ns=offsets_ns,
                                         refresh_phase_ns=refresh_phase_ns,
                                         engine=engine, cache=cache)

    def replay_latency_ns(self, trace, banks: int = 1) -> float:
        return self.replay_result(trace, banks=banks).ns

    def replay_energy_nj(self, prog: UProgram, trace, banks: int = 1,
                         result: ReplayResult | None = None) -> float:
        """Replayed energy: the activation energy is fixed by the command
        mix (identical to the analytic model, × banks), but stall cycles
        still burn per-bank background/peripheral power — so replayed nJ ≥
        analytic nJ by exactly ``banks × background_w × stall_ns``.  This is
        the single source of truth for the formula:
        ``PerfStats.charge_program`` calls it (passing its memoized
        ``result``) instead of re-deriving it inline."""
        if result is None:
            result = self.replay_result(trace, banks=banks)
        return (self.energy_nj(prog)
                + self.energy.background_w * result.stall_ns) * banks

    def latency_ns(self, prog: UProgram) -> float:
        mix = prog.command_mix()
        t = self.timing
        return mix["AAP"] * t.t_aap_ns + mix["AP"] * t.t_ap_ns

    def throughput_gops(self, prog: UProgram, banks: int = 1) -> float:
        """Elements per second (×1e-9): one row of SIMD lanes per bank per
        μProgram execution; banks operate in parallel (§6)."""
        lanes = self.timing.row_bits
        return lanes * banks / self.latency_ns(prog)

    def energy_nj(self, prog: UProgram) -> float:
        mix = prog.command_mix()
        e = self.energy
        # an AAP whose source activation is a TRA pays the TRA penalty too
        extra_tra = mix["TRA"] - mix["AP"]
        return (mix["AAP"] * e.e_aap_nj() + mix["AP"] * e.e_ap_nj()
                + extra_tra * e.e_act_nj * 2 * e.tra_row_penalty)

    def power_w(self, prog: UProgram, banks: int = 1) -> float:
        return (self.energy_nj(prog) / self.latency_ns(prog)
                + self.energy.background_w) * banks

    def throughput_per_watt(self, prog: UProgram, banks: int = 1) -> float:
        return self.throughput_gops(prog, banks) / self.power_w(prog, banks)

    # -- baselines ----------------------------------------------------------
    def cpu_gops(self, op: str, n_bits: int) -> float:
        return self.baseline.throughput_gops(op, n_bits, gpu=False)

    def gpu_gops(self, op: str, n_bits: int) -> float:
        return self.baseline.throughput_gops(op, n_bits, gpu=True)

    def cpu_gops_per_watt(self, op: str, n_bits: int) -> float:
        return self.cpu_gops(op, n_bits) / self.baseline.power_w(False)

    def gpu_gops_per_watt(self, op: str, n_bits: int) -> float:
        return self.gpu_gops(op, n_bits) / self.baseline.power_w(True)
