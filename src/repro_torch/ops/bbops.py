"""bbop_* — array-level SIMDRAM operations (paper Table 1 ISA extensions).

Each ``bbop_<op>(dst ← srcs)`` mirrors one CPU ISA extension from the paper.
Two operand forms are accepted everywhere:

* **horizontal** tensor or array (compat path): operands are placed on the
  ambient machine's device and transposed to the
  vertical layout (the transposition unit, §5.1), the compiled μProgram is
  executed over the bit-planes (Step 3), and results are transposed back —
  one conversion round-trip *per op*.
* **plane-resident** :class:`~repro_torch.simdram.layout.BitplaneArray` (fused
  path): planes in, planes out, zero transposition-unit traffic.  Chained
  ops stay vertical end-to-end, exactly like the paper's Steps 1–3 that only
  pay layout conversion at the memory boundary.

``simdram_pipeline`` is the ergonomic wrapper for the fused path: it loads
operands vertical in one batched transposition pass, keeps every
intermediate plane-resident, and stores results back horizontal in one pass.

Execution dispatches through the backend registry
(:mod:`repro_torch.core.backends`): ``kernel`` (the Fig.-7 control-unit
FSM kernel, default), ``unrolled`` (eager bitwise torch over the planes),
``reference`` (the numpy ``Subarray`` oracle).
Select per call (``backend="reference"``), per scope
(``with use_backend(...)``), or process-wide (``set_default_backend``).
μPrograms are compiled once per (operation, element-width) and cached — the
paper's μProgram Memory/Scratchpad behavior.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..core.backends import (PerfStats, execute_lowered,  # noqa: F401
                             execute_program, list_backends,
                             set_default_backend, use_backend)
from ..core.backends import timed as timed_execution
from ..core.trace import compile_chain_trace, compile_trace
from ..core.uprogram import UProgram
from ..simdram.layout import (LANE_WORD, BitplaneArray, as_tensor,
                              from_bitplanes, note_elided_movement,
                              to_bitplanes)
from ..simdram.machine import current_machine, default_machine


def _device(machine=None) -> torch.device:
    """Where horizontal operands go: the given machine's device, else the
    innermost open session's, else the default machine's (``"cuda"``)."""
    m = machine if machine is not None else current_machine()
    return (m if m is not None else default_machine()).device


def compile_bbop(name: str, n_bits: int, optimize: bool = True) -> UProgram:
    """The μProgram Scratchpad: compile + lower once, reuse (paper Fig. 7).

    Backed by the ambient machine's μProgram Memory: the current session
    machine's when one is in scope (``with machine.session():`` / a
    machine pipeline), otherwise the process-wide compile/lower cache in
    :mod:`repro_torch.core.trace` (the default machine's) — chained ``bbop_*``
    calls, pipelines and ``greedy_decode`` all fetch the same finished
    (μProgram, :class:`~repro_torch.core.trace.LoweredTrace`) pair instead of
    re-running synthesis + row allocation per call.
    """
    m = current_machine()
    if m is not None:
        return m.memory.get(name, n_bits, optimize)[0]
    return compile_trace(name, n_bits, optimize)[0]


def planes_of(x, n_bits: int) -> tuple[torch.Tensor, int]:
    """Pad to a lane multiple of 32 and transpose to bit-planes."""
    x = as_tensor(x, _device())
    (e,) = x.shape
    pad = (-e) % LANE_WORD
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    return to_bitplanes(x, n_bits), e


def values_of(planes: torch.Tensor, n: int,
              signed: bool = False) -> torch.Tensor:
    return from_bitplanes(planes, signed=signed)[:n]


# ---------------------------------------------------------------------------
# Operand coercion / op core
# ---------------------------------------------------------------------------


def _as_planes(x, n_bits: int, machine=None) -> tuple[BitplaneArray, bool]:
    """(plane-resident operand, was-already-vertical)."""
    if isinstance(x, _ChainValue):
        if x.rec is _current_fusion() and x.n_bits == n_bits:
            return x, True          # stays lazy inside its own fusion scope
        x = x.materialize()
    if isinstance(x, BitplaneArray):
        if x.n_bits != n_bits:
            raise ValueError(f"operand is {x.n_bits}-bit, op wants {n_bits}")
        return x, True
    return BitplaneArray.from_values(as_tensor(x, _device(machine)),
                                     n_bits), False


def _check_banks(ops: list[BitplaneArray]) -> None:
    banks = {o.n_banks for o in ops}
    bankednesses = {o.banked for o in ops}
    if len(banks) > 1 or len(bankednesses) > 1:
        raise ValueError(f"operand bank shapes disagree: "
                         f"{[o.planes.shape for o in ops]}")
    if len({(o.length, o.words) for o in ops}) > 1:
        # same padded width but different logical lengths would silently
        # compute against the shorter operand's zero padding
        raise ValueError(
            f"operand lengths disagree: "
            f"{[(o.length, o.words * LANE_WORD) for o in ops]}")


def _run_op(name: str, operands: dict[str, BitplaneArray], n_bits: int,
            signed_out: bool = False, out_bits: int | None = None,
            optimize: bool = True, backend: str | None = None,
            keep_planes: bool = False, machine=None, compiled=None):
    """Compile-or-fetch + dispatch; returns planes or horizontal values.

    ``machine`` (explicit, or the innermost open machine session) routes
    the call through that machine's μProgram Memory and default backend;
    otherwise the process-wide cache and backend default apply (the
    default machine's configuration).  ``compiled`` short-circuits the
    cache with an already-fetched ``(UProgram, LoweredTrace)`` pair
    (bound ops pass theirs through so each call counts one cache access).
    """
    ops = list(operands.values())
    _check_banks(ops)
    rec = _current_fusion()
    if (rec is not None and keep_planes and compiled is None
            and out_bits is None and machine is None and backend is None
            and all(isinstance(v, (BitplaneArray, _ChainValue))
                    for v in operands.values())):
        # fused-trace pipeline: record the op instead of executing it —
        # the whole chain compiles to ONE LoweredTrace at flush time
        return rec.record(name, operands, n_bits, signed_out, optimize)
    operands = {k: (v.materialize() if isinstance(v, _ChainValue) else v)
                for k, v in operands.items()}
    ops = list(operands.values())
    m = machine if machine is not None else current_machine()
    if m is not None:
        prog, trace = compiled or m.memory.get(name, n_bits, optimize)
        backend = backend or m.backend
    else:
        prog, trace = compiled or compile_trace(name, n_bits, optimize)
    outs = execute_lowered(
        prog, trace, {k: v.planes for k, v in operands.items()},
        out_bits={prog.outputs[0]: out_bits} if out_bits else None,
        backend=backend, machine=m)
    first = ops[0]
    res = BitplaneArray(outs[prog.outputs[0]], out_bits or n_bits,
                        first.length, signed_out)
    if keep_planes:
        return res
    return res.to_values()


def _fused(*xs) -> bool:
    return any(isinstance(x, (BitplaneArray, _ChainValue)) for x in xs)


def _binary(name: str, a, b, n_bits: int, signed_out: bool = False,
            out_bits: int | None = None, optimize: bool = True,
            backend: str | None = None, machine=None):
    keep = _fused(a, b)
    pa, _ = _as_planes(a, n_bits, machine)
    pb, _ = _as_planes(b, n_bits, machine)
    return _run_op(name, {"a": pa, "b": pb}, n_bits, signed_out=signed_out,
                   out_bits=out_bits, optimize=optimize, backend=backend,
                   keep_planes=keep, machine=machine)


def _unary(name: str, a, n_bits: int, out_bits: int | None = None,
           optimize: bool = True, backend: str | None = None, machine=None):
    keep = _fused(a)
    pa, _ = _as_planes(a, n_bits, machine)
    return _run_op(name, {"a": pa}, n_bits, out_bits=out_bits,
                   optimize=optimize, backend=backend, keep_planes=keep,
                   machine=machine)


def _flip_msb(x, n_bits: int):
    if isinstance(x, BitplaneArray):
        return x.flip_msb()
    return x ^ (1 << (n_bits - 1))


# -- 2-input operations (bbop_op dst, src_1, src_2, size, n) -----------------

def bbop_add(a, b, n_bits: int = 8, **kw):
    return _binary("addition", a, b, n_bits, **kw)


def bbop_sub(a, b, n_bits: int = 8, **kw):
    return _binary("subtraction", a, b, n_bits, **kw)


def bbop_mul(a, b, n_bits: int = 8, **kw):
    return _binary("multiplication", a, b, n_bits, **kw)


def bbop_div(a, b, n_bits: int = 8, **kw):
    return _binary("division", a, b, n_bits, **kw)


def bbop_greater(a, b, n_bits: int = 8, signed: bool = False, **kw):
    if signed:
        a, b = _flip_msb(a, n_bits), _flip_msb(b, n_bits)
    return _binary("greater", a, b, n_bits, out_bits=1, **kw)


def bbop_greater_equal(a, b, n_bits: int = 8, signed: bool = False, **kw):
    if signed:
        a, b = _flip_msb(a, n_bits), _flip_msb(b, n_bits)
    return _binary("greater_equal", a, b, n_bits, out_bits=1, **kw)


def bbop_equal(a, b, n_bits: int = 8, **kw):
    return _binary("equal", a, b, n_bits, out_bits=1, **kw)


def bbop_max(a, b, n_bits: int = 8, signed: bool = False, **kw):
    if signed:
        sel = bbop_greater(a, b, n_bits, signed=True, **kw)
        return bbop_if_else(sel, a, b, n_bits, **kw)
    return _binary("maximum", a, b, n_bits, **kw)


def bbop_min(a, b, n_bits: int = 8, signed: bool = False, **kw):
    if signed:
        sel = bbop_greater(b, a, n_bits, signed=True, **kw)
        return bbop_if_else(sel, a, b, n_bits, **kw)
    return _binary("minimum", a, b, n_bits, **kw)


# -- 1-input operations -------------------------------------------------------

def bbop_relu(a, n_bits: int = 8, **kw):
    return _unary("relu", a, n_bits, **kw)


def bbop_abs(a, n_bits: int = 8, **kw):
    return _unary("abs", a, n_bits, **kw)


def bbop_bitcount(a, n_bits: int = 8, **kw):
    return _unary("bitcount", a, n_bits, out_bits=n_bits.bit_length(), **kw)


# -- N-input reductions (paper: Y = src(1) ∘ src(2) ∘ src(3)) ----------------

def _reduction(name: str, srcs, n_bits: int, optimize: bool = True,
               backend: str | None = None, machine=None):
    assert len(srcs) == 3, "the compiled reduction μPrograms are 3-input"
    keep = _fused(*srcs)
    operands = {f"s{k}": _as_planes(s, n_bits, machine)[0]
                for k, s in enumerate(srcs)}
    return _run_op(name, operands, n_bits, optimize=optimize,
                   backend=backend, keep_planes=keep, machine=machine)


def bbop_and(srcs, n_bits: int = 8, **kw):
    return _reduction("and_reduction", srcs, n_bits, **kw)


def bbop_or(srcs, n_bits: int = 8, **kw):
    return _reduction("or_reduction", srcs, n_bits, **kw)


def bbop_xor(srcs, n_bits: int = 8, **kw):
    return _reduction("xor_reduction", srcs, n_bits, **kw)


# -- predication (bbop_if_else dst, src_1, src_2, select, size, n) ------------

def bbop_if_else(sel, a, b, n_bits: int = 8, optimize: bool = True,
                 backend: str | None = None, machine=None):
    keep = _fused(sel, a, b)
    pa, _ = _as_planes(a, n_bits, machine)
    pb, _ = _as_planes(b, n_bits, machine)
    if isinstance(sel, _ChainValue):
        sel = sel.materialize()
    if isinstance(sel, BitplaneArray):
        ps = sel if sel.n_bits == 1 else sel.astype_bits(1)
    else:
        ps, _ = _as_planes(as_tensor(sel, _device(machine)).to(torch.int32),
                           1, machine)
    return _run_op("if_else", {"a": pa, "b": pb, "sel": ps}, n_bits,
                   optimize=optimize, backend=backend, keep_planes=keep,
                   machine=machine)


# ---------------------------------------------------------------------------
# Cross-op trace fusion (lazy recording inside simdram_pipeline)
# ---------------------------------------------------------------------------

# per-thread stack of active fusion recorders — innermost
# ``simdram_pipeline(fused_trace=True)`` scope records the bbops run in it
_FUSION = threading.local()


def _fusion_stack() -> list:
    st = getattr(_FUSION, "stack", None)
    if st is None:
        st = _FUSION.stack = []
    return st


def _current_fusion():
    st = _fusion_stack()
    return st[-1] if st else None


class _ChainValue:
    """The lazy output of an op recorded into a fused-trace pipeline.

    Stands in for a :class:`BitplaneArray` inside its own fusion scope
    (same layout metadata, so bank/length checks work unchanged) without
    holding planes: the planes exist only after the recorder flushes the
    whole chain as ONE fused :class:`~repro_torch.core.trace.LoweredTrace`.
    Leaving the scope — or any eager consumption (``store``, an
    unfusible op, a different pipeline) — triggers the flush."""

    def __init__(self, rec, op: str, operands: dict, n_bits: int,
                 signed: bool) -> None:
        self.rec = rec
        self.op = op
        self.operands = operands        # input name → BitplaneArray | lazy
        self.n_bits = n_bits
        self.signed = signed
        self.name = f"v{rec.counter}"
        rec.counter += 1
        self._planes = None
        probe = next(iter(operands.values()))
        self.length = probe.length
        self.words = probe.words
        self.banked = probe.banked
        self.n_banks = probe.n_banks

    def materialize(self) -> BitplaneArray:
        """Planes-in-hand value (flushes the pending chain if needed)."""
        if self._planes is None:
            self.rec.flush()
        return BitplaneArray(self._planes, self.n_bits, self.length,
                             self.signed)

    @property
    def planes(self):
        return self.materialize().planes

    def to_values(self, dtype=torch.int32) -> torch.Tensor:
        return self.materialize().to_values(dtype)


class _FusionRecorder:
    """Accumulates recorded ops and flushes them as one fused trace."""

    def __init__(self, pipe) -> None:
        self.pipe = pipe
        self.pending: list[_ChainValue] = []
        self.counter = 0
        self.n_bits: int | None = None
        self.optimize: bool | None = None
        self.machine = None             # captured at pipeline __enter__

    def record(self, op: str, operands: dict, n_bits: int, signed: bool,
               optimize: bool) -> _ChainValue:
        if self.pending and (self.n_bits != n_bits
                             or self.optimize != optimize):
            # a chain compiles at one element width / one optimize level;
            # a switch seals the pending chain and starts a new one
            self.flush()
        self.n_bits, self.optimize = n_bits, optimize
        w = _ChainValue(self, op, dict(operands), n_bits, signed)
        self.pending.append(w)
        return w

    def _fetch_prog(self, op: str, n_bits: int, optimize: bool):
        if self.machine is not None:
            return self.machine.memory.get(op, n_bits, optimize)[0]
        return compile_trace(op, n_bits, optimize)[0]

    def flush(self) -> None:
        """Compile the pending ops to ONE fused trace and execute it.

        External operands (loaded planes, prior flushes' outputs) become
        the chain's inputs, deduplicated by plane identity; every pending
        value is a chain output (the user may store any of them).  Each
        chain-internal operand reference is an inter-op relocation the
        fused allocator elided — noted (never charged) through the
        movement hooks so snapshots prove the hop delta."""
        pending = [w for w in self.pending if w._planes is None]
        self.pending = []
        if not pending:
            return
        n_bits, optimize = self.n_bits, self.optimize
        m = self.machine
        ext: dict[int, tuple[str, object]] = {}   # id(planes) → (name, pl)

        def ext_name(bpa: BitplaneArray) -> str:
            key = id(bpa.planes)
            hit = ext.get(key)
            if hit is None:
                hit = (f"in{len(ext)}", bpa.planes)
                ext[key] = hit
            return hit[0]

        stages = []
        n_internal_refs = 0
        for w in pending:
            prog = self._fetch_prog(w.op, n_bits, optimize)
            names = tuple(dict.fromkeys(prog.inputs))
            ins = []
            for nm in names:
                o = w.operands[nm]
                if isinstance(o, _ChainValue) and o.rec is self \
                        and o._planes is None:
                    ins.append(o.name)
                    n_internal_refs += 1
                else:
                    if isinstance(o, _ChainValue):
                        o = o.materialize()
                    ins.append(ext_name(o))
            stages.append((w.op, tuple(ins), w.name))
        out_names = tuple(w.name for w in pending)
        if m is not None:
            prog, trace = m.memory.get_chain(stages, n_bits, optimize,
                                             outputs=out_names)
        else:
            prog, trace = compile_chain_trace(stages, n_bits, optimize,
                                              outputs=out_names)
        outs = execute_lowered(
            prog, trace, {name: pl for name, pl in ext.values()},
            backend=self.pipe.backend, machine=m)
        for w in pending:
            w._planes = outs[w.name]
        for _ in range(n_internal_refs):
            note_elided_movement(n_bits)


# ---------------------------------------------------------------------------
# Plane-resident pipelines
# ---------------------------------------------------------------------------


class simdram_pipeline(contextlib.AbstractContextManager):
    """Keep a chain of bbops vertical end-to-end.

    ::

        with simdram_pipeline(backend="kernel") as p:
            a, b, c = p.load([av, bv, cv], n_bits=8)
            out = bbop_relu(bbop_add(bbop_mul(a, b, 8), c, 8), 8)
            result = p.store(out)

    ``load`` transposes all operands in ONE pass of the transposition unit
    (operands are stacked along the lane axis, like the hardware streaming a
    block through the unit); every intermediate stays a
    :class:`BitplaneArray`; ``store`` pays the single reverse pass.  The
    scope also pins the execution backend for every op inside it.

    ``timed=True`` (or passing ``perf_stats``/``perf_model``) runs the chain
    under the timed execution layer: every op charges its modeled μProgram
    latency/energy, every inter-op operand relocation its MovementModel
    cost, and the load/store passes their TranspositionModel cost.  The
    accumulated :class:`~repro_torch.core.backends.PerfStats` is ``p.stats`` and
    :meth:`perf_report` renders it — modeled end-to-end DRAM nanoseconds,
    nanojoules, and effective GOps/s per bank for the whole chain.

    ``machine=`` (usually via ``SimdramMachine.pipeline()``) binds the whole
    chain to one session machine: ops fetch from that machine's μProgram
    Memory (including its user-defined ops), execute on its backend, and —
    when timed — charge its own PerfStats with its own DRAM model, fully
    isolated from any other machine in the process.

    ``model="replay"`` additionally replays every executed command trace on
    the cycle-accurate per-bank FSM array
    (:class:`~repro_torch.simdram.timing.TraceReplayTiming`): one desynchronized
    stream per engaged bank under the rank-level tRRD/tFAW activation
    windows and tREFI/tRFC refresh windows, so ``p.stats`` reports replayed
    and analytic ns/nJ side by side (``replay_ns``/``replay_nj`` vs
    ``exec_ns``/``exec_nj``) plus the per-bank stall breakdown
    (``replay_tfaw_ns``/``replay_refresh_ns``/``replay_bank_spread_ns``).
    ``refresh_phase=True`` threads the replay clock through the refresh
    grid across ops (cross-op refresh phase) instead of anchoring every
    op's windows at its own t=0.

    ``fused_trace=True`` turns the pipeline into a *fused-trace* pipeline:
    bbops inside the scope record lazily instead of executing, and the
    whole chain compiles (through the μProgram Memory's chain cache) to
    ONE fused :class:`~repro_torch.core.trace.LoweredTrace` — row allocation
    re-run across op boundaries, so producer outputs land where consumers
    want them and the inter-op LISA relocations the unfused pipeline pays
    are elided (counted as ``elided`` hops in the movement snapshot,
    charged nothing).  The fused trace executes once, at ``store`` of any
    chain value or at scope exit, whichever comes first.  Ops a chain
    cannot absorb (width-changing ops like ``bbop_greater``, explicit
    per-call ``backend=``/``machine=``) run eagerly, sealing the pending
    chain at that point.
    """

    def __init__(self, backend: str | None = None, banks: int | None = None,
                 timed: bool = False, perf_stats: PerfStats | None = None,
                 perf_model=None, model: str | None = None,
                 refresh_phase: bool | None = None, machine=None,
                 fused_trace: bool = False):
        if model is not None and not isinstance(model, str):
            raise TypeError(
                "model= selects the timing mode ('analytic' or 'replay'); "
                "pass a SimdramPerfModel via perf_model=")
        self.backend = backend
        self.banks = banks
        self.stats = perf_stats
        # any timing knob implies a timed pipeline — refresh_phase too,
        # or passing it alone would silently measure nothing
        self._timed = (timed or perf_stats is not None
                       or perf_model is not None or model is not None
                       or refresh_phase is not None)
        self._perf_model = perf_model
        # refresh-phase threading is a replay-mode concept: asking for it
        # without naming a mode means a replay pipeline
        self._mode = model if model is not None else (
            "replay" if refresh_phase is not None else None)
        self._refresh_phase = refresh_phase
        self._machine = machine
        self._fusion = _FusionRecorder(self) if fused_trace else None
        self._ctx = None
        self._tctx = None
        self._mctx = None

    def __enter__(self):
        if self._machine is not None:
            # machine scope first: every op inside fetches from the
            # machine's μProgram Memory and fires its scoped hooks
            self._mctx = self._machine.session()
            self._mctx.__enter__()
        backend = self.backend
        if backend is None and self._machine is not None:
            backend = self._machine.backend
        try:
            if backend is not None:
                self._ctx = use_backend(backend)
                self._ctx.__enter__()
            if self._timed:
                if (self._machine is not None and self.stats is None
                        and self._perf_model is None):
                    # charge the machine's own accumulator (its model)
                    self.stats = self._machine._stats_for(
                        self._mode, self._refresh_phase)
                    self._mode = self.stats.mode
                self._tctx = timed_execution(stats=self.stats,
                                             model=self._perf_model,
                                             mode=self._mode,
                                             refresh_phase=self._refresh_phase)
                self.stats = self._tctx.__enter__()
        except BaseException:
            # __exit__ never runs when __enter__ raises — unwind the
            # scopes entered so far or they leak process-wide
            if self._ctx is not None:
                self._ctx.__exit__(None, None, None)
                self._ctx = None
            if self._mctx is not None:
                self._mctx.__exit__(None, None, None)
                self._mctx = None
            raise
        if self._fusion is not None:
            self._fusion.machine = self._machine if self._machine is not None \
                else current_machine()
            _fusion_stack().append(self._fusion)
        return self

    def __exit__(self, *exc):
        if self._fusion is not None:
            st = _fusion_stack()
            if self._fusion in st:
                st.remove(self._fusion)
            if exc[0] is None:
                # seal the chain while the backend/timed/machine scopes
                # are still open: ONE fused trace executes here
                self._fusion.flush()
            else:
                self._fusion.pending = []
        if self._tctx is not None:
            self._tctx.__exit__(*exc)
        if self._ctx is not None:
            self._ctx.__exit__(*exc)
        if self._mctx is not None:
            self._mctx.__exit__(*exc)
        return False

    def perf_report(self) -> str:
        """Render the accumulated modeled-DRAM cost of the chain."""
        if self.stats is None:
            raise ValueError(
                "pipeline was not timed — construct it with timed=True "
                "(or pass perf_stats=) to collect modeled DRAM cost")
        return self.stats.report()

    def load(self, arrays, n_bits: int, signed: bool = False):
        """Horizontal array(s) → plane-resident, in one transposition pass.

        ``arrays`` may be a single array or a list; each entry is ``(E,)``
        or — when the pipeline is banked — ``(banks, E)``.  Returns
        BitplaneArray(s) matching the input structure.
        """
        single = not isinstance(arrays, (list, tuple))
        device = _device(self._machine)
        xs = [as_tensor(a, device) for a in ([arrays] if single else arrays)]
        shapes = {x.shape for x in xs}
        if len(shapes) > 1:
            raise ValueError(f"load operands disagree in shape: {shapes}")
        if self.banks is not None and (
                xs[0].dim() != 2 or xs[0].shape[0] != self.banks):
            raise ValueError(
                f"banks={self.banks} pipeline expects (banks, E) operands, "
                f"got shape {tuple(xs[0].shape)}")
        banked = xs[0].dim() == 2
        stacked = torch.stack(xs)                # (K, E) or (K, banks, E)
        flat = stacked.reshape(len(xs) * (xs[0].shape[0] if banked else 1),
                               xs[0].shape[-1])
        bpa = BitplaneArray.from_values(flat, n_bits, signed=signed)
        # bpa.planes: (K[*banks], n_bits, W) — split back per operand
        planes = bpa.planes
        outs = []
        for k in range(len(xs)):
            if banked:
                nb = xs[0].shape[0]
                p = planes[k * nb:(k + 1) * nb]
            else:
                p = planes[k]
            outs.append(BitplaneArray(p, n_bits, xs[0].shape[-1], signed))
        return outs[0] if single else outs

    def store(self, *results):
        """Plane-resident result(s) → horizontal, in one reverse pass when
        the results share a layout (width/bits/length/signedness); mixed
        layouts fall back to one pass per result."""
        results = tuple(r.materialize() if isinstance(r, _ChainValue) else r
                        for r in results)
        if len(results) == 1:
            return results[0].to_values()
        # stack along the bank axis so the reverse pass is also single
        layouts = {(r.planes.shape[-1], r.n_bits, r.length, r.signed)
                   for r in results}
        if len(layouts) == 1 and not any(r.banked for r in results):
            merged = BitplaneArray(
                torch.stack([r.planes for r in results]),
                results[0].n_bits, results[0].length,
                results[0].signed)
            vals = merged.to_values()
            return tuple(vals[i] for i in range(len(results)))
        return tuple(r.to_values() for r in results)
