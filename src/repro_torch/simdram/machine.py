"""SimdramMachine — a session-scoped end-to-end SIMDRAM instance.

The paper's contribution is a *framework*: "a flexible mechanism to support
the implementation of arbitrary user-defined operations", three steps from
an AND/OR/NOT description to in-DRAM execution.  :class:`SimdramMachine`
is that framework as one object.  A machine owns the complete end-to-end
configuration —

* the DRAM substrate: a :class:`~repro_torch.simdram.timing.DRAMTiming` (and the
  :class:`~repro_torch.simdram.timing.SimdramPerfModel` built from it), a bank
  count, and an execution-backend choice;
* its **μProgram Memory**: a private, capacity-bounded
  :class:`~repro_torch.core.trace.TraceCache` holding the compiled + lowered
  ``(UProgram, LoweredTrace)`` pairs of every operation the session runs;
* its **operation registry**: the 16 built-ins plus any operation the user
  defines with :meth:`define_op` (paper Steps 1–2: AOIG → MAJ/NOT synthesis
  → row allocation → μProgram → lowered command trace);
* its own :class:`~repro_torch.core.backends.PerfStats` accumulator and its own
  transpose/movement hook lists, scoped to work executed under this
  machine.

Two machines with different timings, banks, backends or cache capacities
coexist in one process without sharing any of the above — the configuration
is explicit and isolated instead of ambient process globals.

A machine also serves *concurrent workloads*: :meth:`SimdramMachine.submit`
queues an operation for a named tenant and returns a :class:`SimdramFuture`;
:meth:`SimdramMachine.drain` packs every pending request across banks with
a :class:`~repro_torch.simdram.scheduler.BankScheduler` (FR-FCFS issue under the
shared rank constraints, refresh-aware by default), executes them, and
resolves each future with its result plus its modeled per-request timing.
Per-tenant :class:`~repro_torch.core.backends.PerfStats` attribution rides the
owner filter (:meth:`SimdramMachine.tenant_stats`).

The three paper steps as API::

    m = SimdramMachine(timing=DRAMTiming(...), banks=4, device="cuda")

    def build_gated_sub(g):                       # Step 1: the AOIG
        a, b, gate, w = (g.input(n) for n in ("a", "b", "gate", "borrow"))
        bg = g.gate_and(b, gate)
        axb = g.gate_xor(a, bg)
        g.add_output("out", g.gate_xor(axb, w))
        g.add_output("borrow", g.gate_or_node(
            g.gate_and(lit_not(a), bg), g.gate_and(w, lit_not(axb))))

    gated_sub = m.define_op(                      # Steps 1-2: synthesize,
        "gated_sub", build_gated_sub,             # allocate rows, lower
        invariants={"gate": DRow("gate", 0, fixed=True)},
        states={"borrow": 0})

    out = gated_sub(a, b, gmask, n_bits=8)        # Step 3: execute — on
    out = m.op("gated_sub")(a, b, gmask, n_bits=8)  # any registered backend

The **default machine** (:func:`default_machine`) is the machine behind the
ambient module-level surface: its μProgram Memory *is* the process-wide
compile/lower cache (``repro_torch.core.trace.GLOBAL_TRACE_CACHE``), its registry
is the process-wide op table (``repro_torch.core.circuits``), and its backend
resolves to the process default, so ``bbop_*`` / ``simdram_pipeline`` /
``timed()`` keep working unchanged as thin delegates of it.

Every machine owns a torch ``device`` (``"cuda"`` by default, the default
machine's too): horizontal operands are placed there before they are
transposed, so an entry point runs on the card unless the caller asks for
the CPU (``SimdramMachine(device="cpu")``).  A ``"cuda"`` machine on a host
without a CUDA device raises; it never carries on on the CPU.
"""
from __future__ import annotations

import contextlib
import itertools
import threading

import torch

from ..core.backends import (PerfStats, execute_heterogeneous,
                             execute_lowered)
from ..core.backends import timed as _timed_execution
from ..core.compiler import SliceSpec, compile_slice
from ..core.graph import LogicGraph
from ..core.trace import GLOBAL_TRACE_CACHE, TraceCache
from ..device import resolve_device
from .layout import (LANE_WORD, BitplaneArray, as_tensor,
                     register_movement_hook, register_transpose_hook)
from .scheduler import BankScheduler, RequestTiming, ScheduleResult
from .timing import DRAMEnergy, DRAMTiming, ReplayResult, SimdramPerfModel

# innermost-last, per-thread stack of machines whose session scope is
# open; bbop_* and the layout hooks consult it so work inside ``with
# machine.session():`` (or a machine pipeline) routes through that
# machine's μProgram Memory, backend and scoped hooks.  Thread-local:
# one thread's open session must never leak into another thread's ops —
# that is the isolation this API exists to provide.
_SCOPE = threading.local()


def _scope_stack() -> list:
    stack = getattr(_SCOPE, "stack", None)
    if stack is None:
        stack = _SCOPE.stack = []
    return stack


def current_machine() -> "SimdramMachine | None":
    """The innermost machine with an open session scope on this thread
    (None outside any session)."""
    stack = _scope_stack()
    return stack[-1] if stack else None


# layout-traffic forwarders: scoped hooks observe the work attributed to
# the *innermost* open session only (the same attribution rule PerfStats
# owner-filtering uses) — re-entered sessions therefore fire each hook
# exactly once per pass, and nested foreign sessions don't cross-observe
def _forward_transpose(kind: str, n_bits: int, lanes: int) -> None:
    m = current_machine()
    if m is not None:
        for hook in m._transpose_hooks:
            hook(kind, n_bits, lanes)


def _forward_movement(kind: str, n_rows: int, banks: int | None = None,
                      planes=None) -> None:
    m = current_machine()
    if m is not None:
        for hook in m._movement_hooks:
            hook(kind, n_rows, banks)


register_transpose_hook(_forward_transpose)
register_movement_hook(_forward_movement)

# let the timed execution layer attribute work to the innermost open
# machine session without importing this module eagerly
from ..core import backends as _backends  # noqa: E402

_backends._current_machine = current_machine


class BoundOp:
    """A machine operation bound for execution (what :meth:`SimdramMachine.op`
    returns).  Calling it runs paper Step 3: fetch the compiled trace from
    the machine's μProgram Memory and dispatch it to the machine's backend.

    Positional operands bind to the μProgram's declared input arrays in
    order; each may be a horizontal array (transposed in, transposed out —
    the compat path) or a plane-resident
    :class:`~repro_torch.simdram.layout.BitplaneArray` (planes in, planes out).
    """

    def __init__(self, machine: "SimdramMachine", name: str) -> None:
        self.machine = machine
        self.name = name

    def __repr__(self) -> str:
        return f"<BoundOp {self.name!r} on {self.machine!r}>"

    def program(self, n_bits: int = 8, optimize: bool = True):
        """The cached ``(UProgram, LoweredTrace)`` pair for this width."""
        return self.machine.memory.get(self.name, n_bits, optimize)

    def __call__(self, *operands, n_bits: int = 8, out_bits: int | None = None,
                 signed_out: bool = False, optimize: bool = True,
                 backend: str | None = None):
        from ..ops.bbops import _run_op
        with self.machine.session():
            # one μProgram-Memory access per call (the fetched pair rides
            # through to execution), and operand layout conversion happens
            # inside the session so the machine's scoped hooks observe the
            # input transposition passes too
            compiled = self.program(n_bits, optimize)
            prog = compiled[0]
            # inputs may repeat a name (e.g. relu reads 'a' twice) — one
            # operand binds each distinct input array
            names = tuple(dict.fromkeys(prog.inputs))
            if len(operands) != len(names):
                raise TypeError(
                    f"{self.name} takes {len(names)} operands "
                    f"{names}, got {len(operands)}")
            keep = any(isinstance(x, BitplaneArray) for x in operands)
            bound = {}
            for arr_name, x in zip(names, operands):
                if not isinstance(x, BitplaneArray):
                    x = BitplaneArray.from_values(
                        as_tensor(x, self.machine.device), n_bits)
                bound[arr_name] = x
            return _run_op(self.name, bound, n_bits, signed_out=signed_out,
                           out_bits=out_bits, optimize=optimize,
                           backend=backend, keep_planes=keep,
                           machine=self.machine, compiled=compiled)


class _Submission:
    """One queued :meth:`SimdramMachine.submit` request awaiting drain."""

    __slots__ = ("future", "name", "operands", "n_bits", "out_bits",
                 "signed_out", "optimize", "backend", "tenant", "priority",
                 "arrival_ns")

    def __init__(self, future, name, operands, n_bits, out_bits,
                 signed_out, optimize, backend, tenant, priority,
                 arrival_ns) -> None:
        self.future = future
        self.name = name
        self.operands = operands
        self.n_bits = n_bits
        self.out_bits = out_bits
        self.signed_out = signed_out
        self.optimize = optimize
        self.backend = backend
        self.tenant = tenant
        self.priority = priority
        self.arrival_ns = arrival_ns


class SimdramFuture:
    """Handle to one scheduled operation (what :meth:`SimdramMachine.submit`
    returns).

    The future resolves when the machine drains: :meth:`result` returns
    the operation's value (running :meth:`SimdramMachine.drain` first if
    needed), and the modeled timing surfaces alongside it — ``timing`` is
    the scheduler's per-request :class:`~repro_torch.simdram.scheduler
    .RequestTiming` (arrival / first-activation / completion, queue vs
    service split, stall attribution), ``replay`` re-expresses it as a
    :class:`~repro_torch.simdram.timing.ReplayResult`, and ``finish_ns`` is the
    modeled completion time on the shared rank clock.  ``tenant`` names
    the workload stream the request was attributed to (its share of the
    machine's PerfStats lives in ``machine.tenant_stats(tenant)``).
    """

    def __init__(self, machine: "SimdramMachine", name: str, tenant: str,
                 index: int) -> None:
        self.machine = machine
        self.name = name
        self.tenant = tenant
        self.index = index          # submission order on this machine
        self._value = None
        self._timing: RequestTiming | None = None
        self._done = False

    def __repr__(self) -> str:
        state = "done" if self._done else "pending"
        return (f"<SimdramFuture #{self.index} {self.name!r} "
                f"tenant={self.tenant!r} {state}>")

    def done(self) -> bool:
        """True once the machine has drained this submission."""
        return self._done

    def result(self):
        """The operation's result, draining the machine's queue first if
        this submission is still pending (same default scheduling as a
        bare :meth:`SimdramMachine.drain`)."""
        if not self._done:
            self.machine.drain()
        return self._value

    @property
    def timing(self) -> RequestTiming | None:
        """Scheduler timing for this request (None until drained)."""
        return self._timing

    @property
    def replay(self) -> ReplayResult | None:
        """This request's scheduled service time as a ReplayResult."""
        return self._timing.replay_result() if self._timing else None

    @property
    def finish_ns(self) -> float | None:
        """Modeled completion time on the drain's rank clock."""
        return self._timing.finish_ns if self._timing else None


class SimdramMachine:
    """One isolated, fully-configured SIMDRAM session (see module docstring).

    Parameters
    ----------
    timing / energy : the DRAM substrate (defaults: DDR4-2400 per paper
        Table 2).  ``model`` overrides both with a complete
        :class:`SimdramPerfModel`.
    banks : default bank count for :meth:`pipeline` (1 = unbanked).
    backend : default execution backend for every op this machine runs
        (``None`` = follow the process default).
    cache_capacity : μProgram Memory bound (LRU entries; ``None`` =
        unbounded).  The paper's scratchpad holds few compiled programs;
        a bounded cache makes eviction behavior explicit and testable.
    mode : ``"analytic"`` or ``"replay"`` — how this machine's
        :attr:`stats` accumulator meters execution.
    refresh_phase : replay mode only — thread the accumulated replay clock
        through the refresh-window grid across ops (cross-op refresh
        phase) instead of re-anchoring each op at t=0.
    device : where this machine's data lives (``"cuda"`` by default; pass
        ``"cpu"`` to run the plain PyTorch versions of the kernels).
    """

    _lazy_device = False

    def __init__(self, timing: DRAMTiming | None = None,
                 energy: DRAMEnergy | None = None,
                 model: SimdramPerfModel | None = None,
                 banks: int = 1, backend: str | None = None,
                 cache_capacity: int | None = 64,
                 mode: str = "analytic", refresh_phase: bool = False,
                 memory: TraceCache | None = None,
                 device: str | torch.device = "cuda") -> None:
        if model is not None and (timing is not None or energy is not None):
            raise ValueError("pass either a complete model or its "
                             "timing/energy parts, not both")
        if banks < 1:
            raise ValueError(f"banks must be >= 1, got {banks}")
        self._device_spec = device
        self._device = None if self._lazy_device else resolve_device(device)
        self.model = model or SimdramPerfModel(timing=timing, energy=energy)
        self.timing = self.model.timing
        self.banks = int(banks)
        self.backend = backend
        self.stats = PerfStats(model=self.model, mode=mode,
                               refresh_phase=refresh_phase, owner=self)
        self._ops: dict[str, object] = {}   # name → compile_fn(n_bits, opt)
        if memory is not None:
            # advanced: adopt an existing μProgram Memory.  Its own bound
            # applies (cache_capacity is not consulted), and its compile
            # hook is wired to this machine's registry if unset so
            # define_op'd ops resolve — a cache already wired to another
            # machine keeps that machine's registry (shared-memory setups
            # share the first owner's op table).
            if memory._compile_fn is None:
                memory._compile_fn = self._compile
            self.memory = memory
        else:
            self.memory = TraceCache(capacity=cache_capacity,
                                     compile_fn=self._compile)
        self._transpose_hooks: list = []
        self._movement_hooks: list = []
        self._pending: list[_Submission] = []
        self._submit_lock = threading.Lock()
        self._n_submitted = 0

    def __repr__(self) -> str:
        be = self.backend or "default"
        return (f"SimdramMachine(banks={self.banks}, backend={be!r}, "
                f"device={str(self._device_spec)!r}, "
                f"ops={len(self._ops)} user-defined)")

    @property
    def device(self) -> torch.device:
        """Where this machine places horizontal operands."""
        if self._device is None:
            self._device = resolve_device(self._device_spec)
        return self._device

    # -- Step 1+2: operation definition -------------------------------------
    def _compile(self, name: str, n_bits: int, optimize: bool):
        fn = self._ops.get(name)
        if fn is not None:
            return fn(n_bits, optimize)
        from ..core.circuits import compile_operation
        return compile_operation(name, n_bits, optimize=optimize)

    def define_op(self, name: str, build_graph=None, spec=None, *,
                  invariants: dict | None = None, states: dict | None = None,
                  arrays_in: tuple | None = None, out_array: str | None = "out",
                  epilogue_outputs: dict | None = None, compile_fn=None,
                  validate: bool = True, verify: bool | int = True,
                  override: bool = False) -> BoundOp:
        """Register a user-defined operation with this machine (Steps 1–2).

        Three entry points, from highest- to lowest-level:

        * ``build_graph(g: LogicGraph)`` — the paper's Step-1 input: an
          AND/OR/NOT description of the op's 1-bit slice.  Primary inputs
          not named in ``invariants``/``states`` become the op's operand
          arrays (``arrays_in`` overrides the inferred order); ``states``
          are loop-carried values (e.g. a carry) with their initial value,
          ``invariants`` bind PIs to fixed rows, ``out_array`` /
          ``epilogue_outputs`` place results — the same vocabulary as
          :class:`~repro_torch.core.compiler.SliceSpec`.
        * ``spec=SliceSpec(...)`` — a pre-built slice spec.
        * ``compile_fn=(n_bits, optimize) -> UProgram`` — full control for
          composite/tree ops (build with ``compile_slice`` /
          ``compile_flat`` / ``rebase`` / ``concat_programs``).

        The op is synthesized (AOIG → optimized MIG), row-allocated,
        lowered to the command-trace IR on first use, cached in this
        machine's μProgram Memory, and immediately executable on **all**
        registered backends — including replay timing — with no other code
        change.  ``validate=True`` checks the Step-1 synthesis: the
        optimized MIG must be functionally equivalent to the naive
        MAJ/NOT substitution on every input assignment.

        ``verify`` statically verifies the op's *lowered command trace*
        (:mod:`repro_torch.core.tracelint`) at registration: the op is compiled
        once at a probe width (8 bits, or pass ``verify=<n_bits>`` for
        compile paths that only support other widths; ``verify=False``
        skips), and a trace with lint errors — a read of an uninitialized
        compute cell, a clobbered operand row, an undefined output row, a
        malformed seqs table — rolls the registration back and raises
        :class:`~repro_torch.core.tracelint.TraceLintError` with the full
        report, so a broken ``compile_fn`` can never reach a backend or a
        tenant's bank.  The probe compiles outside the μProgram Memory, so
        registration never perturbs cache entries or hit/miss counters.

        On the :func:`default_machine`, definition lands in the
        process-wide op registry so the ambient ``bbop``-style surface
        sees it too.  Returns the bound op, ready to call.
        """
        n_entry = sum(x is not None for x in (build_graph, spec, compile_fn))
        if n_entry != 1:
            raise TypeError("define_op needs exactly one of build_graph, "
                            "spec or compile_fn")
        if spec is None and build_graph is not None:
            g = LogicGraph()
            build_graph(g)
            if not g.outputs:
                raise ValueError(f"{name!r}: build_graph declared no outputs")
            if verify:
                # pre-synthesis graph lint: malformed user AOIGs fail here
                # with a graph diagnostic, not deep inside Step-1 synthesis
                from ..core.tracelint import lint_graph
                lint_graph(g, name=name).raise_for_errors()
            if validate:
                from ..core.synthesis import check_synthesis
                check_synthesis(g, name=name)
            bound_names = set(invariants or {}) | set(states or {})
            missing = bound_names - set(g.input_names())
            if missing:
                raise ValueError(
                    f"{name!r}: invariants/states name unknown inputs "
                    f"{sorted(missing)} (graph inputs: {g.input_names()})")
            if arrays_in is None:
                arrays_in = tuple(n for n in g.input_names()
                                  if n not in bound_names)
            spec = SliceSpec(name, build_graph, tuple(arrays_in),
                             invariants=dict(invariants or {}),
                             states=dict(states or {}),
                             out_array=out_array,
                             epilogue_outputs=dict(epilogue_outputs or {}))
        if compile_fn is None:
            the_spec = spec

            def compile_fn(n_bits, optimize=True, _spec=the_spec):
                return compile_slice(_spec, n_bits, optimize=optimize)

        self._register(name, compile_fn, override=override)
        if verify:
            from ..core.trace import lower_program
            from ..core.tracelint import TraceLintError
            probe_bits = 8 if verify is True else int(verify)
            try:
                # probe outside the μProgram Memory: registration must not
                # perturb cache entries/counters for ops never executed
                trace = lower_program(self._compile(name, probe_bits, True))
                trace.lint().raise_for_errors()
            except TraceLintError:
                # reject at registration: a broken op must not stay callable
                self._unregister(name)
                raise
        return self.op(name)

    def define_chain(self, name: str, stages, *, outputs=None,
                     verify: bool | int = True,
                     override: bool = False) -> BoundOp:
        """Register a fused cross-op pipeline as a first-class operation.

        ``stages`` is a sequence of :class:`~repro_torch.core.compiler.ChainStage`
        (or ``(op, inputs, output)`` tuples) in SSA form; each stage's op
        resolves through this machine, so user-defined ops fuse like
        built-ins and a stage may itself name another registered chain.
        The whole pipeline compiles to ONE μProgram / one
        :class:`~repro_torch.core.trace.LoweredTrace` per width (see
        :func:`~repro_torch.core.compiler.compile_chain`) — producer output rows
        are allocated where the consumer reads them, so no inter-op
        movement remains at the seams — and the machine treats it exactly
        like any other op: ``m.op(name)(...)`` executes it, and
        :meth:`submit` / :meth:`drain` schedule it as a SINGLE FR-FCFS
        request (one atomic unit on one bank set, never interleaved
        per-op; the future resolves the chain's first output).  The
        μProgram Memory keys it like any op, but the trace's
        ``chain.ops`` make :meth:`TraceCache.invalidate` of ANY
        constituent op evict it.

        ``verify`` probe-compiles the fused trace (width 8, or pass
        ``verify=<n_bits>``) and statically lints it — including the
        chain seam checks — rolling the registration back on any error.
        """
        from ..core.compiler import _as_stage, compile_chain
        norm = tuple(_as_stage(s) for s in stages)
        if not norm:
            raise ValueError(f"{name!r}: define_chain needs >= 1 stage")
        if any(st.op == name for st in norm):
            raise ValueError(f"{name!r}: a chain cannot name itself as a "
                             "stage op")
        chain_outs = tuple(outputs) if outputs is not None else None

        def compile_fn(n_bits, optimize=True, _stages=norm,
                       _outs=chain_outs, _name=name):
            return compile_chain(_stages, n_bits, optimize=optimize,
                                 compile_fn=self._compile, outputs=_outs,
                                 name=_name)

        self._register(name, compile_fn, override=override)
        if verify:
            from ..core.trace import lower_program
            probe_bits = 8 if verify is True else int(verify)
            try:
                # probe outside the μProgram Memory, like define_op: a
                # broken chain (unknown stage op, arity mismatch, lint
                # errors) must not stay callable
                trace = lower_program(self._compile(name, probe_bits, True))
                trace.lint().raise_for_errors()
            except Exception:
                self._unregister(name)
                raise
        return self.op(name)

    def _register(self, name: str, compile_fn, override: bool) -> None:
        if not override and name in self.ops():
            raise ValueError(f"operation {name!r} already defined on this "
                             "machine (pass override=True to replace it)")
        self._ops[name] = compile_fn
        # a redefinition must not serve the old definition's compiles
        self.memory.invalidate(name)

    def _unregister(self, name: str) -> None:
        self._ops.pop(name, None)
        self.memory.invalidate(name)

    def ops(self) -> tuple[str, ...]:
        """Every operation this machine can execute (registry + local)."""
        from ..core.circuits import list_operations
        return tuple(sorted(set(list_operations()) | set(self._ops)))

    # -- Step 3: execution ---------------------------------------------------
    def op(self, name: str) -> BoundOp:
        """Bind a registered operation for execution: ``m.op("x")(a, b)``."""
        if name not in self.ops():
            raise KeyError(f"unknown operation {name!r}; this machine "
                           f"knows {self.ops()}")
        return BoundOp(self, name)

    @contextlib.contextmanager
    def session(self):
        """Open this machine's scope (on this thread): every ``bbop_*``
        call inside routes through this machine's μProgram Memory and
        backend, and this machine's scoped transpose/movement hooks
        observe the layout traffic attributed to it (innermost session
        wins).  Re-entrant; machine pipelines and bound ops open it
        implicitly."""
        stack = _scope_stack()
        stack.append(self)
        try:
            yield self
        finally:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] is self:
                    del stack[i]
                    break

    def _stats_for(self, mode: str | None,
                   refresh_phase: bool | None) -> PerfStats:
        """The machine accumulator, or a fresh one when the requested
        timing mode disagrees with it (an accumulator cannot switch
        mid-flight)."""
        want_mode = mode or self.stats.mode
        want_phase = self.stats.refresh_phase if refresh_phase is None \
            else refresh_phase
        if want_mode == self.stats.mode and \
                want_phase == self.stats.refresh_phase:
            return self.stats
        return PerfStats(model=self.model, mode=want_mode,
                         refresh_phase=want_phase, owner=self)

    @contextlib.contextmanager
    def timed(self, mode: str | None = None, stats: PerfStats | None = None,
              refresh_phase: bool | None = None):
        """Timed execution under this machine: like
        :func:`repro_torch.core.backends.timed` but charging the machine's own
        accumulator (with the machine's model) by default, inside the
        machine's session scope.  An explicit ``stats`` accumulator whose
        mode/refresh-phase disagrees with the requested one raises, same
        as the core ``timed()``."""
        st = stats if stats is not None else \
            self._stats_for(mode, refresh_phase)
        with self.session():
            with _timed_execution(stats=st, mode=mode,
                                  refresh_phase=refresh_phase) as s:
                yield s

    def pipeline(self, banks: int | None = None, backend: str | None = None,
                 **kw):
        """A plane-resident :class:`~repro_torch.ops.bbops.simdram_pipeline`
        bound to this machine: ops inside fetch from this machine's
        μProgram Memory, execute on its backend, and (``timed=True``)
        charge its PerfStats.  ``banks`` defaults to the machine's."""
        from ..ops.bbops import simdram_pipeline
        if banks is None and self.banks > 1:
            banks = self.banks
        return simdram_pipeline(banks=banks, backend=backend, machine=self,
                                **kw)

    # -- scheduled execution: submit / drain ---------------------------------
    def tenant_stats(self, tenant: str = "default") -> PerfStats:
        """The per-tenant :class:`PerfStats` accumulator (created on first
        use, stored in ``self.stats.tenants``).  Tenant accumulators share
        this machine as owner — interleaved *foreign* machine sessions
        never cross-charge them — and are active only while their own
        tenant's submissions prepare and execute, so concurrent tenants
        never cross-charge each other either.  Summing any meter over
        ``stats.tenants`` reproduces the machine total for work that went
        through submit/drain."""
        st = self.stats.tenants.get(tenant)
        if st is None:
            st = PerfStats(model=self.model, mode=self.stats.mode,
                           refresh_phase=self.stats.refresh_phase,
                           owner=self)
            self.stats.tenants[tenant] = st
        return st

    def submit(self, op: str, *operands, n_bits: int = 8,
               tenant: str = "default", out_bits: int | None = None,
               signed_out: bool = False, optimize: bool = True,
               backend: str | None = None, priority: int = 0,
               arrival_ns: float = 0.0) -> SimdramFuture:
        """Queue one operation for scheduled execution; returns a
        :class:`SimdramFuture`.

        Submissions accumulate until :meth:`drain` runs them through a
        :class:`~repro_torch.simdram.scheduler.BankScheduler` — heterogeneous
        requests packed across banks under the shared rank constraints —
        and executes them on this machine's backend.  ``tenant`` names the
        workload stream for scheduling fairness bookkeeping and PerfStats
        attribution (:meth:`tenant_stats`); operands follow the same
        rules as calling the bound op directly (horizontal arrays or
        plane-resident :class:`BitplaneArray`\\ s).

        ``priority`` is the submission's latency class: :meth:`drain`
        packs and enqueues higher-priority submissions first (FIFO within
        a class), so they take the least-loaded banks and win FR-FCFS
        age ties.  ``arrival_ns`` stamps the request's arrival on the
        drain's rank clock (it cannot issue earlier, and its
        :class:`RequestTiming` queue/service split is measured from it) —
        the serving layer uses it to model intra-step arrival skew."""
        if op not in self.ops():
            raise KeyError(f"unknown operation {op!r}; this machine "
                           f"knows {self.ops()}")
        with self._submit_lock:
            fut = SimdramFuture(self, op, tenant, self._n_submitted)
            self._n_submitted += 1
            self._pending.append(_Submission(
                fut, op, operands, n_bits, out_bits, signed_out,
                optimize, backend, tenant, int(priority),
                float(arrival_ns)))
        return fut

    def drain(self, n_banks: int | None = None,
              refresh_policy: str = "aware", policy: str = "frfcfs",
              scheduler: BankScheduler | None = None,
              batch: bool = False) -> ScheduleResult:
        """Run every pending submission: model the schedule (per-bank
        queues, FR-FCFS issue, the chosen refresh policy) and execute the
        corresponding μPrograms, resolving each submission's future with
        its result and its :class:`RequestTiming`.

        ``n_banks`` sizes the modeled controller (default: the machine's
        bank count, or the timing's ``banks_per_chip`` for a single-bank
        machine); pass an explicit ``scheduler`` to control placement /
        policies fully.  Returns the :class:`ScheduleResult` (makespan,
        per-request and per-tenant breakdowns).  Execution charges land on
        the machine accumulator *and* on each submission's tenant
        accumulator (:meth:`tenant_stats`).

        Packing order honors each submission's ``priority`` (higher
        first, FIFO within a class): a high-priority request takes the
        least-loaded banks and wins FR-FCFS age ties.

        ``batch=True`` is the continuous-batching drain the serving layer
        uses: *compatible* submissions — same lowered trace, backend,
        out_bits and unbanked operand shape — are stacked along the bank
        axis and issued as ONE bank-parallel request (one scheduler entry,
        one banked dispatch) instead of one request per submission, in
        chunks of the controller's bank count.  All riders of a stack
        share its :class:`RequestTiming`; per-tenant attribution switches
        to fractional bank shares
        (:meth:`~repro_torch.core.backends.PerfStats.charge_banked_share`), so
        tenant-summed ns/nJ/elem-ops still reproduce the machine totals
        while per-tenant *counters* count each rider's own request."""
        with self._submit_lock:
            subs = self._pending
            self._pending = []
        # latency-class packing (stable: FIFO within a class)
        subs.sort(key=lambda s: -s.priority)
        if scheduler is None:
            if n_banks is None:
                n_banks = self.banks if self.banks > 1 \
                    else self.timing.banks_per_chip
            scheduler = BankScheduler(timing=self.timing, n_banks=n_banks,
                                      policy=policy,
                                      refresh_policy=refresh_policy,
                                      memo=self.memory)
        if not subs:
            return scheduler.run()
        resolved = self._drain_batched(subs, scheduler) if batch \
            else self._drain_each(subs, scheduler)
        sched_res = scheduler.run()
        by_rid = {rt.index: rt for rt in sched_res.requests}
        for fut, rid in resolved:
            fut._timing = by_rid.get(rid)
            fut._done = True
        return sched_res

    def _prepare(self, sub: _Submission):
        """Fetch the compiled pair and bind one submission's operands
        (plane layout); caller wraps this in the tenant's timed scope so
        transposition charges land on the right tenant."""
        prog, trace = self.memory.get(sub.name, sub.n_bits, sub.optimize)
        names = tuple(dict.fromkeys(prog.inputs))
        if len(sub.operands) != len(names):
            raise TypeError(
                f"{sub.name} takes {len(names)} operands "
                f"{names}, got {len(sub.operands)}")
        keep = any(isinstance(x, BitplaneArray) for x in sub.operands)
        bound = {}
        for arr_name, x in zip(names, sub.operands):
            if not isinstance(x, BitplaneArray):
                x = BitplaneArray.from_values(as_tensor(x, self.device),
                                              sub.n_bits)
            bound[arr_name] = x
        if len({(o.banked, o.n_banks, o.length, o.words)
                for o in bound.values()}) > 1:
            raise ValueError(
                f"{sub.name}: operand bank/length shapes disagree: "
                f"{[o.planes.shape for o in bound.values()]}")
        return prog, trace, bound, keep

    def _drain_each(self, subs, scheduler) -> list:
        """One scheduler request + one execution item per submission (the
        default drain path).  Returns ``[(future, rid), ...]``."""
        prepared = []
        with self.session(), _timed_execution(stats=self.stats):
            for sub in subs:
                # prepare inside the tenant's scope so operand
                # transposition charges land on the right tenant
                with _timed_execution(stats=self.tenant_stats(sub.tenant)):
                    prog, trace, bound, keep = self._prepare(sub)
                first = next(iter(bound.values()))
                width = first.n_banks if first.banked else 1
                rid = scheduler.enqueue(
                    trace, banks=width, tenant=sub.tenant,
                    name=f"{sub.name}/{sub.n_bits}b",
                    arrival_ns=sub.arrival_ns,
                    lanes=first.words * LANE_WORD * width)
                prepared.append((sub, prog, trace, bound, keep, rid))
            # execute per tenant (attribution scope); inside a tenant,
            # adjacent same-trace requests collapse into banked batches
            for tenant, group in itertools.groupby(
                    prepared, key=lambda p: p[0].tenant):
                group = list(group)
                items = []
                for sub, prog, trace, bound, keep, rid in group:
                    ob = {prog.outputs[0]: sub.out_bits} \
                        if sub.out_bits else None
                    items.append((prog, trace,
                                  {k: v.planes for k, v in bound.items()},
                                  ob, sub.backend or self.backend))
                with _timed_execution(stats=self.tenant_stats(tenant)):
                    outs_list = execute_heterogeneous(items, machine=self)
                    for (sub, prog, trace, bound, keep, rid), outs in zip(
                            group, outs_list):
                        first = next(iter(bound.values()))
                        res = BitplaneArray(outs[prog.outputs[0]],
                                            sub.out_bits or sub.n_bits,
                                            first.length, sub.signed_out)
                        sub.future._value = res if keep else res.to_values()
        return [(sub.future, rid)
                for sub, _prog, _trace, _bound, _keep, rid in prepared]

    def _drain_batched(self, subs, scheduler) -> list:
        """Continuous-batching drain: stack compatible submissions along
        the bank axis into one scheduler request + one banked dispatch
        (see :meth:`drain` with ``batch=True``).  Returns
        ``[(future, rid), ...]``."""
        resolved = []
        with self.session(), _timed_execution(stats=self.stats):
            prepared = []
            for sub in subs:
                with _timed_execution(stats=self.tenant_stats(sub.tenant)):
                    prepared.append((sub, *self._prepare(sub)))
            # group compatible submissions; dict preserves first-occurrence
            # order, so the priority sort above carries into enqueue order
            groups: dict = {}
            for p in prepared:
                sub, prog, trace, bound, keep = p
                first = next(iter(bound.values()))
                if first.banked:
                    # already bank-resident: dispatch solo, as unbatched
                    sig = ("solo", id(sub))
                else:
                    sig = (id(trace), sub.backend or self.backend,
                           sub.out_bits,
                           tuple((k, tuple(v.planes.shape))
                                 for k, v in sorted(bound.items())))
                groups.setdefault(sig, []).append(p)
            cap = max(1, scheduler.n_banks)
            for members in groups.values():
                for i in range(0, len(members), cap):
                    resolved.extend(self._run_stack(members[i:i + cap],
                                                    scheduler))
        return resolved

    def _run_stack(self, members, scheduler) -> list:
        """Issue one compatible chunk as a single banked request."""
        sub0, prog, trace, bound0, _keep0 = members[0]
        first0 = next(iter(bound0.values()))
        ob = {prog.outputs[0]: sub0.out_bits} if sub0.out_bits else None
        backend = sub0.backend or self.backend
        out_name = prog.outputs[0]
        if len(members) == 1:
            sub, prog, trace, bound, keep = members[0]
            width = first0.n_banks if first0.banked else 1
            rid = scheduler.enqueue(
                trace, banks=width, tenant=sub.tenant,
                name=f"{sub.name}/{sub.n_bits}b",
                arrival_ns=sub.arrival_ns,
                lanes=first0.words * LANE_WORD * width)
            with _timed_execution(stats=self.tenant_stats(sub.tenant)):
                outs = execute_lowered(
                    prog, trace, {k: v.planes for k, v in bound.items()},
                    out_bits=ob, backend=backend, machine=self)
            res = BitplaneArray(outs[out_name], sub.out_bits or sub.n_bits,
                                first0.length, sub.signed_out)
            sub.future._value = res if keep else res.to_values()
            return [(sub.future, rid)]
        width = len(members)
        lanes_per = first0.words * LANE_WORD
        tenants = {m[0].tenant for m in members}
        label = sub0.tenant if len(tenants) == 1 else "batch"
        rid = scheduler.enqueue(
            trace, banks=width, tenant=label,
            name=f"{sub0.name}/{sub0.n_bits}b",
            arrival_ns=min(m[0].arrival_ns for m in members),
            lanes=lanes_per * width)
        stacked = {k: torch.stack([m[3][k].planes for m in members])
                   for k in bound0}
        # the machine accumulator takes the full banked charge here (the
        # tenant scopes are NOT active); each rider below takes its
        # fractional bank share so tenant sums stay exact
        outs = execute_lowered(prog, trace, stacked, out_bits=ob,
                               backend=backend, machine=self)
        out = []
        for idx, (sub, _prog, _trace, bound, keep) in enumerate(members):
            self.tenant_stats(sub.tenant).charge_banked_share(
                prog, trace, banks_total=width, banks_own=1,
                lanes=lanes_per)
            first = next(iter(bound.values()))
            res = BitplaneArray(outs[out_name][idx],
                                sub.out_bits or sub.n_bits,
                                first.length, sub.signed_out)
            # resolve in the tenant's scope: the output de-transposition
            # is the rider's own work, same as the unbatched path
            with _timed_execution(stats=self.tenant_stats(sub.tenant)):
                sub.future._value = res if keep else res.to_values()
            out.append((sub.future, rid))
        return out

    # -- scoped instrumentation ----------------------------------------------
    def register_transpose_hook(self, hook) -> None:
        """``hook(kind, n_bits, lanes)`` fires for transposition-unit passes
        inside this machine's session scope only."""
        if hook not in self._transpose_hooks:
            self._transpose_hooks.append(hook)

    def register_movement_hook(self, hook) -> None:
        """``hook(kind, n_rows, banks)`` fires for in-DRAM row relocations
        inside this machine's session scope only."""
        if hook not in self._movement_hooks:
            self._movement_hooks.append(hook)

    def cache_stats(self) -> dict:
        """μProgram Memory counters: {hits, misses, entries, hit_rate,
        capacity, evictions}."""
        return self.memory.stats()

    def perf_report(self) -> str:
        """Render the machine accumulator (see :meth:`PerfStats.report`)."""
        return self.stats.report()


class _DefaultMachine(SimdramMachine):
    """The machine behind the ambient module-level surface.

    Its μProgram Memory is the process-wide compile/lower cache and its op
    registry is the process-wide table in :mod:`repro_torch.core.circuits`, so
    ``bbop_*`` / ``simdram_pipeline`` / ``timed()`` (which consult those
    globals directly) are thin delegates of this machine by construction.
    Ops defined here are visible process-wide.  It runs on ``"cuda"``; the
    device is checked when it first places data, so importing the package
    and the machine-free surface work on any host.
    """

    _lazy_device = True

    def __init__(self) -> None:
        super().__init__(backend=None, banks=1, memory=GLOBAL_TRACE_CACHE)

    def _register(self, name: str, compile_fn, override: bool) -> None:
        from ..core.circuits import register_operation
        register_operation(name, compile_fn, override=override)

    def _unregister(self, name: str) -> None:
        from ..core.circuits import unregister_operation
        unregister_operation(name)


_DEFAULT_MACHINE: SimdramMachine | None = None


def default_machine() -> SimdramMachine:
    """The process-default :class:`SimdramMachine` (created on first use)."""
    global _DEFAULT_MACHINE
    if _DEFAULT_MACHINE is None:
        _DEFAULT_MACHINE = _DefaultMachine()
    return _DEFAULT_MACHINE
