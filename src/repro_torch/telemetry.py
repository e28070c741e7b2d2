"""Spans and counters of the port's layers: one registry a process.

``span(name, args=None)`` is a context manager around a stretch of host
code.  It records only while a torch profiler runs:
then it enters a profiler record function named ``name``, so it sits in
the profiler's trace beside the aten calls and kernels it encloses, on
their clock (``args``, a dict of numbers and strings, shows with the event
when the profiler records shapes), and adds its host-clock duration to the
registry (count, total ns, and self ns: the total less the time its
recorded child spans took, kept on a per-thread stack).  Without a
profiler ``span`` returns one shared object that does nothing, so a span
costs one check and no allocation.  A span made while no profiler ran
records nothing, and so does one whose profiler stopped before it exited.

The record function is the profiler's fast one (the one compiled code
uses) where torch has it, else ``torch.profiler.record_function``: on an
H100's host the fast one adds ~1.5 µs to a span around a CUDA op against
~16 µs, and its event shows ``args``.  It is looked up when a span
records, so a torch without it still imports the port.

``count(name, n=1)`` is always on: an integer add in the calling thread's
own table, which ``snapshot()`` and ``counter()`` sum, so counts from
several threads are never lost and no lock is taken.  The time spent at
a rare event (a μProgram compile, a kernel build) is a counter of ns.

``snapshot()`` returns ``{"spans": {name: {"n", "total_ns", "self_ns"}},
"counters": {name: int}}``; ``reset()`` clears the registry.  The names
follow the layers: ``bbop``, ``memory.*``, ``machine.meter``,
``kernels.*``, ``layout.*``, ``decode.*``, ``models.*``.  The profiler is
the switch, and its ``export_chrome_trace`` the exporter.
"""
from __future__ import annotations

import threading
import time

import torch

__all__ = ["count", "counter", "profiling", "reset", "snapshot", "span",
           "span_count", "span_total_ns"]

profiling = getattr(torch._C._autograd, "_profiler_enabled", None) or (
    lambda: torch.autograd.profiler._is_profiler_enabled)

_LOCK = threading.Lock()
_SPANS: dict[str, list[int]] = {}        # name → [n, total_ns, self_ns]
_TABLES: list[tuple[threading.Thread, dict]] = []   # each thread's counters
_ENDED: dict[str, int] = {}              # the counters of ended threads
_LOCAL = threading.local()


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


def _record_function(name: str, args):
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if fast is None:
        return torch.profiler.record_function(
            name, None if args is None else str(args))
    if args is None:
        return fast(name)
    # the fast record function aborts the process on arguments of another
    # type, so they are checked here
    return fast(name, (), {str(k): v if isinstance(v, (int, float, str))
                           else str(v) for k, v in args.items()})


class _Off:
    """The span made while no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "args", "_rf", "_t0", "_child")

    def __init__(self, name: str, args) -> None:
        self.name = name
        self.args = args
        self._rf = None

    def __enter__(self):
        if not profiling():
            return self
        self._rf = _record_function(self.name, self.args)
        self._rf.__enter__()
        self._child = 0
        _stack().append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        rf = self._rf
        if rf is None:
            return False
        ns = time.perf_counter_ns() - self._t0
        self._rf = None
        st = _stack()
        st.pop()
        recorded = profiling()
        rf.__exit__(*exc)
        if recorded:
            if st:
                st[-1]._child += ns
            with _LOCK:
                rec = _SPANS.setdefault(self.name, [0, 0, 0])
                rec[0] += 1
                rec[1] += ns
                rec[2] += ns - self._child
        return False


def span(name: str, args=None):
    """A named stretch of host code (see the module doc); ``args`` is a
    dict of numbers and strings."""
    return _Span(name, args) if profiling() else _OFF


def _own_table() -> dict:
    """The calling thread's counters, made on its first count; the tables
    of ended threads fold into one."""
    table: dict[str, int] = {}
    with _LOCK:
        live = []
        for th, t in _TABLES:
            if th.is_alive():
                live.append((th, t))
            else:
                for k, v in t.items():
                    _ENDED[k] = _ENDED.get(k, 0) + v
        live.append((threading.current_thread(), table))
        _TABLES[:] = live
    _LOCAL.counters = table
    return table


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    try:
        table = _LOCAL.counters
    except AttributeError:
        table = _own_table()
    table[name] = table.get(name, 0) + n


def _counters() -> dict[str, int]:
    # under _LOCK; each copy is one step for the interpreter
    out = dict(_ENDED)
    for _, t in _TABLES:
        for k, v in t.copy().items():
            out[k] = out.get(k, 0) + v
    return out


def snapshot() -> dict:
    """The registry's spans and counters, copied."""
    with _LOCK:
        return {"spans": {k: {"n": n, "total_ns": t, "self_ns": s}
                          for k, (n, t, s) in _SPANS.items()},
                "counters": _counters()}


def reset(*names: str) -> None:
    """Clear the spans and counters ``names``, or the whole registry."""
    with _LOCK:
        tables = [_ENDED] + [t for _, t in _TABLES]
        if not names:
            _SPANS.clear()
            for t in tables:
                t.clear()
        for k in names:
            _SPANS.pop(k, None)
            for t in tables:
                t.pop(k, None)


def counter(name: str) -> int:
    with _LOCK:
        return _ENDED.get(name, 0) + sum(t.get(name, 0) for _, t in _TABLES)


def span_count(name: str) -> int:
    with _LOCK:
        return _SPANS.get(name, (0, 0, 0))[0]


def span_total_ns(name: str) -> int:
    with _LOCK:
        return _SPANS.get(name, (0, 0, 0))[1]
