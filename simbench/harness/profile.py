"""The device trace of a short stretch of the timed path.

:class:`Trace` runs ``torch.profiler`` (CPU and CUDA activities) around a
part of a run; ``open_window``/``close_window`` mark the measured stretch
with a user annotation after a synchronise, so the profiler's own start-up
falls outside it.  :func:`reduce_events` turns the raw events into what the
per-layer readers and the breakdown read: device time by kernel name, the
union of device activity (``busy_s``) over the window (``window_s``),
the host's aten calls, and the idle gaps labelled by the outermost aten
call the host was in at the gap's middle.
"""
from __future__ import annotations

import bisect

import torch

WINDOW = "simbench.window"
NOT_IN_ATEN = "host outside aten calls"
_SYNC_PREFIXES = ("Context Sync", "Stream Sync", "Event Sync", "Stream Wait")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Trace:
    """A profiler around part of a run, with one measured window."""

    def __init__(self, device) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.device = device
        self.prof = torch.profiler.profile(activities=acts,
                                           record_shapes=False,
                                           with_stack=False)
        self._rf = None

    def start(self) -> None:
        self.prof.start()

    def open_window(self) -> None:
        _sync(self.device)
        self._rf = torch.profiler.record_function(WINDOW)
        self._rf.__enter__()

    def close_window(self) -> None:
        _sync(self.device)
        self._rf.__exit__(None, None, None)
        self._rf = None

    def stop(self) -> dict:
        self.prof.stop()
        return reduce_events(raw_events(self.prof))


def raw_events(prof) -> list[tuple[str, bool, int, int]]:
    """(name, on the device, start ns, end ns) of every profiled event but
    the device-side copies of user annotations and sync records."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() != torch.autograd.DeviceType.CPU
        name = e.name()
        if dev and (e.is_user_annotation() or name == WINDOW
                    or name.startswith(_SYNC_PREFIXES)):
            continue
        start = e.start_ns()
        out.append((name, dev, start, start + e.duration_ns()))
    return out


def union(intervals) -> list[tuple[int, int]]:
    """Sorted, disjoint union of (start, end) intervals."""
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def outermost(intervals) -> list[tuple[int, int, str]]:
    """The (start, end, name) intervals not nested in another, sorted."""
    out: list[tuple[int, int, str]] = []
    for s, e, n in sorted(intervals, key=lambda t: (t[0], -t[1])):
        if out and s < out[-1][1]:
            continue
        out.append((s, e, n))
    return out


def reduce_events(events) -> dict:
    """Reduce raw events to the window's summary (see the module doc)."""
    wins = [(s, e) for n, dev, s, e in events if not dev and n == WINDOW]
    if len(wins) != 1:
        raise ValueError(f"the trace holds {len(wins)} measured windows")
    ws, we = wins[0]
    dev = [(n, max(s, ws), min(e, we)) for n, d, s, e in events
           if d and e > ws and s < we]
    busy = union((s, e) for _, s, e in dev)
    kernel_s: dict[str, float] = {}
    kernel_n: dict[str, int] = {}
    for n, s, e in dev:
        kernel_s[n] = kernel_s.get(n, 0.0) + (e - s) / 1e9
        kernel_n[n] = kernel_n.get(n, 0) + 1
    aten = [(s, e, n) for n, d, s, e in events
            if not d and n.startswith("aten::") and ws <= s < we]
    top = outermost(aten)
    starts = [s for s, _, _ in top]
    gaps = []
    edge = ws
    for s, e in busy + [(we, we)]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    idle: dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = top[i][2] if i >= 0 and top[i][1] > mid else NOT_IN_ATEN
        idle[label] = idle.get(label, 0.0) + (e - s) / 1e9
    return {
        "window_s": (we - ws) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "kernel_s": kernel_s,
        "kernel_n": kernel_n,
        "aten_calls": len(aten),
        "breakdown": {
            "device_ops": sorted(kernel_s.items(), key=lambda t: -t[1])[:10],
            "idle_gaps": sorted(idle.items(), key=lambda t: -t[1])[:10],
        },
    }


def kernel_seconds(trace: dict, marker: str) -> tuple[float, int]:
    """Total device seconds and launches of the kernels whose name holds
    ``marker``."""
    secs = sum(t for n, t in trace["kernel_s"].items() if marker in n)
    count = sum(c for n, c in trace["kernel_n"].items() if marker in n)
    return secs, count
