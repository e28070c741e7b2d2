"""Arithmetic the per-layer readers share."""
from __future__ import annotations

from simbench.harness.profile import kernel_seconds


def idle_share(ctx: dict) -> float | None:
    """Percent of the traced window in which no operation ran on the
    device; nothing where the trace saw no device activity."""
    tr = ctx.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def roofline(ctx: dict, bound_key: str, markers) -> float | None:
    """Percent of the profiled kernels' time that their least time (the
    bound ``ctx['profiled_bounds'][bound_key]``) is; nothing where no
    kernel of ``markers`` ran."""
    tr = ctx.get("trace")
    if not tr:
        return None
    secs = n = 0
    for m in markers:
        s, c = kernel_seconds(tr, m)
        secs += s
        n += c
    if n == 0 or secs <= 0:
        return None
    return 100.0 * ctx["profiled_bounds"][bound_key] / secs
