"""The program's own spans and counters (``repro_torch.telemetry``), as
the per-layer readers take them: nothing where the program has no
registry, as a program before it has none."""
from __future__ import annotations


def registry():
    """The program's telemetry module, or nothing."""
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    return telemetry


def per_bbop_us(*spans: str) -> float | None:
    """Host microseconds of the spans ``spans`` a ``bbop`` span, over the
    profiled rounds; nothing where no bbop was recorded."""
    t = registry()
    n = t.span_count("bbop") if t else 0
    if not n:
        return None
    return sum(t.span_total_ns(s) for s in spans) / n / 1e3
