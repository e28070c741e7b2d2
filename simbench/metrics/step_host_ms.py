"""Host milliseconds of one decode step over the profiled steps (its
forward and its pick): the mean length of the program's ``decode.step``
span."""
from simbench.harness.program import registry


def read(ctx):
    t = registry()
    n = t.span_count("decode.step") if t else 0
    return t.span_total_ns("decode.step") / n / 1e6 if n else None
