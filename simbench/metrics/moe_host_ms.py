"""Host milliseconds a forward spends in its blocks' FFNs (OLMoE's MoE)
over the profiled steps: the program's ``models.ffn`` spans over its
``models.forward`` spans."""
from simbench.harness.program import registry


def read(ctx):
    t = registry()
    n = t.span_count("models.forward") if t else 0
    return t.span_total_ns("models.ffn") / n / 1e6 if n else None
