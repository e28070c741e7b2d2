"""Host milliseconds a forward spends in its latent attention's one-token
decode over the profiled steps: the program's ``models.mla.decode`` spans
over its ``models.forward`` spans; nothing where the program records no
such span."""
from simbench.harness.program import registry


def read(ctx):
    t = registry()
    n = t.span_count("models.forward") if t else 0
    if not n or not t.span_count("models.mla.decode"):
        return None
    return t.span_total_ns("models.mla.decode") / n / 1e6
