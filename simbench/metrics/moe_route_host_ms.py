"""Host milliseconds a forward spends routing its dropless MoE layers
(router, top-k, the sort of the token-expert pairs and their gather) over
the profiled steps: the program's ``models.moe.route`` spans over its
``models.forward`` spans; nothing where the program records no such
span."""
from simbench.harness.program import registry


def read(ctx):
    t = registry()
    n = t.span_count("models.forward") if t else 0
    if not n or not t.span_count("models.moe.route"):
        return None
    return t.span_total_ns("models.moe.route") / n / 1e6
