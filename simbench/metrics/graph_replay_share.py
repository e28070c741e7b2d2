"""Share of the run's forwards that were one CUDA graph replay each (the
models layer's captured one-token decode step): the program's
``models.graph.replays`` counter over its ``models.forwards``; nothing
where the program replays no graph."""
from simbench.harness.program import registry


def read(ctx):
    t = registry()
    n = t.counter("models.forwards") if t else 0
    r = t.counter("models.graph.replays") if t else 0
    return r / n if n and r else None
