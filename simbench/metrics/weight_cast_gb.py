"""GB a forward reads and writes casting its weights to the compute dtype
at their use, over the whole run: the program's
``models.weight_cast_bytes`` counter over its ``models.forwards``."""
from simbench.harness.program import registry


def read(ctx):
    t = registry()
    n = t.counter("models.forwards") if t else 0
    return t.counter("models.weight_cast_bytes") / n / 1e9 if n else None
