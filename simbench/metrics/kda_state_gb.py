"""GB of KDA state and conv window that the cached forwards read and
write, a forward over the whole run: the program's
``models.kda.state_bytes`` counter over its ``models.forwards``; nothing
where the program counts no KDA state bytes."""
from simbench.harness.program import registry


def read(ctx):
    t = registry()
    n = t.counter("models.forwards") if t else 0
    b = t.counter("models.kda.state_bytes") if t else 0
    return b / n / 1e9 if n and b else None
