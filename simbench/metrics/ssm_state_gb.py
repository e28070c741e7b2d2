"""GB of Mamba-2 state and conv window that the cached forwards read and
write, a forward over the whole run: the program's
``models.ssm.state_bytes`` counter over its ``models.forwards``; nothing
where the program counts no state bytes."""
from simbench.harness.program import registry


def read(ctx):
    t = registry()
    n = t.counter("models.forwards") if t else 0
    b = t.counter("models.ssm.state_bytes") if t else 0
    return b / n / 1e9 if n and b else None
