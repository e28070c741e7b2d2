"""GB of latent cache (the normalised kv latent and the rope key) that the
one-token decode steps' attention reads, a forward over the whole run:
the program's ``models.mla.latent_bytes`` counter over its
``models.forwards``; nothing where the program counts no latent bytes."""
from simbench.harness.program import registry


def read(ctx):
    t = registry()
    n = t.counter("models.forwards") if t else 0
    b = t.counter("models.mla.latent_bytes") if t else 0
    return b / n / 1e9 if n and b else None
