"""Share of the run's one-token attention calls that launched the port's
decode-attention kernel: the program's ``kernels.decode_attn`` counter over
its ``models.attn.one_token``; nothing where the program makes no
one-token attention call or counts none."""
from simbench.harness.program import registry


def read(ctx):
    t = registry()
    n = t.counter("models.attn.one_token") if t else 0
    return t.counter("kernels.decode_attn") / n if n else None
