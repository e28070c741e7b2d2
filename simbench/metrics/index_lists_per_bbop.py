"""Host-built index lists a bbop indexes its row file with (each one
pageable host-to-device copy on the card), over the whole run: the
program's ``kernels.index_lists`` counter over its ``ops.bbops``."""
from simbench.harness.program import registry


def read(ctx):
    t = registry()
    n = t.counter("ops.bbops") if t else 0
    return t.counter("kernels.index_lists") / n if n else None
