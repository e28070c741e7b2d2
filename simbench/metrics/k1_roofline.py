"""K1 (the FSM kernel, Step 3): the profiled launches' least time by the
benchmark's count of their μPrograms' operations and row-file bytes, as a
percent of their device time in the trace."""
from simbench.harness.readers import roofline


def read(ctx):
    return roofline(ctx, "k1", ("uprog_execute",))
