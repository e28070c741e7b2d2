"""Host microseconds of one bbop over the profiled rounds: the mean
length of the program's ``bbop`` span (a public ``bbop_*`` call, entry to
return, the profiler's own cost included)."""
from simbench.harness.program import per_bbop_us


def read(ctx):
    return per_bbop_us("bbop")
