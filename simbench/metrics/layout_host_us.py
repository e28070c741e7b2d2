"""Host microseconds a bbop spends in the transposition passes (K2, load
and store) over the profiled rounds: the program's ``layout.to_planes``
and ``layout.from_planes`` spans over its ``bbop`` spans."""
from simbench.harness.program import per_bbop_us


def read(ctx):
    return per_bbop_us("layout.to_planes", "layout.from_planes")
