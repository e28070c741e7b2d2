"""K2 (the transposition kernels, load and store): the profiled passes'
least time, their values and planes each read once and written once, as a
percent of their device time in the trace."""
from simbench.harness.readers import roofline


def read(ctx):
    return roofline(ctx, "k2", ("to_planes", "from_planes"))
