"""Host microseconds a bbop spends metering its modeled DRAM cost over the
profiled rounds: the program's ``machine.meter`` spans over its ``bbop``
spans."""
from simbench.harness.program import per_bbop_us


def read(ctx):
    return per_bbop_us("machine.meter")
