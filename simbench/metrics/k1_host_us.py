"""Host microseconds a bbop spends on the FSM kernel's whole path over the
profiled rounds: the program's ``kernels.run_trace`` spans over its
``bbop`` spans.  That path is the row file's build, K1's launch and the
output gather, not K1's launch alone (the ``kernels.k1`` span)."""
from simbench.harness.program import per_bbop_us


def read(ctx):
    return per_bbop_us("kernels.run_trace")
