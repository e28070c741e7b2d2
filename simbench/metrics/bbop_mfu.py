"""The bbop stream's share of the chip's peak: the least time of every op
the window completed (its μProgram's operations over the INT32 rate, or its
operands read and result written over the HBM rate, whichever is larger),
over the window's wall time, in percent."""


def read(ctx):
    if ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["window_least_s"] / ctx["window_s"]
