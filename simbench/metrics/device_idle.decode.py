"""Percent of the traced decode steps in which the device ran nothing."""
from simbench.harness.readers import idle_share


def read(ctx):
    return idle_share(ctx)
