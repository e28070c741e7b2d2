"""Seconds of the cell's μProgram compiles (Steps 1-2) in set-up: the
benchmark's span around the μProgram Memory's first fetch of each op."""


def read(ctx):
    return ctx["spans"].get("uprog_compile")
