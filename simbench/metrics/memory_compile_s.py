"""Seconds the μProgram Memory spent compiling, lowering and linting its
misses (Steps 1-2) over the whole run: the program's
``memory.compile_ns`` counter."""
from simbench.harness.program import registry


def read(ctx):
    t = registry()
    return t.counter("memory.compile_ns") / 1e9 if t else None
