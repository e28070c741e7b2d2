"""aten calls the host made a decode step over the profiled steps (nested
calls included), from the profiler's CPU events."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["aten_calls"]:
        return None
    return tr["aten_calls"] / ctx["profiled_steps"]
