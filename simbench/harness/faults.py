"""Faults planted in the port, to read what a check gives when the timed
path is broken (the tests at a small size, ``tools/readings.py`` at a
cell's own size).  None of them is reachable from a benchmark run."""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def one_token(steps: int):
    """One token altered where it is produced: in the first
    ``greedy_decode`` call of ``steps`` new tokens, the logits of the first
    sequence at the fifth forward (a decode step) are raised where the
    token half the vocabulary away from the program's pick lies, so that
    token is served in its place; every other token of the run is the
    program's.  The sample a run checks always holds a request of the
    most new tokens."""
    from repro_torch.serve import decode as serve
    inner = serve.greedy_decode
    done = [False]

    def faulty(model, cfg, prompt, **kw):
        if done[0] or kw.get("steps") != steps:
            return inner(model, cfg, prompt, **kw)
        done[0] = True
        count = [0]

        def alter(_mod, _args, out):
            count[0] += 1
            if count[0] != 5:
                return None
            logits = out[0].clone()
            row = logits[0, -1]
            tok = (int(row.argmax()) + row.shape[-1] // 2) % row.shape[-1]
            row[tok] = 2 * row.abs().max() + 1
            return (logits, *out[1:])
        h = model.register_forward_hook(alter)
        try:
            return inner(model, cfg, prompt, **kw)
        finally:
            h.remove()
    serve.greedy_decode = faulty
    try:
        yield
    finally:
        serve.greedy_decode = inner
