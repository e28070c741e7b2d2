"""``lm_decode``: one caller sending greedy-decode requests to the port's LM.

Configuration (``kind`` ``lm``): the model's sizes (every key that is a
field of the port's ``ModelConfig`` replaces the port's configuration
``port_config``), ``moe_group``, the weights' ``init_std`` and
``embed_std``, its plain ``reference`` and, in that module, the
``control`` that stands in for the program.  Traffic: ``sampler``
(``host``: ``torch.argmax``; ``simdram``: the in-DRAM tournament on a
SimdramMachine of one bank a sequence), ``batch`` sequences a request,
``requests``: the set of ``[prompt tokens, new tokens]`` sizes, one
request each, ``check_requests`` requests compared with the reference,
``trace_steps`` decode steps profiled, and the checks' limits.

Closed loop: the window runs the set of requests in an order drawn from
the seed, again in a new order until ``seconds`` have passed, so every
run does whole sets; each request is one ``greedy_decode`` call on a
prompt of its size drawn on the device from the seed.  A CUDA event
recorded before each forward (by a forward pre-hook) marks the previous
token as done on the device, and one after the call the last; the gaps
between consecutive tokens are the token latencies.  Set-up draws the
weights and serves the largest prompt into the largest cache for two
tokens.

The check runs the reference over a sample of the requests, the one that
served most tokens and others drawn from the seed (prompt and served
tokens), and reads, for every served token, how far its reference logit
lies below the reference's best, in units of that position's spread of
reference logits over the vocabulary; the mean of those gaps and the
widest are compared with their limits.  With ``control`` the served
tokens are replaced, at each position of the same prompts and tokens, by
the first pick of the reference computed by the configuration's
``control`` (a lower precision).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import time

import torch

from simbench.counts import peaks
from simbench.counts.decode_flops import request_flops
from simbench.harness import lm_weights, seeds
from simbench.harness.profile import Trace
from simbench.harness.stats import percentile, rate


class Clock:
    """Marks on the device's stream (CUDA events), or the host's clock on
    the CPU."""

    def __init__(self, device) -> None:
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def model_config(config: dict):
    """The port's ModelConfig of ``config``: the port's configuration
    ``port_config`` with every field ``config`` gives replaced."""
    from repro_torch.configs import get_config
    base = get_config(config["port_config"])
    names = {f.name for f in dataclasses.fields(base)}
    return dataclasses.replace(
        base, **{k: v for k, v in config.items() if k in names
                 and k != "name"})


def served_gaps(ref: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """(best reference logit − reference logit of the served token) ÷ the
    reference logits' standard deviation at that position; ``ref`` (B, N,
    V), ``served`` (B, N)."""
    got = ref.gather(-1, served[..., None])[..., 0]
    return (ref.amax(-1) - got) / ref.std(-1)


@contextlib.contextmanager
def _hook(model, fn):
    h = model.register_forward_pre_hook(fn)
    try:
        yield
    finally:
        h.remove()


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, mark_window, control: bool = False) -> dict:
    from repro_torch.models.transformer import Transformer
    from repro_torch.ops import SimdramMachine
    from repro_torch.serve import decode as serve

    cfg = model_config(config)
    b, sizes = traffic["batch"], [tuple(x) for x in traffic["requests"]]
    sampler = traffic["sampler"]
    weights = lm_weights.draw(config, seed, device)
    model = Transformer(cfg, device="meta")
    model.load_state_dict(weights, strict=True, assign=True)
    machine = (SimdramMachine(banks=b, device=device)
               if sampler == "simdram" else None)
    longest = max(p for p, _ in sizes)
    prompts = torch.randint(0, cfg.vocab, (len(sizes), b, longest),
                            generator=seeds.torch_generator(seed, 3, device),
                            device=device)
    clock = Clock(device)
    marks: list = []

    def decode(i: int, steps: int | None = None, max_seq: int | None = None):
        s, n = sizes[i]
        return serve.greedy_decode(model, cfg, prompts[i, :, :s],
                                   steps=steps or n,
                                   max_seq=max_seq or s + n,
                                   sampler=sampler, machine=machine)

    # warm-up: the largest prompt into the largest cache, two tokens
    decode(max(range(len(sizes)), key=lambda i: sizes[i][0]), steps=2,
           max_seq=max(p + n for p, n in sizes))
    _sync(device)

    order = seeds.rng(seed, 5)
    requests = []
    with _hook(model, lambda *_: marks.append(clock.mark())):
        mark_window()
        t0 = time.perf_counter()
        while True:
            for i in order.permutation(len(sizes)):
                marks.clear()
                out = decode(int(i))
                marks.append(clock.mark())
                # marks[0] opens the prefill; marks[k] closes token k − 1
                requests.append((int(i), out, marks[1:]))
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
        wall = time.perf_counter() - t0
    gaps = [clock.ms(m[k], m[k + 1]) for _, _, m in requests
            for k in range(len(m) - 1)] * b
    pk = peaks()
    flops = [request_flops(config, b, p, n) for p, n in sizes]
    ctx = {"window_s": wall,
           "window_flops": sum(flops[i] for i, _, _ in requests),
           "bf16_flops_per_s": pk["bf16_flops_per_s"], "trace": None}
    if trace:
        ctx.update(_traced(model, decode, requests[0][0], traffic, device))
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    # the check: the reference over a sample of the served requests, the
    # one that served most tokens among them
    ref_mod = importlib.import_module(f"simbench.reference.{config['reference']}")
    most = max(range(len(requests)), key=lambda r: sizes[requests[r][0]][1])
    rest = [r for r in range(len(requests)) if r != most]
    pick = seeds.rng(seed, 4).choice(
        rest, size=min(traffic["check_requests"] - 1, len(rest)),
        replace=False)
    checked = []
    for r in sorted([most, *(int(x) for x in pick)]):
        i, served, _ = requests[r]
        s, n = sizes[i]
        toks = torch.cat([prompts[i, :, :s], served[:, :-1]], 1)
        pos = range(s - 1, s + n - 1)
        ref = ref_mod.logits(weights, config, toks, s, pos)
        picks = served
        if control:
            picks = ref_mod.logits(weights, config, toks, s, pos,
                                   matmul=getattr(ref_mod, config["control"])
                                   ).argmax(-1)
        checked.append(served_gaps(ref, picks).reshape(-1))
        del ref
    g = torch.cat(checked)
    lim = traffic["checks"]
    checks = {"mean_gap_sigma": (float(g.mean()), lim["mean_gap_sigma"]),
              "widest_gap_sigma": (float(g.max()), lim["widest_gap_sigma"])}
    n_tok = sum(sizes[i][1] for i, _, _ in requests) * b
    return {
        "e2e": {"decode_tokens_per_s": rate(n_tok, wall),
                "token_ms_p95": percentile(gaps, 95)},
        "ctx": ctx,
        "checks": checks,
        "correct": all(v <= t for v, t in checks.values()),
        "attempted": len(requests), "failed": 0,
        "memory_peak_bytes": peak,
        "notes": {"requests": len(requests), "gaps": len(gaps),
                  "token_ms_p50": percentile(gaps, 50),
                  "checked_tokens": g.numel(),
                  "tokens_off_best": int((g > 0).sum()),
                  "tokens_over_1_sigma": int((g > 1).sum())},
    }


def _traced(model, decode, i: int, traffic, device) -> dict:
    """A profile of ``trace_steps`` decode steps of request ``i``'s size,
    after the window."""
    out: dict = {}
    steps = traffic["trace_steps"]
    tr = Trace(device)
    count = [0]

    def step(*_):
        # forward 1 is the prefill: profile from forward 2 (the profiler's
        # warm-up), measure forwards 3 .. 2 + steps with their picks
        count[0] += 1
        if count[0] == 2:
            tr.start()
        elif count[0] == 3:
            tr.open_window()
        elif count[0] == 3 + steps:
            tr.close_window()
            out["trace"] = tr.stop()
    with _hook(model, step):
        decode(i, steps=steps + 3)
    if "trace" not in out:
        raise ValueError(f"{count[0]} forwards cannot cover {steps} "
                         "profiled steps")
    out["profiled_steps"] = steps
    return out
