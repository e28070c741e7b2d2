"""``hybrid_moe_decode``: one caller sending greedy-decode requests to the
port's ``nemotron_h`` hybrid (Mamba-2, MoE and attention blocks).

Configuration (``kind`` ``lm``): the published keys of the model's
``config.json`` (``hidden_size``, ``hybrid_override_pattern``,
``mamba_num_heads``, ...), ``expert_share`` where the chip holds a share
of the experts (``n_routed_experts`` of the router's
``published_n_routed_experts``, from ``first_expert``), the port's
configuration ``port_config`` whose sizes they replace
(:func:`port_config`), the storage and compute dtypes, the weights'
initialisation (:mod:`simbench.harness.hybrid_moe_weights`), its plain
``reference`` and, in that module, the ``control`` that stands in for the
program.  Traffic as ``lm_decode``'s: ``sampler``, ``batch`` sequences a
request, ``requests`` (``[prompt tokens, new tokens]``),
``check_requests``, ``trace_steps`` and the checks' limits.

:func:`decode_run` is the run of any LM cell whose reference takes
``(weights, config, tokens, positions, matmul)``: it is given the port's
config, the weights drawer, ``request_flops`` and the reference module.
Closed loop, whole sets of the requests in orders drawn from the seed,
token gaps between CUDA events recorded before each forward, set-up
serving the largest prompt into the largest cache for two tokens; then
the reference over a sample of the served requests, each served token's
gap below the reference's best in σ of that position's reference logits
(with ``control``, the control's picks in place of the served tokens).

Given ``routes`` (a model whose MoE blocks choose their experts hard, as
``nemotron_h``'s do), the reference computes the checked tokens with the
program's own expert choices, recomputed after the window exactly as
they were served (:func:`program_routes`), and the check adds the widest
shortfall of those choices below the reference's own
(``widest_route_shortfall``, in sigmoid scores): so a token whose experts
a rounding flipped is held to its own experts' output, and a wrong
choice shows by its shortfall.  The control then follows its own
choices.
"""
from __future__ import annotations

import dataclasses
import importlib
import time

import torch

from simbench.counts import peaks
from simbench.counts.hybrid_moe_flops import request_flops
from simbench.drivers.lm_decode import (Clock, _hook, _sync, _traced,
                                        model_config, served_gaps)
from simbench.harness import hybrid_moe_weights, seeds
from simbench.harness.stats import percentile, rate
from simbench.reference.hybrid_moe_lm import expert_share

# published key → the port's NemotronHConfig field of the same size
PORT_FIELDS = {
    "num_hidden_layers": "n_layers", "hidden_size": "d_model",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "head_dim": "head_dim", "vocab_size": "vocab",
    "layer_norm_epsilon": "norm_eps", "tie_word_embeddings": "tie_embeddings",
    "num_experts_per_tok": "experts_per_tok",
    "moe_intermediate_size": "d_expert",
    "moe_shared_expert_intermediate_size": "shared_expert_width",
    "routed_scaling_factor": "routed_scaling",
    "mamba_num_heads": "ssm_heads", "mamba_head_dim": "ssm_head_dim",
    "n_groups": "ssm_groups", "ssm_state_size": "ssm_state",
    "chunk_size": "ssm_chunk", "use_conv_bias": "conv_bias",
    "hybrid_override_pattern": "block_pattern",
}
# published settings the port computes only at these values
FIXED = {"model_type": "nemotron_h", "n_group": 1, "topk_group": 1,
         "norm_topk_prob": True, "n_shared_experts": 1,
         "mlp_hidden_act": "relu2", "mamba_hidden_act": "silu",
         "conv_kernel": 4, "attention_bias": False, "mlp_bias": False,
         "use_bias": False, "mamba_proj_bias": False,
         "residual_in_fp32": False, "sliding_window": None}


def port_config(config: dict):
    """The port's config of ``config``: ``lm_decode.model_config`` (the
    port's ``port_config`` with the fields ``config`` names replaced),
    then every published size in its port field and the expert share.
    Raises where the program lacks the configuration, before anything is
    drawn."""
    for key, want in FIXED.items():
        if config.get(key, want) != want:
            raise ValueError(f"{key} = {config[key]!r}: the port computes "
                             f"{want!r} only")
    if config["norm_eps"] != config["layer_norm_epsilon"]:
        raise ValueError("norm_eps and layer_norm_epsilon differ: the port "
                         "has one epsilon")
    if len(config["hybrid_override_pattern"]) != config["num_hidden_layers"]:
        raise ValueError("hybrid_override_pattern has not one letter a "
                         "layer")
    base = model_config(config)
    sizes = {field: config[key] for key, field in PORT_FIELDS.items()}
    width, first, held = expert_share(config)
    sizes.update(n_experts=width, experts_held=held, first_expert=first)
    return dataclasses.replace(base, **sizes)


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, mark_window, control: bool = False) -> dict:
    return decode_run(
        config, traffic, seed, seconds, trace, device, mark_window, control,
        cfg=port_config(config), draw=hybrid_moe_weights.draw,
        request_flops=request_flops,
        reference=importlib.import_module(
            f"simbench.reference.{config['reference']}"),
        routes=program_routes)


def program_routes(model, cfg, prompt, served, max_seq: int):
    """The program's expert choices over ``prompt`` and ``served[:, :-1]``:
    one (B, T, k) tensor of expert ids a ``SigmoidMoE`` block, in the
    model's order (the pattern's), recomputed as ``greedy_decode`` served
    them: the prefill through fresh caches of ``max_seq``, then the served
    tokens one step at a time, the first step's graph captured and the
    rest replayed.  Each block's ``route`` is wrapped to keep its choices:
    an eager forward's are its own tensors (a capture's real step runs
    eagerly, then is recorded); a replay's are read from the tensors the
    recording holds, which each replay refills.  Also returns how many
    served tokens are not the argmax of the recomputed logits (none, for a
    program whose forwards are deterministic)."""
    from repro_torch.models.layers import SigmoidMoE
    from repro_torch.models.transformer import init_caches
    from repro_torch.serve.decode import make_prefill, make_serve_step

    moes = [m for m in model.modules() if isinstance(m, SigmoidMoE)]
    e = len(moes)
    log: list = []

    def keep(inner):
        def route(tokens):
            out = inner(tokens)
            log.append(out[2])
            return out
        return route
    for m in moes:
        m.route = keep(m.route)
    recorded: list = []

    def choices():
        new = log[:]
        log.clear()
        if len(new) == 2 * e:          # a capture: its real step, recorded
            recorded[:] = new[e:]
            return new[:e]
        return new or [t.clone() for t in recorded]
    b, n = served.shape
    forwards, off = [], 0
    try:
        caches = init_caches(cfg, b, max_seq, device=model.device)
        logits, caches = make_prefill(cfg)(model, {"tokens": prompt}, caches)
        forwards.append(choices())
        step = make_serve_step(cfg)
        for k in range(n):
            off += int((logits[:, -1].argmax(-1) != served[:, k]).sum())
            if k < n - 1:
                logits, caches = step(model, caches,
                                      {"tokens": served[:, k:k + 1]})
                forwards.append(choices())
    finally:
        for m in moes:
            del m.route
    return [torch.cat([f[i].reshape(b, -1, f[i].shape[-1]) for f in forwards],
                      1) for i in range(e)], off


def decode_run(config: dict, traffic: dict, seed: int, seconds: float,
               trace: bool, device, mark_window, control: bool, *, cfg,
               draw, request_flops, reference, routes=None) -> dict:
    """One run of an LM cell: ``cfg`` the port's config, ``draw(config,
    seed, device)`` the weights by the port's names, ``request_flops(config,
    batch, prompt, new)`` a request's model FLOPs, ``reference`` the module
    whose ``logits(weights, config, tokens, positions, matmul=...)`` and
    ``config["control"]`` check the served tokens; ``routes``, where given,
    the program's expert choices (:func:`program_routes`), which the
    reference then follows (its ``Routing``)."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.ops import SimdramMachine
    from repro_torch.serve import decode as serve

    b, sizes = traffic["batch"], [tuple(x) for x in traffic["requests"]]
    sampler = traffic["sampler"]
    weights = draw(config, seed, device)
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
                requests.append((int(i), out, marks[:]))
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
        wall = time.perf_counter() - t0
    prefill_ms = [clock.ms(m[0], m[1]) for _, _, m in requests]
    gaps = [clock.ms(m[k], m[k + 1]) for _, _, m in requests
            for k in range(1, len(m) - 1)]
    steps_ms = sum(gaps)
    gaps *= b
    flops = [request_flops(config, b, p, n) for p, n in sizes]
    ctx = {"window_s": wall,
           "window_flops": sum(flops[i] for i, _, _ in requests),
           "bf16_flops_per_s": peaks()["bf16_flops_per_s"], "trace": None}
    if trace:
        ctx.update(_traced(model, decode, requests[0][0], traffic, device))
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.empty_cache()

    # the check: the reference over a sample of the served requests, the
    # one that served most tokens among them
    most = max(range(len(requests)), key=lambda r: sizes[requests[r][0]][1])
    rest = [r for r in range(len(requests)) if r != most]
    pick = seeds.rng(seed, 4).choice(
        rest, size=min(traffic["check_requests"] - 1, len(rest)),
        replace=False)
    checked, short, off = [], [], 0
    for r in sorted([most, *(int(x) for x in pick)]):
        i, served, _ = requests[r]
        s, n = sizes[i]
        toks = torch.cat([prompts[i, :, :s], served[:, :-1]], 1)
        pos = range(s - 1, s + n - 1)
        follow = {}
        if routes is not None and not control:
            given, wrong = routes(model, cfg, prompts[i, :, :s], served, s + n)
            off += wrong
            follow = {"routing": reference.Routing(given=given)}
        picks = served
        if control:
            own = {} if routes is None else {"routing": reference.Routing()}
            picks = reference.logits(
                weights, config, toks, pos,
                matmul=getattr(reference, config["control"]),
                **own).argmax(-1)
            if own:
                follow = {"routing": reference.Routing(
                    given=own["routing"].chosen)}
        ref = reference.logits(weights, config, toks, pos, **follow)
        checked.append(served_gaps(ref, picks).reshape(-1))
        if follow:
            short += follow["routing"].shortfall
        del ref, follow
    g = torch.cat(checked)
    lim = traffic["checks"]
    checks = {"mean_gap_sigma": (float(g.mean()), lim["mean_gap_sigma"]),
              "widest_gap_sigma": (float(g.max()), lim["widest_gap_sigma"])}
    if routes is not None:
        checks["widest_route_shortfall"] = (max(short),
                                            lim["widest_route_shortfall"])
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
                  "sets": len(requests) / len(sizes),
                  "prefill_s": sum(prefill_ms) / 1e3,
                  "steps_s": steps_ms / 1e3,
                  "checked_tokens": g.numel(),
                  "tokens_off_best": int((g > 0).sum()),
                  "tokens_over_1_sigma": int((g > 1).sum()),
                  "served_not_argmax": off},
    }
