"""``mla_moe_decode``: one caller sending greedy-decode requests to the
port's DeepSeek-V2 model (latent attention, dropless MoE).

Configuration (``kind`` ``lm``): the published keys of the model's
``config.json`` (``hidden_size``, ``kv_lora_rank``, ``rope_scaling``, ...),
the port's configuration ``port_config`` whose sizes they replace
(:func:`port_config`), the storage and compute dtypes, the weights'
``init_std`` and ``embed_std``, its plain ``reference`` and, in that
module, the ``control`` that stands in for the program.  Traffic as
``lm_decode``'s: ``sampler``, ``batch`` sequences a request, ``requests``
(``[prompt tokens, new tokens]``), ``check_requests``, ``trace_steps`` and
the checks' limits.

The run is ``lm_decode``'s, with this model's weights (one bfloat16
buffer, :mod:`simbench.harness.mla_moe_weights`) and FLOP count
(:mod:`simbench.counts.mla_moe_flops`): closed loop, whole sets of the
requests in orders drawn from the seed, token gaps between CUDA events
recorded before each forward, set-up serving the largest prompt into the
largest cache for two tokens; then the reference over a sample of the
served requests, each served token's gap below the reference's best in σ
of that position's reference logits (with ``control``, the control's
picks in place of the served tokens).
"""
from __future__ import annotations

import dataclasses
import importlib
import time

import torch

from simbench.counts import peaks
from simbench.counts.mla_moe_flops import request_flops
from simbench.drivers.lm_decode import (Clock, _hook, _sync, _traced,
                                        model_config, served_gaps)
from simbench.harness import mla_moe_weights, seeds
from simbench.harness.stats import percentile, rate

# published key → the port's ModelConfig field of the same size
PORT_FIELDS = {
    "num_hidden_layers": "n_layers", "hidden_size": "d_model",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "qk_nope_head_dim": "head_dim", "intermediate_size": "d_ff",
    "vocab_size": "vocab", "rms_norm_eps": "norm_eps",
    "tie_word_embeddings": "tie_embeddings",
    "n_routed_experts": "n_experts", "num_experts_per_tok": "experts_per_tok",
    "moe_intermediate_size": "d_expert", "qk_rope_head_dim": "rope_head_dim",
    "first_k_dense_replace": "first_k_dense",
}
# published settings the port computes only at these values (of
# ``rope_scaling`` too, besides the factor and ``mscale``)
FIXED = {"routed_scaling_factor": 1, "scoring_func": "softmax",
         "topk_method": "greedy", "moe_layer_freq": 1, "n_group": 1,
         "topk_group": 1, "hidden_act": "silu", "attention_bias": False}
FIXED_YARN = {"type": "yarn", "original_max_position_embeddings": 4096,
              "beta_fast": 32, "beta_slow": 1}


def port_config(config: dict):
    """The port's config of ``config``: ``lm_decode.model_config`` (the
    port's ``port_config`` with the fields ``config`` names replaced),
    then every published size in its port field.  Raises where the
    program lacks the configuration, before anything is drawn."""
    rs = config["rope_scaling"]
    for where, fixed in ((config, FIXED), (rs, FIXED_YARN)):
        for key, want in fixed.items():
            if where.get(key, want) != want:
                raise ValueError(f"{key} = {where[key]!r}: the port "
                                 f"computes {want!r} only")
    if rs["mscale"] != rs["mscale_all_dim"]:
        raise ValueError("rope_scaling's mscale and mscale_all_dim differ: "
                         "the port's rope has no cos/sin factor")
    if config["v_head_dim"] != config["qk_nope_head_dim"]:
        raise ValueError("the port's MLA has one head dim for keys and "
                         "values")
    base = model_config(config)
    sizes = {field: config[key] for key, field in PORT_FIELDS.items()}
    sizes["q_lora_rank"] = config["q_lora_rank"] or 0
    sizes.update(yarn_factor=rs["factor"], yarn_mscale=rs["mscale"])
    return dataclasses.replace(base, **sizes)


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, mark_window, control: bool = False) -> dict:
    from repro_torch.models.transformer import Transformer
    from repro_torch.ops import SimdramMachine
    from repro_torch.serve import decode as serve

    cfg = port_config(config)
    b, sizes = traffic["batch"], [tuple(x) for x in traffic["requests"]]
    sampler = traffic["sampler"]
    weights = mla_moe_weights.draw(config, seed, device)
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
        ref = ref_mod.logits(weights, config, toks, pos)
        picks = served
        if control:
            picks = ref_mod.logits(weights, config, toks, pos,
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
                  "sets": len(requests) / len(sizes),
                  "prefill_s": sum(prefill_ms) / 1e3,
                  "steps_s": steps_ms / 1e3,
                  "checked_tokens": g.numel(),
                  "tokens_off_best": int((g > 0).sum()),
                  "tokens_over_1_sigma": int((g > 1).sum())},
    }
