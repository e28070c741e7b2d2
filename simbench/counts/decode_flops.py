"""Model FLOPs of greedy decoding with an attention MoE LM, from the
configuration's shapes.

A token at a position that attends ``ctx`` keys costs, in each layer, the
four attention projections, the router, ``experts_per_tok`` SwiGLU experts
(three matrices each) and the attention over its ``ctx`` keys (scores and
weighted values); two FLOPs a multiply-add.  The LM head counts only where
its logits are used: once a sequence for the prefill's last position and
once for each decode step.
"""
from __future__ import annotations


def _head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def token_flops(cfg: dict, ctx: int) -> int:
    """FLOPs of one token through every layer, attending ``ctx`` keys."""
    d, hd = cfg["d_model"], _head_dim(cfg)
    nh, nkv = cfg["n_heads"], cfg["n_kv_heads"]
    proj = 2 * d * hd * (2 * nh + 2 * nkv)
    router = 2 * d * cfg["n_experts"]
    experts = cfg["experts_per_tok"] * 3 * 2 * d * cfg["d_expert"]
    attn = 4 * nh * hd * ctx
    return cfg["n_layers"] * (proj + router + experts + attn)


def head_flops(cfg: dict) -> int:
    return 2 * cfg["d_model"] * cfg["vocab"]


def request_flops(cfg: dict, batch: int, prompt: int, new_tokens: int) -> int:
    """FLOPs of one ``greedy_decode`` of ``batch`` sequences: the prefill of
    ``prompt`` tokens and ``new_tokens - 1`` one-token steps, ``new_tokens``
    logit rows a sequence."""
    prefill = sum(token_flops(cfg, p + 1) for p in range(prompt))
    decode = sum(token_flops(cfg, prompt + t + 1)
                 for t in range(new_tokens - 1))
    return batch * (prefill + decode + new_tokens * head_flops(cfg))


def active_params(cfg: dict) -> int:
    """Parameters one token passes through, the LM head included (for the
    2·N_active cross-check)."""
    d, hd = cfg["d_model"], _head_dim(cfg)
    per_layer = (d * hd * (2 * cfg["n_heads"] + 2 * cfg["n_kv_heads"])
                 + d * cfg["n_experts"]
                 + cfg["experts_per_tok"] * 3 * d * cfg["d_expert"])
    return cfg["n_layers"] * per_layer + d * cfg["vocab"]
