"""Model FLOPs of greedy decoding with a DeepSeek-V2 language model (MLA
and a dropless MoE), from the configuration's published keys.

The published math, not the program's: a token at a position that attends
``ctx`` keys costs, in each layer, its query projection, the joint latent
projection, the explicit ``w_uk``/``w_uv`` up-projections of its own
latent (its key and value, made once), the output projection, and
attention over its ``ctx`` keys (scores of ``qk_nope + qk_rope`` dims and
weighted values of ``v_head_dim``); then in the first
``first_k_dense_replace`` layers a SwiGLU of ``intermediate_size``, in the
others the router, ``num_experts_per_tok`` routed SwiGLU experts and the
shared experts.  Two FLOPs a multiply-add; norms, softmax and rope are
left out.  The LM head counts only where its logits are used: once a
sequence for the prefill's last position and once for each decode step.
"""
from __future__ import annotations


def _layer_parts(cfg: dict) -> tuple[int, int, int, int]:
    """(attention FLOPs a token outside the scores, those a key attended,
    a dense layer's FFN, a MoE layer's FFN)."""
    d, nh, r = (cfg["hidden_size"], cfg["num_attention_heads"],
                cfg["kv_lora_rank"])
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    proj = 2 * (d * nh * (dn + dr) + d * (r + dr) + r * nh * (dn + dv)
                + nh * dv * d)
    per_key = 2 * nh * (dn + dr + dv)
    dense = 3 * 2 * d * cfg["intermediate_size"]
    f = cfg["moe_intermediate_size"]
    moe = (2 * d * cfg["n_routed_experts"]
           + (cfg["num_experts_per_tok"] + cfg["n_shared_experts"])
           * 3 * 2 * d * f)
    return proj, per_key, dense, moe


def token_flops(cfg: dict, ctx: int) -> int:
    """FLOPs of one token through every layer, attending ``ctx`` keys."""
    proj, per_key, dense, moe = _layer_parts(cfg)
    n, k = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    return n * (proj + per_key * ctx) + k * dense + (n - k) * moe


def head_flops(cfg: dict) -> int:
    return 2 * cfg["hidden_size"] * cfg["vocab_size"]


def request_flops(cfg: dict, batch: int, prompt: int, new_tokens: int) -> int:
    """FLOPs of one ``greedy_decode`` of ``batch`` sequences: the prefill of
    ``prompt`` tokens and ``new_tokens - 1`` one-token steps, ``new_tokens``
    logit rows a sequence.  A token at position p attends p + 1 keys."""
    proj, per_key, _, _ = _layer_parts(cfg)
    tokens = prompt + new_tokens - 1
    keys = tokens * (tokens + 1) // 2          # Σ (p + 1), p < tokens
    fixed = token_flops(cfg, 0)
    return batch * (tokens * fixed
                    + cfg["num_hidden_layers"] * per_key * keys
                    + new_tokens * head_flops(cfg))


def active_params(cfg: dict) -> int:
    """Parameters one token passes through, the LM head included (for the
    2·N_active cross-check)."""
    proj, _, dense, moe = _layer_parts(cfg)
    n, k = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    return (n * proj + k * dense + (n - k) * moe) // 2 + (
        cfg["hidden_size"] * cfg["vocab_size"])
