"""Model FLOPs of greedy decoding with a ``nemotron_h`` hybrid (Mamba-2,
MoE and attention blocks), from the configuration's published keys.

The published math, not the program's: a token costs, in each ``M``
block, the input and output projections, the depthwise conv and the SSD
in its recurrent form (each element of the state decayed, given its
input and read out: 5 FLOPs); in each ``E`` block the router over all the
router's experts, its ``num_experts_per_tok`` routed relu² experts (an up
and a down product each) and the shared expert; in each ``*`` block the
q/k/v/o projections and attention over its ``ctx`` keys (scores and
weighted values).  Where the file holds a share of the experts
(``expert_share``), the routed pairs counted are the share of them that
this chip's experts take on average: ``num_experts_per_tok`` × held ÷
the router's experts (× 64/128 in the cell), so the count is this chip's
work and not the deployment's.  Two FLOPs a multiply-add; norms, gates,
activations and softmax are left out.  The LM head counts only where its
logits are used: once a sequence for the prefill's last position and once
for each decode step.
"""
from __future__ import annotations

from simbench.reference.hybrid_moe_lm import expert_share


def _block_parts(cfg: dict) -> tuple[int, int, int, int]:
    """(an M block's FLOPs a token, an E block's, a * block's outside the
    scores, a * block's a key attended)."""
    d = cfg["hidden_size"]
    nh, p = cfg["mamba_num_heads"], cfg["mamba_head_dim"]
    di = nh * p
    ch = di + 2 * cfg["n_groups"] * cfg["ssm_state_size"]
    ssm = (2 * d * (di + ch + nh) + 2 * di * d + 2 * cfg["conv_kernel"] * ch
           + 5 * di * cfg["ssm_state_size"])
    width, _, held = expert_share(cfg)
    pairs = cfg["num_experts_per_tok"] * held / width
    moe = (2 * d * width
           + pairs * 2 * 2 * d * cfg["moe_intermediate_size"]
           + 2 * 2 * d * cfg["moe_shared_expert_intermediate_size"])
    hq, hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"])
    attn = 2 * d * hd * (2 * hq + 2 * hkv)
    per_key = 2 * 2 * hq * hd
    return ssm, moe, attn, per_key


def _counts(cfg: dict) -> tuple[int, int, int]:
    pattern = cfg["hybrid_override_pattern"]
    return pattern.count("M"), pattern.count("E"), pattern.count("*")


def token_flops(cfg: dict, ctx: int) -> float:
    """FLOPs of one token through every block, attending ``ctx`` keys."""
    ssm, moe, attn, per_key = _block_parts(cfg)
    m, e, a = _counts(cfg)
    return m * ssm + e * moe + a * (attn + per_key * ctx)


def head_flops(cfg: dict) -> int:
    return 2 * cfg["hidden_size"] * cfg["vocab_size"]


def request_flops(cfg: dict, batch: int, prompt: int,
                  new_tokens: int) -> float:
    """FLOPs of one ``greedy_decode`` of ``batch`` sequences: the prefill of
    ``prompt`` tokens and ``new_tokens - 1`` one-token steps, ``new_tokens``
    logit rows a sequence.  A token at position p attends p + 1 keys."""
    *_, per_key = _block_parts(cfg)
    tokens = prompt + new_tokens - 1
    keys = tokens * (tokens + 1) // 2          # Σ (p + 1), p < tokens
    return batch * (tokens * token_flops(cfg, 0)
                    + _counts(cfg)[2] * per_key * keys
                    + new_tokens * head_flops(cfg))
