"""Model FLOPs of greedy decoding with a ``kimi_linear`` model (KDA and
MLA layers, a dense layer and sigmoid-routed SwiGLU experts), from the
configuration's published keys.

The published math, not the program's: a token costs, in each KDA layer,
its input projections (q, k, v, the gates' low-rank f_a and g_a, β), the
gates' up-projections f_b and g_b, the output projection, the three
depthwise convs and the delta rule over its K × V state a head: in a
multi-token forward the chunked form at the published kernel's chunk of
``CHUNK`` positions (the decayed k·k and q·k products of a chunk, its
triangular solve for the updates and the decayed keys, the products with
the entering state, the updates' part of the outputs and of the leaving
state: C·(3K + 2V) + 6·K·V a head), in a one-token step the recurrence
(the decay, Sᵀk, the rank-one update and Sᵀq: 7·K·V a head); in each MLA
layer the query and joint latent projections, the explicit ``w_uk``/
``w_uv`` up-projections of its own latent, the output projection and
attention over its ``ctx`` keys (``mla_moe_flops``'s count); then the
dense SwiGLU of ``intermediate_size`` in the first
``first_k_dense_replace`` layers, in the others the router over all the
router's experts, the ``num_experts_per_token`` routed SwiGLU experts and
the shared experts.  Where the file holds a share of the experts
(``expert_share``), the routed pairs counted are the share of them that
this chip's experts take on average: ``num_experts_per_token`` × held ÷
the router's experts (× 64/256 in the cell).  Two FLOPs a multiply-add;
norms, gates, activations and softmax are left out.  The LM head counts
only where its logits are used: once a sequence for the prefill's last
position and once for each decode step.
"""
from __future__ import annotations

from simbench.reference.kimi_linear_lm import expert_share

CHUNK = 64          # fla's chunk_kda, the released model's kernel


def _parts(cfg: dict) -> dict[str, float]:
    """FLOPs a token of each part: a KDA layer outside the delta rule,
    its delta rule chunked and recurrent, an MLA layer outside the
    scores, an MLA layer a key attended, the dense FFN, a MoE FFN."""
    d = cfg["hidden_size"]
    lc = cfg["linear_attn_config"]
    h, k = lc["num_heads"], lc["head_dim"]
    w = h * k
    kda = (2 * d * (3 * w + 2 * k + h) + 2 * 2 * k * w + 2 * w * d
           + 2 * lc["short_conv_kernel_size"] * 3 * w)
    nh, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    mla = 2 * (d * nh * (dn + dr) + d * (r + dr) + r * nh * (dn + dv)
               + nh * dv * d)
    width, _, held = expert_share(cfg)
    f = cfg["moe_intermediate_size"]
    pairs = cfg["num_experts_per_token"] * held / width
    moe = (2 * d * width + pairs * 3 * 2 * d * f
           + cfg["num_shared_experts"] * 3 * 2 * d * f)
    return {"kda": kda,
            "rule_chunked": h * (CHUNK * (3 * k + 2 * k) + 6 * k * k),
            "rule_step": h * 7 * k * k,
            "mla": mla, "per_key": 2 * nh * (dn + dr + dv),
            "dense": 3 * 2 * d * cfg["intermediate_size"], "moe": moe}


def _counts(cfg: dict) -> tuple[int, int, int, int]:
    """(KDA layers, MLA layers, dense FFNs, MoE FFNs)."""
    n = cfg["num_hidden_layers"]
    kda = len(cfg["linear_attn_config"]["kda_layers"])
    dense = cfg["first_k_dense_replace"]
    return kda, n - kda, dense, n - dense


def token_flops(cfg: dict, ctx: int, step: bool = False) -> float:
    """FLOPs of one token through every layer, attending ``ctx`` keys: of
    a one-token step (``step``, the recurrence) or of a multi-token
    forward (the chunked rule)."""
    p = _parts(cfg)
    kda, mla, dense, moe = _counts(cfg)
    rule = p["rule_step"] if step else p["rule_chunked"]
    return (kda * (p["kda"] + rule) + mla * (p["mla"] + p["per_key"] * ctx)
            + dense * p["dense"] + moe * p["moe"])


def head_flops(cfg: dict) -> int:
    return 2 * cfg["hidden_size"] * cfg["vocab_size"]


def request_flops(cfg: dict, batch: int, prompt: int,
                  new_tokens: int) -> float:
    """FLOPs of one ``greedy_decode`` of ``batch`` sequences: the prefill of
    ``prompt`` tokens and ``new_tokens - 1`` one-token steps, ``new_tokens``
    logit rows a sequence.  A token at position p attends p + 1 keys."""
    p = _parts(cfg)
    tokens = prompt + new_tokens - 1
    keys = tokens * (tokens + 1) // 2          # Σ (p + 1), p < tokens
    return batch * (prompt * token_flops(cfg, 0)
                    + (new_tokens - 1) * token_flops(cfg, 0, step=True)
                    + _counts(cfg)[1] * p["per_key"] * keys
                    + new_tokens * head_flops(cfg))
