"""kimi-linear-48b-a3b [hybrid_moe] — 27 layers (``kimi_linear``): 20
Kimi Delta Attention layers (32 heads, keys and values of 128, short
convolutions of 4 taps, a channel-wise decay from a low-rank gate) and 7
MLA layers without positions (32 heads, latent 512 with its norm, no q
compression, nope 128 + 64, values 128); layer 1 a dense SwiGLU of 9,216,
the others 256 sigmoid-routed SwiGLU experts of 1,024 (top-8 of score +
correction bias, gates renormalised × 2.446) and one shared; d_model
2,304, vocab 163,840, untied head.  49.12 B parameters whole; this chip
holds experts 0–63 of each MoE layer (four H100s share each by expert
parallelism, the router keeps 256): 13,789,864,832, in bf16.
[https://huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct]

Each published layer is two blocks of the hybrid stack: its mixer (``K``
or ``L``), then its FFN (``D`` or ``E``).  Port only: the reference has
no such config, so it stays out of ``ARCHS`` and
``get_config("kimi-linear-48b-a3b")`` finds it by its alias."""
import dataclasses

from .base import KimiLinearConfig

FULL_ATTN_LAYERS = (4, 8, 12, 16, 20, 24, 27)     # 1-based, the rest KDA


def block_pattern(n_layers: int, full_attn=FULL_ATTN_LAYERS,
                  dense: int = 1) -> str:
    """Two letters a layer: ``L`` (MLA) or ``K`` (KDA), then ``D`` for the
    first ``dense`` layers and ``E`` for the others."""
    return "".join(("L" if i in full_attn else "K") + ("D" if i <= dense
                                                       else "E")
                   for i in range(1, n_layers + 1))


CONFIG = KimiLinearConfig(
    name="kimi-linear-48b-a3b", family="hybrid_moe", n_layers=54,
    d_model=2304, n_heads=32, n_kv_heads=32, head_dim=128, d_ff=9216,
    vocab=163840, rope="none", norm_eps=1e-5,
    moe=True, n_experts=256, experts_per_tok=8, d_expert=1024,
    n_shared_experts=1,
    mla=True, kv_lora_rank=512, q_lora_rank=0, rope_head_dim=64,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    kv_cache_dtype="bfloat16",
    block_pattern=block_pattern(27), ffn_act="swiglu",
    routed_scaling=2.446, shared_expert_width=1024,
    experts_held=64, first_expert=0,
    kda_heads=32, kda_head_dim=128,
)


def reduced() -> KimiLinearConfig:
    """Layers KDA+dense, KDA+MoE, MLA+MoE, KDA+MoE at toy widths: KDA 4
    heads of 8, MLA 4 heads (nope 8 + 8, latent 16), 4 of 8 experts held
    (top-3) and a shared expert; every mechanism of ``CONFIG`` kept."""
    return dataclasses.replace(
        CONFIG, name="kimi-linear-48b-a3b-reduced", n_layers=8,
        block_pattern=block_pattern(4, full_attn=(3,)), d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=8, d_ff=96, vocab=256,
        n_experts=8, experts_per_tok=3, d_expert=32, kv_lora_rank=16,
        rope_head_dim=8, shared_expert_width=32, experts_held=4,
        kda_heads=4, kda_head_dim=8)
