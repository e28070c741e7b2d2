"""deepseek-v2-lite [moe] — MLA (kv_lora=512, no q compression, latent
RMSNorm, YaRN ×40 over 4,096 positions), a leading dense layer of 10,944,
then 26 layers of 64 routed experts (dropless top-6, gates not
renormalised) and 2 shared; 15.71 B parameters held in bf16.
[arXiv:2405.04434; https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite]

Port only: the reference has no such config, so it stays out of ``ARCHS``
and ``get_config("deepseek-v2-lite")`` finds it by its alias."""
import dataclasses

from .base import DeepSeekV2Config

CONFIG = DeepSeekV2Config(
    name="deepseek-v2-lite", family="moe", n_layers=27, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=10944, vocab=102400, head_dim=128,
    rope_theta=10000.0, norm_eps=1e-6,
    moe=True, n_experts=64, experts_per_tok=6, d_expert=1408,
    n_shared_experts=2,
    mla=True, kv_lora_rank=512, q_lora_rank=0, rope_head_dim=64,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    kv_cache_dtype="bfloat16",
    first_k_dense=1, dropless=True, norm_topk_prob=False, kv_norm=True,
    yarn_factor=40.0, yarn_mscale=0.707,
)


def reduced() -> DeepSeekV2Config:
    """One dense layer and 2 MoE layers of 8 experts (top-3, 1 shared) at
    toy widths; every mechanism of ``CONFIG`` kept."""
    return dataclasses.replace(
        CONFIG, name="deepseek-v2-lite-reduced", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=96, vocab=256,
        n_experts=8, experts_per_tok=3, d_expert=32, n_shared_experts=1,
        kv_lora_rank=32, rope_head_dim=8)
