"""deepseek-v2-236b [moe] — MLA (kv_lora=512, decoupled RoPE), 2 shared +
160 routed experts, top-6.  [arXiv:2405.04434]

The reference's config, kept equal to it field for field: it lacks the
published model's RMSNorms on the kv and q latents, its YaRN rope scaling
(and softmax temperature), its leading dense layer and its dropless
routing.  The port has all but the q-latent norm as ``DeepSeekV2Config``
options, which ``configs/deepseek_v2_lite.py`` turns on (that model has
no q latent)."""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120,
    n_heads=128, n_kv_heads=128, d_ff=1536, vocab=102400, head_dim=128,
    moe=True, n_experts=160, experts_per_tok=6, d_expert=1536,
    n_shared_experts=2,
    mla=True, kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="deepseek-v2-236b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=64, vocab=256,
        n_experts=8, experts_per_tok=2, d_expert=32, n_shared_experts=1,
        kv_lora_rank=32, q_lora_rank=32, rope_head_dim=8)
