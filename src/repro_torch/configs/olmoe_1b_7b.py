"""olmoe-1b-7b [moe] — 64 experts, top-8.  [arXiv:2409.02060]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1024, vocab=50304,
    moe=True, n_experts=64, experts_per_tok=8, d_expert=1024,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="olmoe-1b-7b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=64, vocab=256, n_experts=8,
        experts_per_tok=2, d_expert=32)
