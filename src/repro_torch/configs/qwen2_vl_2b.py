"""qwen2-vl-2b [vlm] — M-RoPE, dynamic-resolution vision frontend (STUB:
input_specs supplies precomputed patch embeddings / M-RoPE position ids).
[arXiv:2409.12191]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm", n_layers=28, d_model=1536,
    n_heads=12, n_kv_heads=2, d_ff=8960, vocab=151936, qkv_bias=True,
    rope="mrope", frontend="vision_stub", tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2-vl-2b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256)
