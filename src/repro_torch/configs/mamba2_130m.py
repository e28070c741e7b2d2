"""mamba2-130m [ssm] — attention-free SSD (state-space duality).
[arXiv:2405.21060]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_chunk=64, rope="none",
    tie_embeddings=True,
    layer_pattern=("ssm",) * 24,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mamba2-130m-reduced", n_layers=2, d_model=64,
        ssm_state=16, vocab=256, layer_pattern=("ssm",) * 2)
