"""zamba2-7b [hybrid] — Mamba2 backbone with a weight-tied shared attention
block applied every 6 SSM layers.  [arXiv:2411.15242]"""
import dataclasses

from .base import ModelConfig

_N = 81

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", n_layers=_N, d_model=3584,
    n_heads=32, n_kv_heads=32, d_ff=14336, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_chunk=64,
    layer_pattern=("ssm",) * _N,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="zamba2-7b-reduced", n_layers=12, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, ssm_state=16,
        layer_pattern=("ssm",) * 12)
