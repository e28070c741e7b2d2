"""granite-34b [dense] — llama-arch code model, MQA (kv=1), 88 layers.
[arXiv:2405.04324]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense", n_layers=88, d_model=6144,
    n_heads=48, n_kv_heads=1, d_ff=24576, vocab=49152,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="granite-34b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=1, d_ff=128, vocab=256)
