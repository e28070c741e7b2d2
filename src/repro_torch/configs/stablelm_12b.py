"""stablelm-12b [dense] — GQA kv=8.  [hf:stabilityai/stablelm-2-12b]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_ff=13824, vocab=100352,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="stablelm-12b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256)
