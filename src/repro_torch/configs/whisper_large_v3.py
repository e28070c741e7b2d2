"""whisper-large-v3 [audio] — enc-dec; conv frontend is a STUB
(input_specs supplies precomputed mel-frame embeddings).  [arXiv:2212.04356]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio", n_layers=32, d_model=1280,
    n_heads=20, n_kv_heads=20, d_ff=5120, vocab=51866,
    enc_dec=True, n_encoder_layers=32, encoder_seq=1500,
    frontend="audio_stub",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-large-v3-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
        n_encoder_layers=2, encoder_seq=32)
