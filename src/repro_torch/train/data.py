"""Deterministic synthetic data pipeline (sharded, restartable).

Real deployments swap in a tokenized corpus reader; the pipeline contract is
what matters for the framework: (1) deterministic per-step batches keyed by
(seed, step) so restarts/elastic rescales reproduce the same stream; (2)
host-local sharding — each data-parallel host materializes only its slice;
(3) an explicit schema matching ``input_specs``.

The synthetic distribution is a Zipf-ish token mixture with a simple Markov
structure so the LM loss is learnable (used by the e2e example).  The
tokens come from the reference's numpy generator
(:mod:`repro.train.data`), so both packages see the same batches; they are
int32 tensors on the caller's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    vocab: int = 32000
    seq_len: int = 1024
    global_batch: int = 8


def synthetic_batch(cfg: DataConfig, step: int, lo: int = 0,
                    hi: int | None = None, device="cuda") -> dict:
    """Batch rows [lo, hi) of the global batch for this step (host slice),
    as int32 ``tokens`` and ``labels`` on ``device``."""
    hi = cfg.global_batch if hi is None else hi
    rng = np.random.default_rng(np.uint64(cfg.seed) + np.uint64(step))
    # markov-ish stream: next ~ (prev*a + noise) mod vocab, zipf-biased
    base = rng.zipf(1.3, size=(cfg.global_batch, cfg.seq_len + 1))
    base = np.minimum(base, cfg.vocab - 1)
    drift = np.cumsum(rng.integers(0, 7, size=base.shape), axis=1)
    toks = ((base + drift) % cfg.vocab).astype(np.int32)[lo:hi]
    toks = torch.from_numpy(toks).to(resolve_device(device))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def batch_spec(model: ModelConfig, shape: ShapeConfig) -> dict:
    """``device="meta"`` tensors of one batch's shapes and dtypes (the
    reference's ``ShapeDtypeStruct``s)."""
    b, s = shape.global_batch, shape.seq_len

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    spec = {"tokens": meta((b, s), torch.int32),
            "labels": meta((b, s), torch.int32)}
    if model.rope == "mrope":
        spec["mrope_positions"] = meta((b, s, 3), torch.int32)
    if model.enc_dec:
        spec["encoder_frames"] = meta((b, model.encoder_seq, model.d_model),
                                      torch.bfloat16)
    return spec


def make_batch_like(spec_tree: dict, seed: int = 0, device="cuda") -> dict:
    """Materialize a concrete batch matching a spec tree (tests/examples):
    integers in [0, 64) and normal(0, 0.1) floats, drawn key by key from
    the reference's numpy generator."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, spec in spec_tree.items():
        if spec.dtype.is_floating_point:
            vals = rng.normal(0, 0.1, size=tuple(spec.shape))
        else:
            vals = rng.integers(0, 64, size=tuple(spec.shape))
        out[k] = torch.from_numpy(vals).to(spec.dtype).to(dev)
    return out
