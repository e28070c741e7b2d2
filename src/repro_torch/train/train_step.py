"""Train-step factory: loss, grads, clipping, AdamW and microbatch
accumulation on one device, and the sign packing of the majority-vote
compressed-DP variant.

``make_train_step`` is the reference's plain step
(:mod:`repro.train.train_step`) on autograd.  The state's parameters are
the model's own (a :class:`~repro_torch.models.transformer.Transformer`),
and a step updates them, ``m`` and ``v`` in place, only after the loss and
every backward pass of the step have succeeded: a step that raises before
its update leaves the state as it was, so a retry from it is exact.

``make_compressed_train_step`` exchanges packed gradient signs between
data-parallel replicas and needs ``torch.distributed``; it is not ported
yet.  :func:`_pack_signs` and :func:`_majority_from_packed`, its packing
and vote, are, bit for bit on int32 words that are the reference's uint32.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..models.transformer import Transformer, check_cfg
from .optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update


@dataclasses.dataclass
class TrainState:
    """The model (updated in place by the step) and its AdamW state; the
    compressed step's error-feedback residual comes with that step."""
    params: Transformer
    opt: AdamWState


def init_train_state(params: Transformer) -> TrainState:
    """A fresh state over ``params``: zeroed moments keyed by parameter
    name."""
    return TrainState(params=params,
                      opt=adamw_init(dict(params.named_parameters())))


def softmax_xent(logits, labels):
    logp = torch.log_softmax(logits.float(), -1)
    ll = logp.gather(-1, labels[..., None].long())[..., 0]
    return -ll.mean()


def _chunk_nll(h, labels, head):
    """−Σ log p(label) over one sequence chunk of hidden states."""
    logits = torch.einsum("bsd,dv->bsv", h, head.to(h.dtype))
    logp = torch.log_softmax(logits.float(), -1)
    return logp.gather(-1, labels[..., None].long()).sum()


def make_loss_fn(cfg: ModelConfig, aux_weight: float = 0.01,
                 loss_chunk: int = 0):
    """``loss_fn(model, batch) → (loss + aux_weight·aux, {"loss", "aux"})``.

    ``loss_chunk > 0`` enables the chunked-vocab loss: the LM head and
    cross-entropy run per sequence chunk (``s // max(1, s // loss_chunk)``
    positions, which must divide ``s``), each recomputed in the backward
    pass, so the (tokens × vocab) float32 logits tensor is never
    materialized — the memory-term optimization for large-vocab training
    cells."""
    def loss_fn(model: Transformer, batch: dict):
        check_cfg(model, cfg)
        if not loss_chunk:
            logits, aux, _ = model(batch)
            loss = softmax_xent(logits, batch["labels"])
            return loss + aux_weight * aux, {"loss": loss, "aux": aux}
        hidden, aux, _ = model(batch, return_hidden=True)
        head = model.embed.t() if cfg.tie_embeddings else model.lm_head
        b, s, d = hidden.shape
        n_chunks = max(1, s // loss_chunk)
        hs = hidden.reshape(b, n_chunks, s // n_chunks, d)
        ls = batch["labels"].reshape(b, n_chunks, s // n_chunks)
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c in range(n_chunks):
            if torch.is_grad_enabled():
                nll = checkpoint(_chunk_nll, hs[:, c], ls[:, c], head,
                                 use_reentrant=False,
                                 preserve_rng_state=False)
            else:
                nll = _chunk_nll(hs[:, c], ls[:, c], head)
            total = total - nll
        loss = total / (b * s)
        return loss + aux_weight * aux, {"loss": loss, "aux": aux}
    return loss_fn


def _microbatches(batch: dict, n: int) -> list[dict]:
    """``n`` consecutive row blocks of every batch tensor (the reference's
    ``reshape(n, b // n, ...)``)."""
    def split(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} "
                             "microbatches")
        return x.reshape(n, b // n, *x.shape[1:])
    parts = {k: split(x) for k, x in batch.items()}
    return [{k: x[i] for k, x in parts.items()} for i in range(n)]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1, loss_chunk: int = 0):
    """``train_step(state, batch) → (state, metrics)``: the gradients of
    ``loss + 0.01·aux`` (summed over ``microbatches`` row blocks, then
    divided by their number), clipped, and one AdamW update, in place.
    ``metrics`` holds ``loss`` and ``aux`` of the last microbatch (the
    reference's scan carry leaves them so), ``grad_norm`` and ``lr``, as
    0-d tensors; nothing in the step waits on the device.  A parameter
    without a gradient gets zeros, as ``jax.grad`` gives it."""
    loss_fn = make_loss_fn(cfg, loss_chunk=loss_chunk)

    def train_step(state: TrainState, batch: dict):
        named = dict(state.params.named_parameters())
        for p in named.values():
            p.grad = None
        parts = [batch] if microbatches == 1 else _microbatches(
            batch, microbatches)
        for part in parts:
            objective, metrics = loss_fn(state.params, part)
            objective.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in named.items()}
        for p in named.values():
            p.grad = None
        if microbatches > 1:
            torch._foreach_div_(list(grads.values()), microbatches)
        _, state.opt, stats = adamw_update(opt_cfg, state.opt, named, grads)
        metrics = {k: t.detach() for k, t in metrics.items()}
        metrics.update(stats)
        return state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Majority-vote compressed data parallelism: the sign packing and the vote
# ---------------------------------------------------------------------------

_SHIFTS = torch.arange(32, dtype=torch.int32)


def _pack_signs(g: torch.Tensor) -> torch.Tensor:
    """float (..., n) → int32 (⌈n/32⌉,) packed sign bits (1 ⇔ g ≥ 0, so
    −0.0 packs as 1 and NaN as 0), bit i of word w for element 32·w + i;
    the words are the reference's uint32 bit for bit."""
    flat = g.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % 32))
    bits = (flat >= 0).to(torch.int64).reshape(-1, 32)
    words = (bits << _SHIFTS.to(g.device, torch.int64)).sum(-1)
    return words.to(torch.int32)        # wraps bit 31 to the sign bit


def _majority_from_packed(words: torch.Tensor, n_voters: int, n: int):
    """words: (R, W) int32 packed sign planes from R replicas → float32 ±1
    majority vote of the first ``n`` lanes (+1 iff more than half the
    voters packed a 1).

    This is SIMDRAM's TRA generalized to R inputs: a per-lane popcount
    against R/2 on the packed words."""
    shifts = _SHIFTS.to(words.device)
    unpacked = (words[:, :, None] >> shifts) & 1         # (R, W, 32)
    counts = unpacked.sum(0)                             # (W, 32)
    maj = (2 * counts > n_voters).float() * 2 - 1
    return maj.reshape(-1)[:n]
