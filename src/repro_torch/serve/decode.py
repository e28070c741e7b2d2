"""Serving steps: prefill (cache-populating) and batched one-token decode,
the greedy decode loop, and in-DRAM greedy sampling (the bank-batched
SIMDRAM argmax).

``simdram_greedy_token`` is the PuM-offloaded sampler: per-sequence logits
are quantized and the greedy token is selected by a bank-batched SIMDRAM
max tournament — each sequence's logits occupy one DRAM bank (the paper's
16-bank scaling), the whole batch votes in parallel, and every comparison
is a ``bbop_greater``/``bbop_if_else`` pair executing on the selected
backend with zero per-op layout conversion.

``make_prefill``/``make_serve_step`` wrap the model's forward;
``greedy_decode`` runs prefill and one-token decode steps against zeroed
caches (primed by the encoder for an enc-dec model) and picks each token with ``torch.argmax`` (``sampler="host"``)
or with :func:`simdram_greedy_token` on a machine (``sampler="simdram"``),
which on a CUDA machine runs the FSM and transposition kernels.
"""
from __future__ import annotations

import torch

from .. import telemetry
from ..configs.base import ModelConfig
from ..models.transformer import (check_cfg, init_caches,
                                  prime_encdec_caches)
from ..ops.bbops import (PerfStats, bbop_greater, bbop_if_else,
                         simdram_pipeline)

__all__ = ["make_prefill", "make_serve_step", "greedy_decode",
           "simdram_argmax", "simdram_greedy_token", "quantize_logits"]


def make_prefill(cfg: ModelConfig):
    """Multi-token forward that also populates the decode caches; the LM
    head runs on the last position only, the one whose logits are used."""
    def prefill(model, batch, caches):
        check_cfg(model, cfg)
        hidden, _, new_caches = model(batch, caches, return_hidden=True)
        with torch.no_grad():        # as the forward runs with caches
            return model.logits(hidden[:, -1:]), new_caches
    return prefill


def make_serve_step(cfg: ModelConfig):
    """One decode step: (model, caches, tokens (B,1)) → (logits, caches)."""
    def serve_step(model, caches, batch):
        check_cfg(model, cfg)
        logits, _, new_caches = model(batch, caches)
        return logits, new_caches
    return serve_step


_MIN_LANES = 32          # one packed word — the tournament floor


def simdram_argmax(values: torch.Tensor, n_bits: int = 8,
                   backend: str | None = None,
                   perf_stats: PerfStats | None = None,
                   machine=None) -> torch.Tensor:
    """Row-wise argmax of unsigned ``values (B, V)`` via a plane-resident
    max tournament, one bank per row; returns int32 indices ``(B,)`` on
    the tournament's device.

    Values and winner indices are loaded vertical up front (one
    transposition pass each — they differ in width, so they cannot share a
    pass); each round splits the lane axis in half (free row/lane
    re-indexing) and keeps the winners with one ``bbop_greater`` + two
    ``bbop_if_else`` — all banks in parallel, zero per-op conversions.
    Below one packed word the same tournament continues SWAR-style: the
    candidates are compared against their lane-shifted selves
    (:meth:`~repro_torch.simdram.layout.BitplaneArray.shift_lanes`, free
    word shifts) at strides 16, 8, 4, 2, 1 until lane 0 holds the winner,
    so only the index planes pay a reverse pass — 3 transposition passes
    total regardless of V or round count, no host reduction epilogue.
    Ties resolve deterministically: a strictly greater upper half or
    shifted lane wins, so the result is the same maximal index on every
    backend and device.

    The tournament runs where the machine's data lives: ``machine``'s
    device, else the open session's, else the default machine's
    (``"cuda"``).  ``perf_stats`` runs it under the timed execution layer,
    accumulating modeled DRAM cost (latency, energy, transposition) into
    the given :class:`~repro_torch.core.backends.PerfStats` — pass one
    accumulator across calls to meter a whole decode loop.  ``machine``
    binds the tournament to a
    :class:`~repro_torch.simdram.machine.SimdramMachine` session: its
    backend, its μProgram Memory, its device and (absent an explicit
    ``perf_stats``) its own accumulator and DRAM model.
    """
    b, v = values.shape
    lanes = max(_MIN_LANES, 1 << (v - 1).bit_length())
    # int32 words are bit-identical to the reference's uint32 padding
    vals = torch.nn.functional.pad(values.to(torch.int32), (0, lanes - v))
    idx_bits = max(1, (lanes - 1).bit_length())
    idx = torch.arange(lanes, dtype=torch.int32,
                       device=values.device).expand(b, lanes)
    with simdram_pipeline(banks=b, backend=backend,
                          perf_stats=perf_stats, machine=machine,
                          timed=machine is not None and perf_stats is None
                          ) as p:
        cur_v = p.load(vals, n_bits)
        cur_i = p.load(idx, idx_bits)
        while cur_v.words > _MIN_LANES // 32:
            lo_v, hi_v = cur_v.split_lanes()
            lo_i, hi_i = cur_i.split_lanes()
            win = bbop_greater(hi_v, lo_v, n_bits)
            cur_v = bbop_if_else(win, hi_v, lo_v, n_bits)
            cur_i = bbop_if_else(win, hi_i, lo_i, idx_bits)
        # SWAR finish within the last packed word: strict greater keeps
        # the lower lane on ties, and the zero-filled shifted-in lanes
        # never beat a live candidate, so lane 0 converges to a maximal
        # index without leaving the vertical layout
        k = _MIN_LANES // 2
        while k:
            sh_v = cur_v.shift_lanes(k)
            sh_i = cur_i.shift_lanes(k)
            win = bbop_greater(sh_v, cur_v, n_bits)
            cur_v = bbop_if_else(win, sh_v, cur_v, n_bits)
            cur_i = bbop_if_else(win, sh_i, cur_i, idx_bits)
            k //= 2
        final_i = cur_i.to_values()              # (B, 32), winner in lane 0
    return final_i[:, 0]


def quantize_logits(logits: torch.Tensor, n_bits: int = 8) -> torch.Tensor:
    """Affine per-row quantization of float logits ``(B, V)`` to
    ``n_bits`` unsigned levels (int32), the transposition-unit write
    format the tournament ranks.

    Float32 throughout, one tensor op at a time (no fused multiply-add
    can move a value across a bin edge); ``torch.round`` rounds half to
    even.  Non-finite logits (vocab masking with ``-inf``) map to bin 0
    rather than poisoning the per-row scale.
    """
    logits = logits.to(torch.float32)
    finite = torch.isfinite(logits)
    lo = torch.where(finite, logits, float("inf")).amin(-1, keepdim=True)
    hi = torch.where(finite, logits, float("-inf")).amax(-1, keepdim=True)
    scale = (2 ** n_bits - 1) / torch.clamp(hi - lo, min=1e-9)
    q = torch.round((logits - lo) * scale)
    q = torch.where(finite, q, 0.0)
    return torch.clamp(q, 0, 2 ** n_bits - 1).to(torch.int32)


def simdram_greedy_token(logits: torch.Tensor, n_bits: int = 8,
                         backend: str | None = None,
                         perf_stats: PerfStats | None = None,
                         machine=None) -> torch.Tensor:
    """Greedy token per sequence, selected in-memory.

    Logits ``(B, V)`` are affinely quantized per row to ``n_bits`` unsigned
    levels (:func:`quantize_logits`) and ranked by the banked SIMDRAM
    tournament (:func:`simdram_argmax`).  Quantization collisions among
    near-ties may pick a token within one quantization bin of the float
    argmax.
    """
    return simdram_argmax(quantize_logits(logits, n_bits), n_bits=n_bits,
                          backend=backend, perf_stats=perf_stats,
                          machine=machine)


@torch.no_grad()
def greedy_decode(model, cfg: ModelConfig, prompt: torch.Tensor, steps: int,
                  max_seq: int | None = None, extra_batch: dict | None = None,
                  sampler: str = "host",
                  sampler_perf: PerfStats | None = None, machine=None):
    """Greedy decoding loop: ``prompt (B, S)`` token ids on the model's
    device → ``(B, steps)`` int64 token ids.

    ``sampler="simdram"`` selects each token with the bank-batched PuM
    tournament (:func:`simdram_greedy_token`, one bank per sequence) on
    ``machine`` (else the open session's, else the default machine, on
    ``"cuda"``), whose backend it uses; ``"host"`` is ``torch.argmax``,
    whose first-maximum rule is ``jnp.argmax``'s.  ``sampler_perf``
    accumulates the tournament's modeled DRAM cost across every decoded
    token.  The KV caches are zeroed at ``max_seq`` (``S + steps`` by
    default) in the cache's default bf16, and the prompt is prefilled
    through them, as the reference does.  ``extra_batch`` joins every
    forward's batch (``encoder_frames`` for an enc-dec model, whose caches
    are then primed by :func:`prime_encdec_caches` before the prefill).
    ``cfg`` must be ``model.cfg`` (ValueError otherwise).
    """
    check_cfg(model, cfg)
    if sampler == "simdram":
        def choose(logits):
            return simdram_greedy_token(logits, perf_stats=sampler_perf,
                                        machine=machine).long()
    elif sampler == "host":
        def choose(logits):
            return torch.argmax(logits, -1)
    else:
        raise ValueError(f"unknown sampler {sampler!r}")

    def pick(logits):
        with telemetry.span("decode.pick"):
            return choose(logits)

    b, s = prompt.shape
    max_seq = max_seq or (s + steps)
    caches = init_caches(cfg, b, max_seq, device=model.device)
    extra = extra_batch or {}
    if cfg.enc_dec and "encoder_frames" in extra:
        caches = prime_encdec_caches(model, cfg, extra, caches)
    prefill = make_prefill(cfg)
    step = make_serve_step(cfg)
    batch = {"tokens": prompt, **extra}
    if cfg.rope == "mrope" and "mrope_positions" not in batch:
        batch["mrope_positions"] = torch.arange(
            s, device=prompt.device)[None, :, None].expand(b, s, 3)
    logits, caches = prefill(model, batch, caches)
    out = [pick(logits[:, -1])]
    for t in range(steps - 1):
        with telemetry.span("decode.step"):
            db = {"tokens": out[-1][:, None], **extra}
            if cfg.rope == "mrope":
                db["mrope_positions"] = torch.full((b, 1, 3), s + t,
                                                   device=prompt.device)
            logits, caches = step(model, caches, db)
            out.append(pick(logits[:, -1]))
    return torch.stack(out, 1)
