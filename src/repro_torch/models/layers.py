"""Layers on ``torch``: RMSNorm, RoPE/M-RoPE, GQA attention with a plain,
an online-softmax (flash) and a cached decode path, the int8 KV cache, MLA
(DeepSeek-V2 latent attention), the SwiGLU MLP with its binarized (PuM)
variant, the top-k MoE, and the Mamba2/SSD mixer.

Conventions (the reference's, :mod:`repro.models.layers`)
---------------------------------------------------------
* every layer has ``<layer>_defs(cfg) → ParamDef tree``; its module
  (:class:`RMSNorm`, :class:`Attention`, :class:`MLAttention`,
  :class:`MLP`, :class:`PumMLP`, :class:`MoE`, :class:`SSMMixer`) holds parameters of those names and shapes, so a reference parameter
  tree loads into it leaf for leaf;
* parameters are stored float32 and cast to ``cfg.compute_dtype`` at each
  use (``_cast``, which counts the bytes in ``models.weight_cast_bytes``);
  every cast, upcast and rounding happens in the reference's order,
  so bf16 results round where the reference's do;
* decode paths take explicit caches and write this step's keys and values
  into them in place (the cache tensors are the caller's; only ``pos``
  is returned anew).  A write past the cache's end raises instead of
  shifting, as ``dynamic_update_slice`` would;
* attention is causal; cached attention sees the cache prefix up to each
  query's own position.

None of these is a Pallas kernel in the reference: they are ``jnp``
einsums and blockwise ``lax.scan``s (flash attention, the SSD scan), and
stay plain ``torch`` here, the scans as Python loops.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate

from .. import telemetry
from ..configs.base import ModelConfig
from ..distributed.sharding import routing_placements
from .params import ParamDef

P = ParamDef


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _cast(w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Weight ``w`` in ``dt``, cast at its use; a cast that changes the
    dtype adds the bytes it reads and writes to the
    ``models.weight_cast_bytes`` counter."""
    if w.dtype != dt:
        telemetry.count("models.weight_cast_bytes",
                        w.numel() * (w.element_size() + dt.itemsize))
    return w.to(dt)


def _param(d: ParamDef, device) -> nn.Parameter:
    """An uninitialised float32 parameter of ``d``'s shape (filled by
    ``Transformer.load_params``)."""
    return nn.Parameter(torch.empty(d.shape, dtype=torch.float32,
                                    device=device))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_defs(d: int):
    return {"scale": P((d,), ("embed",), init="ones")}


def rmsnorm(x, scale, eps: float = 1e-5):
    var = x.float().square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * _cast(scale, x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-5, device="cuda"):
        super().__init__()
        self.eps = eps
        self.scale = _param(rmsnorm_defs(d)["scale"], device)

    def forward(self, x):
        return rmsnorm(x, self.scale, self.eps)


# ---------------------------------------------------------------------------
# RoPE (+ M-RoPE for qwen2-vl: 3-section rotary over (t, h, w) positions;
# with text-only inputs all three sections see the same position index,
# which reduces to standard RoPE).  Interleaved pairs (0::2, 1::2).
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, positions, theta: float = 1e4, mrope_sections=None):
    """x: (..., S, H, hd); positions: (..., S) or (..., S, 3) for M-RoPE."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)             # (hd/2,)
    if positions.ndim == x.ndim - 2:                    # plain RoPE
        ang = positions[..., :, None].float() * freqs
    else:                                               # M-RoPE (S, 3)
        sections = mrope_sections or (hd // 6, hd // 6,
                                      hd // 2 - 2 * (hd // 6))
        parts = []
        for s, sec in enumerate(sections):
            off = sum(sections[:s])
            parts.append(positions[..., s][..., :, None].float()
                         * freqs[off:off + sec])
        ang = torch.cat(parts, -1)
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos.to(x.dtype) - x2 * sin.to(x.dtype)
    y2 = x2 * cos.to(x.dtype) + x1 * sin.to(x.dtype)
    return torch.stack([y1, y2], -1).reshape(x.shape)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def attention_defs(cfg: ModelConfig):
    d, hd, nh, nkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    defs = {
        "wq": P((d, nh, hd), ("embed", "heads", None)),
        "wk": P((d, nkv, hd), ("embed", "kv_heads", None)),
        "wv": P((d, nkv, hd), ("embed", "kv_heads", None)),
        "wo": P((nh, hd, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = P((nh, hd), ("heads", None), init="zeros")
        defs["bk"] = P((nkv, hd), ("kv_heads", None), init="zeros")
        defs["bv"] = P((nkv, hd), ("kv_heads", None), init="zeros")
    return defs


# block sizes for the online-softmax (flash) attention path
FLASH_BLOCK_Q = 1024
FLASH_BLOCK_K = 1024
FLASH_THRESHOLD = 4096       # naive path below this many score elements²


def _sdpa_naive(q, k, v, causal: bool, q_offset: int = 0):
    """q: (B,S,H,hd); k/v: (B,T,KV,hd) — grouped by broadcasting."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    q = q.reshape(b, s, kv, h // kv, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k) / math.sqrt(hd)
    scores = scores.float()
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None] + q_offset
        kpos = torch.arange(t, device=q.device)[None, :]
        scores = torch.where(qpos >= kpos, scores, -1e30)
    w = torch.softmax(scores, -1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, h, hd)


def _flash_attn(q, k, v, causal: bool, q_offset: int = 0, kv_len=None,
                block_q: int = FLASH_BLOCK_Q, block_k: int = FLASH_BLOCK_K):
    """Online-softmax attention: O(S·hd) memory instead of O(S·T).

    q: (B,S,H,hd); k/v: (B,T,KV,hd).  ``kv_len``: optional scalar — only
    cache positions < kv_len + current block are attendable (decode).  The
    reference's scan over q blocks × scan over kv blocks becomes two
    Python loops with the same carry (running max, sum, accumulator).
    """
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    bq = min(block_q, s)
    bk = min(block_k, t)
    nq, nk = -(-s // bq), -(-t // bk)
    pad_q, pad_k = nq * bq - s, nk * bk - t
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    hd_v = v.shape[-1]
    qb = q.reshape(b, nq, bq, kv, g, hd).permute(1, 0, 3, 4, 2, 5)
    kb = k.reshape(b, nk, bk, kv, hd).permute(1, 0, 3, 2, 4)
    vb = v.reshape(b, nk, bk, kv, hd_v).permute(1, 0, 3, 2, 4)
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    outs = []
    for qi in range(nq):
        qpos = qi * bq + torch.arange(bq, device=dev) + q_offset
        m = torch.full((b, kv, g, bq), -math.inf, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kv, g, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kv, g, bq, hd_v), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            kpos = ki * bk + torch.arange(bk, device=dev)
            sc = torch.einsum("bkgqd,bktd->bkgqt", qb[qi], kb[ki]) * scale
            sc = sc.float()
            mask = (kpos < t)[None, :].expand(bq, bk)
            if causal:
                mask = mask & (qpos[:, None] >= kpos[None, :])
            if kv_len is not None:
                mask = mask & (kpos[None, :] <= (kv_len + qpos[:, None]))
            sc = torch.where(mask, sc, -1e30)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = (acc * corr[..., None]
                   + torch.einsum("bkgqt,bktd->bkgqd", p.to(vb.dtype),
                                  vb[ki]))
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.stack(outs)          # (nq, B, KV, G, bq, hd_v)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, nq * bq, h, hd_v)
    return out[:, :s].to(v.dtype)


def _blockwise(fn, q, *rest):
    """``fn(q, *rest)`` — attention, independent per batch row and head —
    on each rank's block when the operands are DTensors (placed over batch
    and heads, as the sharding rules place activations), the result placed
    like ``q``.  DTensor runs an einsum as one ``bmm`` over its flattened
    batch dims, and torch 2.11 refuses to flatten (batch, heads) when both
    are sharded (``aten._unsafe_view``: "Attempted to flatten multiple
    dimensions"); this is the explicit redistribution at that op.
    Partial sums (a projection of a partial input) are summed first, and
    operands placed unlike each other on a mesh dimension (KV heads that
    replicate where the query heads shard) are replicated there."""
    if not isinstance(q, DTensor):
        return fn(q, *rest)
    mesh = q.device_mesh
    same = [p if not p.is_partial() and all(t.placements[i] == p
                                            for t in rest) else Replicate()
            for i, p in enumerate(q.placements)]
    ts = [t if list(t.placements) == same else t.redistribute(mesh, same)
          for t in (q, *rest)]
    return DTensor.from_local(fn(*(t.to_local() for t in ts)), mesh, same,
                              run_check=False)


def _sdpa(q, k, v, causal: bool, q_offset: int = 0):
    s, t = q.shape[1], k.shape[1]
    if s * t <= FLASH_THRESHOLD * FLASH_THRESHOLD:
        return _blockwise(lambda q, k, v: _sdpa_naive(q, k, v, causal,
                                                      q_offset), q, k, v)
    return _blockwise(lambda q, k, v: _flash_attn(q, k, v, causal,
                                                  q_offset), q, k, v)


def _masked_decode_attn(q, k, v, q_pos: int):
    """Cached attention: query i (global position q_pos+i) attends to cache
    positions ≤ its own (supports both 1-token decode and multi-token
    cache-populating prefill).  Long caches take the online-softmax path."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    if s * t > FLASH_THRESHOLD * FLASH_THRESHOLD or t > 16384:
        return _flash_attn(q, k, v, causal=True, q_offset=q_pos)
    q = q.reshape(b, s, kv, h // kv, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k) / math.sqrt(hd)
    qpos = torch.arange(s, device=q.device)[:, None] + q_pos
    kpos = torch.arange(t, device=q.device)[None, :]
    scores = torch.where(kpos <= qpos, scores.float(), -1e30)
    w = torch.softmax(scores, -1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, h, hd)


def _write(cache: torch.Tensor, update: torch.Tensor, pos: int):
    """Write ``update`` into ``cache`` along axis 1 at ``pos``, in place."""
    s, t = update.shape[1], cache.shape[1]
    if pos + s > t:
        raise ValueError(f"cache overflow: writing positions {pos}..{pos + s - 1}"
                         f" into a cache of {t}")
    cache[:, pos:pos + s] = update.to(cache.dtype)
    return cache


def _quant(x):
    """int8 codes and a per-(token, head) float32 scale (scale computed in
    ``x``'s dtype, rounding half to even)."""
    s = x.abs().amax(-1, keepdim=True) / 127.0 + 1e-8
    return torch.round(x / s).to(torch.int8), s[..., 0].float()


class Attention(nn.Module):
    """GQA attention with the reference's parameter names (``wq``, ``wk``,
    ``wv``, ``wo`` and, with ``qkv_bias``, ``bq``, ``bk``, ``bv``)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        for name, d in attention_defs(cfg).items():
            self.register_parameter(name, _param(d, device))

    def forward(self, x, positions, cache=None, mrope_positions=None):
        """Returns ``(y, new_cache)``; ``cache`` = dict(k, v, pos) (+
        k_scale, v_scale for the int8 cache), one layer's."""
        cfg = self.cfg
        dt = _dt(cfg)
        q = torch.einsum("bsd,dhk->bshk", x, _cast(self.wq, dt))
        k = torch.einsum("bsd,dhk->bshk", x, _cast(self.wk, dt))
        v = torch.einsum("bsd,dhk->bshk", x, _cast(self.wv, dt))
        if cfg.qkv_bias:
            q = q + _cast(self.bq, dt)
            k = k + _cast(self.bk, dt)
            v = v + _cast(self.bv, dt)
        pos = (mrope_positions if cfg.rope == "mrope"
               and mrope_positions is not None else positions)
        if cfg.rope != "none":
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        if cache is None:
            y = _sdpa(q, k, v, causal=True)
            new_cache = None
        elif "k_scale" in cache:
            # int8-quantized KV cache: int8 codes + per-(token, head) scale
            p = cache["pos"]
            kq, ks = _quant(k)
            vq, vs = _quant(v)
            ck, cks = _write(cache["k"], kq, p), _write(cache["k_scale"], ks, p)
            cv, cvs = _write(cache["v"], vq, p), _write(cache["v_scale"], vs, p)
            kd = ck.to(dt) * cks.to(dt)[..., None]
            vd = cv.to(dt) * cvs.to(dt)[..., None]
            y = _blockwise(lambda q, k, v: _masked_decode_attn(q, k, v, p),
                           q, kd, vd)
            new_cache = {"k": ck, "v": cv, "k_scale": cks, "v_scale": cvs,
                         "pos": p + q.shape[1]}
        else:
            p = cache["pos"]
            ck = _write(cache["k"], k, p)
            cv = _write(cache["v"], v, p)
            y = _blockwise(lambda q, k, v: _masked_decode_attn(q, k, v, p),
                           q, ck.to(dt), cv.to(dt))
            new_cache = {"k": ck, "v": cv, "pos": p + q.shape[1]}
        y = torch.einsum("bshk,hkd->bsd", y, _cast(self.wo, dt))
        return y, new_cache


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

def mla_defs(cfg: ModelConfig):
    d, hd, nh = cfg.d_model, cfg.hd, cfg.n_heads
    r, rq, rh = cfg.kv_lora_rank, cfg.q_lora_rank, cfg.rope_head_dim
    defs = {
        "w_dkv": P((d, r + rh), ("embed", "lora")),        # joint kv + rope-k
        "w_uk": P((r, nh, hd), ("lora", "heads", None)),
        "w_uv": P((r, nh, hd), ("lora", "heads", None)),
        "wo": P((nh, hd, d), ("heads", None, "embed")),
    }
    if rq:
        defs["w_dq"] = P((d, rq), ("embed", "lora"))
        defs["w_uq"] = P((rq, nh, hd + rh), ("lora", "heads", None))
    else:
        defs["w_q"] = P((d, nh, hd + rh), ("embed", "heads", None))
    return defs


class MLAttention(nn.Module):
    """Latent attention with the reference's parameter names; cached decode
    keeps only the compressed kv latent ``c`` and the RoPE key
    ``k_rope``."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        for name, d in mla_defs(cfg).items():
            self.register_parameter(name, _param(d, device))

    def forward(self, x, positions, cache=None):
        """Returns ``(y, new_cache)``; ``cache`` = dict(c, k_rope, pos), one
        layer's (scored against the latent directly: the absorbed
        decode)."""
        cfg = self.cfg
        dt = _dt(cfg)
        r, rh, hd = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.hd
        ckv = torch.einsum("bsd,dr->bsr", x, _cast(self.w_dkv, dt))
        c, k_rope = ckv[..., :r], ckv[..., r:]
        k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
        if cfg.q_lora_rank:
            q = torch.einsum("bsd,dr->bsr", x, _cast(self.w_dq, dt))
            q = torch.einsum("bsr,rhk->bshk", q, _cast(self.w_uq, dt))
        else:
            q = torch.einsum("bsd,dhk->bshk", x, _cast(self.w_q, dt))
        q_nope, q_rope = q[..., :hd], q[..., hd:]
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        scale = 1.0 / math.sqrt(hd + rh)
        s = x.shape[1]
        if cache is None:
            k_nope = torch.einsum("bsr,rhk->bshk", c, _cast(self.w_uk, dt))
            v = torch.einsum("bsr,rhk->bshk", c, _cast(self.w_uv, dt))
            if s > FLASH_THRESHOLD:
                # the nope/rope score components as one head dim, through
                # the online-softmax path (long prefill)
                q_cat = torch.cat([q_nope, q_rope], -1)
                k_cat = torch.cat([k_nope, k_rope.expand(
                    *k_nope.shape[:-1], rh)], -1)
                y = _flash_attn(q_cat, k_cat, v, causal=True)
            else:
                scores = (torch.einsum("bshk,bthk->bhst", q_nope, k_nope)
                          + torch.einsum("bshk,btzk->bhst", q_rope, k_rope)
                          ) * scale
                ar = torch.arange(s, device=x.device)
                scores = torch.where(ar[:, None] >= ar[None, :],
                                     scores.float(), -1e30)
                w = torch.softmax(scores, -1).to(dt)
                y = torch.einsum("bhst,bthk->bshk", w, v)
            new_cache = None
        else:
            p = cache["pos"]
            cc = _write(cache["c"], c, p)
            cr = _write(cache["k_rope"], k_rope[:, :, 0, :], p)
            q_abs = torch.einsum("bshk,rhk->bshr", q_nope,
                                 _cast(self.w_uk, dt))
            scores = (torch.einsum("bshr,btr->bhst", q_abs, cc.to(dt))
                      + torch.einsum("bshk,btk->bhst", q_rope, cr.to(dt))
                      ) * scale
            qpos = torch.arange(s, device=x.device)[:, None] + p
            kpos = torch.arange(cc.shape[1], device=x.device)[None, :]
            scores = torch.where(kpos <= qpos, scores.float(), -1e30)
            w = torch.softmax(scores, -1).to(dt)
            y_lat = torch.einsum("bhst,btr->bshr", w, cc.to(dt))
            y = torch.einsum("bshr,rhk->bshk", y_lat, _cast(self.w_uv, dt))
            new_cache = {"c": cc, "k_rope": cr, "pos": p + s}
        y = torch.einsum("bshk,hkd->bsd", y, _cast(self.wo, dt))
        return y, new_cache


# ---------------------------------------------------------------------------
# MLPs (SwiGLU) — dense, the PuM (bit-serial) variant and MoE
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig, d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {"w_gate": P((d, f), ("embed", "mlp")),
            "w_up": P((d, f), ("embed", "mlp")),
            "w_down": P((f, d), ("mlp", "embed"))}


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda",
                 d_ff: int | None = None):
        super().__init__()
        self.cfg = cfg
        for name, d in mlp_defs(cfg, d_ff).items():
            self.register_parameter(name, _param(d, device))

    def forward(self, x):
        dt = _dt(self.cfg)
        g = torch.einsum("bsd,df->bsf", x, _cast(self.w_gate, dt))
        u = torch.einsum("bsd,df->bsf", x, _cast(self.w_up, dt))
        return torch.einsum("bsf,fd->bsd", F.silu(g) * u,
                            _cast(self.w_down, dt))


class SignSTE(torch.autograd.Function):
    """``sign(v) + (v == 0)`` (zero maps to +1) with the clipped
    straight-through gradient ``g · (|v| ≤ 1)``."""

    @staticmethod
    def forward(ctx, v):
        ctx.save_for_backward(v)
        return torch.sign(v) + (v == 0).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        return g * (v.abs() <= 1).to(g.dtype)


sign_ste = SignSTE.apply


class PumMLP(MLP):
    """SIMDRAM-backed binarized MLP: weights and activations
    sign-binarized and contracted with the XNOR-popcount identity (the
    paper's XNOR-NET application class), with straight-through gradients.
    The gate and up contractions are einsums of ±1 values, as in the
    reference; they equal ``bitserial_matmul`` (K3) on ``pack_signs`` of
    the operands, which the tests hold."""

    def forward(self, x):
        dt = _dt(self.cfg)
        # |x| with jnp.abs's gradient at 0 (1, where Tensor.abs gives 0)
        scale = torch.where(x >= 0, x, -x).mean(-1, keepdim=True)
        xb = sign_ste(x)
        g = torch.einsum("bsd,df->bsf", xb, _cast(sign_ste(self.w_gate), dt))
        u = torch.einsum("bsd,df->bsf", xb, _cast(sign_ste(self.w_up), dt))
        h = F.silu(g * scale) * (u * scale)
        return torch.einsum("bsf,fd->bsd", h, _cast(self.w_down, dt))


def moe_defs(cfg: ModelConfig):
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    defs = {
        "router": P((d, e), ("embed", None)),
        "w_gate": P((e, d, f), ("experts", "embed", None)),
        "w_up": P((e, d, f), ("experts", "embed", None)),
        "w_down": P((e, f, d), ("experts", None, "embed")),
    }
    if cfg.n_shared_experts:
        defs["shared"] = mlp_defs(cfg, cfg.d_expert * cfg.n_shared_experts)
    return defs


MOE_GROUP = 256        # tokens per routing group (bounds dispatch memory)


def _routing_groups(x, ng: int):
    """``x`` (B,S,d) as the MoE runs on it, and the inverse to apply to the
    (B,S,d) output.  A DTensor ``x`` is redistributed explicitly to the
    layout :func:`~repro_torch.distributed.sharding.routing_placements`
    gives for ``ng`` groups, and the output goes back to ``x``'s layout."""
    if not isinstance(x, DTensor):
        return x, lambda y: y
    mesh, placed = x.device_mesh, list(x.placements)
    target = routing_placements(mesh, ng)
    if target == placed:
        return x, lambda y: y
    back = [Replicate() if p.is_partial() else p for p in placed]
    return x.redistribute(mesh, target), lambda y: y.redistribute(mesh, back)


class MoE(nn.Module):
    """Top-k capacity-based MoE with the reference's dispatch/combine
    einsums: tokens route in groups of ``MOE_GROUP`` (halved until it
    divides the token count), each expert takes at most ``capacity`` of a
    group's tokens in token order, and the rest drop.  ``shared`` (with
    ``n_shared_experts``) is a dense :class:`MLP` added to every token."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        for name, d in moe_defs(cfg).items():
            if name != "shared":
                self.register_parameter(name, _param(d, device))
        if cfg.n_shared_experts:
            self.shared = MLP(cfg, device,
                              cfg.d_expert * cfg.n_shared_experts)

    def route(self, tokens):
        """Router of ``tokens (G, S, d)``: softmax probabilities (G, S, E)
        and the top-k experts (G, S, k) with their renormalised gates.
        ``torch.topk`` may order equal probabilities otherwise than
        ``lax.top_k``; only the chosen set reaches the output."""
        logits = torch.einsum("gtd,de->gte", tokens.float(),
                              self.router.float())
        probs = torch.softmax(logits, -1)
        gate_vals, gate_idx = torch.topk(probs, self.cfg.experts_per_tok)
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
        return probs, gate_vals, gate_idx

    def forward(self, x):
        """Returns ``(out, aux)``: the output and the load-balance loss."""
        cfg = self.cfg
        dt = _dt(cfg)
        b, s, d = x.shape
        e, k = cfg.n_experts, cfg.experts_per_tok
        t_total = b * s
        gs = min(MOE_GROUP, t_total)
        while t_total % gs:
            gs //= 2
        ng = t_total // gs
        x, unroute = _routing_groups(x, ng)
        tokens = x.reshape(ng, gs, d)
        probs, gate_vals, gate_idx = self.route(tokens)
        capacity = max(1, int(cfg.capacity_factor * gs * k / e))
        onehot = F.one_hot(gate_idx, e).float()                 # (G, S, k, E)
        assign = onehot.sum(2)                                  # (G, S, E)
        pos = torch.cumsum(assign, 1) - assign                  # slot per (G,S,E)
        within = (pos < capacity) * assign
        # jax.nn.one_hot's zero row where pos ≥ capacity
        slots = torch.arange(capacity, dtype=pos.dtype, device=x.device)
        dispatch = within[..., None] * (pos[..., None] == slots).float()
        combine = torch.einsum("gske,gsk->gse", onehot, gate_vals)
        combine = combine[..., None] * dispatch                 # (G, S, E, C)
        # the reference's gecd layout with the expert axis leading, so each
        # expert einsum is a batched matmul over contiguous (g, c) rows:
        # the same products, and no view of a permuted shard for DTensor
        xs = torch.einsum("gsec,gsd->egcd", dispatch.to(dt), tokens)
        g = torch.einsum("egcd,edf->egcf", xs, _cast(self.w_gate, dt))
        u = torch.einsum("egcd,edf->egcf", xs, _cast(self.w_up, dt))
        ys = torch.einsum("egcf,efd->egcd", F.silu(g) * u,
                          _cast(self.w_down, dt))
        out = torch.einsum("gsec,egcd->gsd", combine.to(dt), ys)
        if cfg.n_shared_experts:
            out = out.reshape(b, s, d) + self.shared(x)
        # auxiliary load-balance loss
        me = probs.mean((0, 1))
        ce = assign.mean((0, 1)) / k
        aux = e * torch.sum(me * ce)
        return unroute(out.reshape(b, s, d)), aux


# ---------------------------------------------------------------------------
# Mamba2 / SSD mixer
# ---------------------------------------------------------------------------

def ssm_defs(cfg: ModelConfig):
    d, di, st, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    return {
        "w_in": P((d, 2 * di + 2 * st + nh), ("embed", "inner")),
        "conv_w": P((4, di + 2 * st), (None, "inner"), scale=0.5),
        "a_log": P((nh,), (None,), init="ones"),
        "d_skip": P((nh,), (None,), init="ones"),
        "dt_bias": P((nh,), (None,), init="zeros"),
        "norm": rmsnorm_defs(di),
        "w_out": P((di, d), ("inner", "embed")),
    }


def _ssd_chunked(xh, a, b, c, chunk: int, f32: bool = True):
    """SSD scan.  xh: (B,S,nh,hd) inputs ·dt;  a: (B,S,nh) per-step decay in
    (0,1);  b,c: (B,S,N).  Returns (B,S,nh,hd) contraction with state dim N.

    Quadratic-within-chunk + carried state across chunks (Mamba2 SSD).
    ``f32=False`` rounds the big einsum operands to bf16 and accumulates
    in float32 (the reference's ``preferred_element_type``: a product of
    bf16 values is exact in float32, so the operands are rounded and then
    contracted in float32); decay and cumsum stay float32.  The
    reference's ``lax.scan`` over chunks is a Python loop.
    """
    bs, s, nh, hd = xh.shape
    n = b.shape[-1]
    nc = s // chunk

    def mm(t):
        return t.float() if f32 else t.to(torch.bfloat16).float()

    xh = xh.reshape(bs, nc, chunk, nh, hd)
    a = a.reshape(bs, nc, chunk, nh)
    b = b.reshape(bs, nc, chunk, n)
    c = c.reshape(bs, nc, chunk, n)
    la = torch.log(a + 1e-20)
    cum = torch.cumsum(la, 2)                                   # (B,NC,Q,nh)
    # intra-chunk: G[t,s] = exp(cum[t]-cum[s]) for s<=t
    gd = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # (B,NC,Q,Q,nh)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))
    g = torch.where(mask[None, None, :, :, None], torch.exp(gd), 0.0)
    cb = torch.einsum("bzqn,bzsn->bzqs", mm(c), mm(b))
    y_intra = torch.einsum("bzqs,bzqsh,bzshd->bzqhd", mm(cb), mm(g), mm(xh))
    # chunk summaries: state contribution of each chunk
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)           # (B,NC,Q,nh)
    chunk_state = torch.einsum("bzsn,bzsh,bzshd->bzhdn", mm(b),
                               mm(decay_to_end), mm(xh))
    chunk_decay = torch.exp(cum[:, :, -1, :])                   # (B,NC,nh)
    h = torch.zeros((bs, nh, hd, n), dtype=torch.float32, device=xh.device)
    h_prev = []
    for z in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, z, :, None, None] + chunk_state[:, z]
    h_prev = torch.stack(h_prev, 1)                             # (B,NC,nh,hd,N)
    y_inter = torch.einsum("bzqn,bzqh,bzhdn->bzqhd", mm(c), mm(torch.exp(cum)),
                           mm(h_prev))
    return (y_intra + y_inter).reshape(bs, s, nh, hd)


def _batch_sharded_only(t):
    """``t`` with every shard but the batch dimension's replicated, for a
    DTensor: the decode caches shard the SSM state's head dimension over
    ``model`` (the reference's cache rule), and DTensor then shards the
    recurrence over the 24 heads unevenly and cannot flatten them — the
    explicit redistribution at that op."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if p.is_shard() and p.dim != 0 else p
        for p in t.placements])


def _softplus(x):
    """``jax.nn.softplus``: log(1 + eˣ) without torch's linear cut-off."""
    return torch.logaddexp(x, torch.zeros_like(x))


class SSMMixer(nn.Module):
    """Mamba2 block with the reference's parameter names (``w_in``,
    ``conv_w``, ``a_log``, ``d_skip``, ``dt_bias``, ``norm.scale``,
    ``w_out``)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        for name, d in ssm_defs(cfg).items():
            if name != "norm":
                self.register_parameter(name, _param(d, device))
        self.norm = RMSNorm(cfg.d_inner, device=device)

    def forward(self, x, cache=None):
        """Returns ``(y, new_cache)``; ``cache`` = dict(conv (B,3,ch),
        state (B,nh,hd,N), pos), one layer's.  The state is written in
        place; the conv window too where its dtype is the compute dtype's,
        else ``new_cache["conv"]`` is a new tensor of the compute dtype (the
        reference's conv state keeps the dtype it was computed in).

        With a cache, the reference runs the one-token recurrence on the
        first token alone and broadcasts its output over every position
        (``repro/models/layers.py:548-557``), so a multi-token prefill
        through the caches differs from the no-cache forward; the port
        computes the same (ROADMAP C)."""
        cfg = self.cfg
        dt_ = _dt(cfg)
        b_, s, _ = x.shape
        di, st, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
        hd = di // nh
        zxbcdt = torch.einsum("bsd,de->bse", x, _cast(self.w_in, dt_))
        z = zxbcdt[..., :di]
        xbc = zxbcdt[..., di:2 * di + 2 * st]
        dt_raw = zxbcdt[..., 2 * di + 2 * st:]
        # depthwise causal conv over xbc (width 4)
        conv_w = _cast(self.conv_w, dt_)
        if cache is None:
            pad = torch.zeros((b_, 3, xbc.shape[-1]), dtype=xbc.dtype,
                              device=x.device)
        else:
            pad = cache["conv"].to(xbc.dtype)
        xpad = torch.cat([pad, xbc], 1)
        conv = sum(xpad[:, i:i + s] * conv_w[i] for i in range(4))
        conv = F.silu(conv)
        xin, bmat, cmat = (conv[..., :di], conv[..., di:di + st],
                           conv[..., di + st:])
        dtv = _softplus(dt_raw.float() + self.dt_bias.float())
        a = torch.exp(-torch.exp(self.a_log.float()) * dtv)    # (B,S,nh)
        xh = xin.reshape(b_, s, nh, hd).float() * dtv[..., None]
        if cache is None:
            chunk = min(cfg.ssm_chunk, s)
            assert s % chunk == 0
            y = _ssd_chunked(xh, a, bmat.float(), cmat.float(), chunk,
                             f32=cfg.ssd_f32)
        else:
            # single-token recurrence: h' = a·h + x⊗B ; y = h'·C
            xh = _batch_sharded_only(xh)
            h = cache["state"]
            h_new = _batch_sharded_only(
                h * a[:, 0, :, None, None]
                + torch.einsum("bhd,bn->bhdn", xh[:, 0], bmat[:, 0].float()))
            y = torch.einsum("bhdn,bn->bhd", h_new, cmat[:, 0].float())
            y = y[:, None].reshape(b_, 1, nh, hd)
            h.copy_(h_new)
        y = y + self.d_skip.float()[None, None, :, None] * xh
        y = y.reshape(b_, s, di).to(dt_)
        y = self.norm(y * F.silu(z))
        out = torch.einsum("bse,ed->bsd", y, _cast(self.w_out, dt_))
        new_cache = None
        if cache is not None:
            conv_state = xpad[:, -3:]
            if cache["conv"].dtype == conv_state.dtype:
                cache["conv"].copy_(conv_state)
                conv_state = cache["conv"]
            new_cache = {"conv": conv_state, "state": cache["state"],
                         "pos": cache["pos"] + s}
        return out, new_cache


def ssm_cache_shape(cfg: ModelConfig, batch: int):
    di, st, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    return {"conv": (batch, 3, di + 2 * st),
            "state": (batch, nh, di // nh, st)}
