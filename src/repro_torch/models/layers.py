"""Dense layers on ``torch``: RMSNorm, RoPE/M-RoPE, GQA attention with a
plain, an online-softmax (flash) and a cached decode path, the int8 KV
cache, and the SwiGLU MLP with its binarized (PuM) variant.

Conventions (the reference's, :mod:`repro.models.layers`)
---------------------------------------------------------
* every layer has ``<layer>_defs(cfg) → ParamDef tree``; its module
  (:class:`RMSNorm`, :class:`Attention`, :class:`MLP`, :class:`PumMLP`)
  holds parameters of those names and shapes, so a reference parameter
  tree loads into it leaf for leaf;
* parameters are stored float32 and cast to ``cfg.compute_dtype`` at each
  use; every cast, upcast and rounding happens in the reference's order,
  so bf16 results round where the reference's do;
* decode paths take explicit caches and write this step's keys and values
  into them in place (the cache tensors are the caller's; only ``pos``
  is returned anew).  A write past the cache's end raises instead of
  shifting, as ``dynamic_update_slice`` would;
* attention is causal; cached attention sees the cache prefix up to each
  query's own position.

None of these is a Pallas kernel in the reference: they are ``jnp``
einsums and a blockwise ``lax.scan``, and stay plain ``torch`` here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .params import ParamDef

P = ParamDef


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


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
    return y * scale.to(x.dtype)


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


def _sdpa(q, k, v, causal: bool, q_offset: int = 0):
    s, t = q.shape[1], k.shape[1]
    if s * t <= FLASH_THRESHOLD * FLASH_THRESHOLD:
        return _sdpa_naive(q, k, v, causal, q_offset)
    return _flash_attn(q, k, v, causal, q_offset)


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
        q = torch.einsum("bsd,dhk->bshk", x, self.wq.to(dt))
        k = torch.einsum("bsd,dhk->bshk", x, self.wk.to(dt))
        v = torch.einsum("bsd,dhk->bshk", x, self.wv.to(dt))
        if cfg.qkv_bias:
            q = q + self.bq.to(dt)
            k = k + self.bk.to(dt)
            v = v + self.bv.to(dt)
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
            y = _masked_decode_attn(q, kd, vd, p)
            new_cache = {"k": ck, "v": cv, "k_scale": cks, "v_scale": cvs,
                         "pos": p + q.shape[1]}
        else:
            p = cache["pos"]
            ck = _write(cache["k"], k, p)
            cv = _write(cache["v"], v, p)
            y = _masked_decode_attn(q, ck.to(dt), cv.to(dt), p)
            new_cache = {"k": ck, "v": cv, "pos": p + q.shape[1]}
        y = torch.einsum("bshk,hkd->bsd", y, self.wo.to(dt))
        return y, new_cache


# ---------------------------------------------------------------------------
# MLPs (SwiGLU) — dense and the PuM (bit-serial) variant
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig, d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {"w_gate": P((d, f), ("embed", "mlp")),
            "w_up": P((d, f), ("embed", "mlp")),
            "w_down": P((f, d), ("mlp", "embed"))}


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        for name, d in mlp_defs(cfg).items():
            self.register_parameter(name, _param(d, device))

    def forward(self, x):
        dt = _dt(self.cfg)
        g = torch.einsum("bsd,df->bsf", x, self.w_gate.to(dt))
        u = torch.einsum("bsd,df->bsf", x, self.w_up.to(dt))
        return torch.einsum("bsf,fd->bsd", F.silu(g) * u, self.w_down.to(dt))


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
        g = torch.einsum("bsd,df->bsf", xb, sign_ste(self.w_gate).to(dt))
        u = torch.einsum("bsd,df->bsf", xb, sign_ste(self.w_up).to(dt))
        h = F.silu(g * scale) * (u * scale)
        return torch.einsum("bsf,fd->bsd", h, self.w_down.to(dt))
