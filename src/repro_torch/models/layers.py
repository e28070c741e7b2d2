"""Layers on ``torch``: RMSNorm, RoPE/M-RoPE (and DeepSeek-V2's YaRN
frequencies), GQA attention (one core, :func:`_sdpa`, plain or
online-softmax (flash), over the step's keys or a cache), the int8 KV
cache, MLA (DeepSeek-V2 latent attention, with its latent norm), the
SwiGLU MLP with its binarized (PuM) variant, the top-k MoE
(capacity-bound, or dropless with grouped expert products; sigmoid-routed
with relu² or SwiGLU experts), the Mamba2/SSD mixers and Kimi Delta
Attention (a gated delta rule over a matrix state a head).

Conventions (the reference's, :mod:`repro.models.layers`)
---------------------------------------------------------
* every layer has ``<layer>_defs(cfg) → ParamDef tree``; its module
  (:class:`RMSNorm`, :class:`Attention`, :class:`MLAttention`,
  :class:`MLP`, :class:`PumMLP`, :class:`MoE`, :class:`SSMMixer`) holds parameters of those names and shapes, so a reference parameter
  tree loads into it leaf for leaf;
* parameters are stored in ``cfg.param_dtype`` (float32 in the ten
  configs the reference shares) and used in ``cfg.compute_dtype``
  (``_cast``, which counts the bytes a cast reads and writes in
  ``models.weight_cast_bytes``): under grad cast at each use, so
  gradients reach them; without grad cast once into a copy the parameter
  keeps (:class:`_Copy`), which later uses share while the parameter
  holds the values it was cast from.  Every cast, upcast and rounding
  happens in the reference's order, so bf16 results round where the
  reference's do;
* decode paths take explicit caches and write this step's keys and values
  into them in place (the cache tensors are the caller's; only ``pos``
  is returned anew).  A write past the cache's end raises instead of
  shifting, as ``dynamic_update_slice`` would;
* attention is causal; cached attention sees the cache prefix up to each
  query's own position.

None of these is a Pallas kernel in the reference: they are ``jnp``
einsums and blockwise ``lax.scan``s (flash attention, the SSD scan), and
stay plain ``torch`` here, the scans as Python loops; only one-token GQA
attention on the card runs a kernel of the port's own
(:mod:`..kernels.decode_attention`), which reads the cache in place where
the einsums copied it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate
from torch.multiprocessing.reductions import StorageWeakRef

from .. import telemetry
from ..configs.base import ModelConfig
from ..distributed.sharding import routing_placements
from ..kernels.decode_attention import DTYPE as DECODE_ATTN_DTYPE
from ..kernels.decode_attention import decode_attention
from .params import ParamDef

P = ParamDef


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _pdt(cfg: ModelConfig) -> torch.dtype:
    """The dtype parameters are held in (``cfg.param_dtype``)."""
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def _cast(w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Weight ``w`` in ``dt``.  A cast that changes the dtype adds the
    bytes it reads and writes to the ``models.weight_cast_bytes`` counter.
    Without grad a parameter (a leaf ``nn.Parameter``, not a DTensor nor a
    tensor made from one) is served its :class:`_Copy` in ``dt``, cast
    here at its first such use or after the parameter changed; anything
    else, and any use under grad, is cast at its use."""
    if w.dtype == dt:
        return w
    if type(w) is nn.Parameter and not torch.is_grad_enabled():
        return _copy_of(w, dt)
    _count_cast(w, dt)
    return w.to(dt)


def _count_cast(w: torch.Tensor, dt: torch.dtype) -> None:
    telemetry.count("models.weight_cast_bytes",
                    w.numel() * (w.element_size() + dt.itemsize))


class _Copy:
    """A parameter's values in another dtype, kept on the parameter
    (``_cast_copy``) and shared by its uses without grad.  It holds while
    the parameter has the version counter, data pointer and storage of
    its last fill: an in-place change (an optimizer step, ``copy_``,
    ``load_state_dict``) moves the counter; ``.data =`` keeps the counter
    but not the storage; a parameter replaced by another object has no
    copy.  A change made through ``.data`` in place moves nothing and is
    not seen.  A refill writes the same tensor in place (``out``'s address
    never changes, so a CUDA graph that reads it stays valid), on the
    current stream (``models.weight_cache.fills``, its bytes in
    ``models.weight_cast_bytes``)."""

    __slots__ = ("out", "version", "ptr", "storage")

    def __init__(self, w: torch.Tensor, dt: torch.dtype):
        self.out = torch.empty_like(w, dtype=dt, requires_grad=False)
        self.fill(w)

    def holds(self, w: torch.Tensor) -> bool:
        return (w._version == self.version and w.data_ptr() == self.ptr
                and not self.storage.expired())

    def fill(self, w: torch.Tensor) -> None:
        _count_cast(w, self.out.dtype)
        telemetry.count("models.weight_cache.fills")
        self.out.copy_(w.detach())
        self.version, self.ptr = w._version, w.data_ptr()
        self.storage = StorageWeakRef(w.untyped_storage())

    def __reduce__(self):
        # a pickled parameter carries no copy: the storage reference means
        # nothing in another process
        return type(None), ()


def _copy_of(w: nn.Parameter, dt: torch.dtype) -> torch.Tensor:
    """``w``'s :class:`_Copy` in ``dt`` (``models.weight_cache.hits``),
    refilled in place if ``w`` changed, made anew if ``w`` keeps none of
    ``dt`` and ``w``'s layout.  A CUDA graph's capture fills none: a miss
    there casts at its use (the recording then redoes that cast)."""
    c = _kept_copy(w)
    kept = (c is not None and c.out.dtype == dt
            and c.out.shape == w.shape and c.out.stride() == w.stride())
    if kept and c.holds(w):
        telemetry.count("models.weight_cache.hits")
        return c.out
    if w.is_cuda and torch.cuda.is_current_stream_capturing():
        _count_cast(w, dt)
        return w.to(dt)
    if kept:
        c.fill(w)
    else:
        c = w._cast_copy = _Copy(w, dt)
    return c.out


def _kept_copy(w: torch.Tensor) -> _Copy | None:
    """The :class:`_Copy` parameter ``w`` keeps, if any."""
    return getattr(w, "_cast_copy", None)


def _param(d: ParamDef, device, dtype: torch.dtype = torch.float32
           ) -> nn.Parameter:
    """An uninitialised parameter of ``d``'s shape in ``dtype`` (the
    config's :func:`_pdt`; filled by ``Transformer.load_params``)."""
    return nn.Parameter(torch.empty(d.shape, dtype=dtype, device=device))


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
    def __init__(self, d: int, eps: float = 1e-5, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = _param(rmsnorm_defs(d)["scale"], device, dtype)

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


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention-temperature factor of a context ``factor``."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


# DeepSeek-V2's YaRN settings besides the factor and mscale, the only
# ones the port computes: the original context, and the rotations over it
# that bound the correction range
YARN_ORIGINAL_POSITIONS = 4096
YARN_BETA_FAST = 32
YARN_BETA_SLOW = 1


def yarn_freqs(cfg: ModelConfig, dim: int, device=None):
    """DeepSeek-V2's YaRN inverse frequencies of ``dim`` rope dims (its
    ``DeepseekV2YarnRotaryEmbedding``): the original ``θ^(-2i/dim)`` below
    the correction range, those divided by ``cfg.yarn_factor`` above it,
    and a linear ramp between; the range's ends are the dims that turn
    ``YARN_BETA_FAST`` and ``YARN_BETA_SLOW`` times over
    ``YARN_ORIGINAL_POSITIONS`` positions."""
    base = cfg.rope_theta

    def corr(rotations):
        return (dim * math.log(YARN_ORIGINAL_POSITIONS
                               / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(corr(YARN_BETA_FAST)), 0)
    high = min(math.ceil(corr(YARN_BETA_SLOW)), dim - 1)
    if low == high:
        high += 0.001
    pw = base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                               device=device) / dim)
    extra, inter = 1.0 / pw, 1.0 / (cfg.yarn_factor * pw)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def _rotate(x, cos, sin):
    """x: (..., S, H, hd) rotated on its interleaved pairs by ``cos`` and
    ``sin`` (..., S, 1, hd/2) of ``x``'s dtype."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       -1).reshape(x.shape)


def _rotated(x, rope):
    """``x`` rotated by ``rope = (cos, sin)`` (:func:`_rotate`), or as it
    is where ``rope`` is None (no positions)."""
    return x if rope is None else _rotate(x, *rope)


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
    return _rotate(x, cos.to(x.dtype), sin.to(x.dtype))


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
FLASH_DECODE_KEYS = 16384    # cached attention past this many keys: flash


def _long(s: int, t: int) -> bool:
    """Whether ``s`` queries over ``t`` keys take the online-softmax path:
    past ``FLASH_THRESHOLD``² scores a head."""
    return s * t > FLASH_THRESHOLD * FLASH_THRESHOLD


def _causal(s: int, q_offset, device, t: int | None = None):
    """The (S, T) mask of queries at positions ``q_offset``.. over the keys
    up to each one's own position; ``t`` keys, ``q_offset + s`` unless
    given (``q_offset`` may then be a device tensor of shape (1,))."""
    qpos = torch.arange(s, device=device)[:, None] + q_offset
    keys = q_offset + s if t is None else t
    return torch.arange(keys, device=device)[None, :] <= qpos


def _sdpa_naive(q, k, v, causal: bool, q_offset=0):
    """q: (B,S,H,hd); k/v: (B,T,KV,hd) — grouped by broadcasting.  Causal,
    query i sits at position ``q_offset + i`` (a device tensor of shape
    (1,) for a CUDA graph's step) and sees the keys up to it."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    q = q.reshape(b, s, kv, h // kv, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k) / math.sqrt(hd)
    scores = scores.float()
    if causal:
        scores = torch.where(_causal(s, q_offset, q.device, t), scores, -1e30)
    w = torch.softmax(scores, -1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, h, hd)


def _flash_attn(q, k, v, causal: bool, q_offset: int = 0, kv_len=None,
                block_q: int = FLASH_BLOCK_Q, block_k: int = FLASH_BLOCK_K,
                scale: float | None = None):
    """Online-softmax attention: O(S·hd) memory instead of O(S·T).

    q: (B,S,H,hd); k/v: (B,T,KV,hd).  ``kv_len``: optional scalar — only
    cache positions < kv_len + current block are attendable (decode).  The
    reference's scan over q blocks × scan over kv blocks becomes two
    Python loops with the same carry (running max, sum, accumulator).
    Causal, the key blocks wholly after a query block are skipped: there
    every score is masked, so each adds exactly 0 to the sum and the
    accumulator.  ``scale`` multiplies the scores (``hd^-0.5`` unless
    given).
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
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    dev = q.device
    outs = []
    for qi in range(nq):
        qpos = qi * bq + torch.arange(bq, device=dev) + q_offset
        last_k = nk if not causal else min(nk, (qi * bq + bq - 1
                                                + q_offset) // bk + 1)
        m = torch.full((b, kv, g, bq), -math.inf, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kv, g, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kv, g, bq, hd_v), dtype=torch.float32,
                          device=dev)
        for ki in range(last_k):
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


def _flash(s: int, t: int) -> bool:
    """Whether :func:`_sdpa` takes the online-softmax path for ``s``
    queries over ``t`` keys: past ``FLASH_THRESHOLD``² scores a head, or
    past ``FLASH_DECODE_KEYS`` keys (a long cache)."""
    return _long(s, t) or t > FLASH_DECODE_KEYS


def _sdpa(q, k, v, causal: bool, q_offset=0):
    """GQA attention, uncached or over a cache.  One query a sequence
    (``models.attn.one_token``) in bf16 on the card runs the
    decode-attention kernel (:func:`~..kernels.decode_attention.
    decode_attention`), which reads the cache in place up to the query's
    position; everything else takes plain scores (:func:`_sdpa_naive`) or
    the online-softmax path (:func:`_flash_attn`, whose ``q_offset`` is a
    host int) as :func:`_flash` decides."""
    one = q.shape[1] == 1
    if one:
        telemetry.count("models.attn.one_token")
    if one and q.is_cuda and q.dtype == DECODE_ATTN_DTYPE:
        fn = decode_attention
    else:
        fn = _flash_attn if _flash(q.shape[1], k.shape[1]) else _sdpa_naive
    return _blockwise(lambda q, k, v: fn(q, k, v, causal, q_offset), q, k, v)


def _check_room(pos: int, s: int, t: int) -> None:
    """Raise unless ``s`` positions from ``pos`` fit a cache of ``t``."""
    if pos + s > t:
        raise ValueError(f"cache overflow: writing positions {pos}..{pos + s - 1}"
                         f" into a cache of {t}")


def _write(cache: torch.Tensor, update: torch.Tensor, pos):
    """Write ``update`` into ``cache`` along axis 1 at ``pos``, in place.
    ``pos`` is a Python int, or a device tensor of shape (1,) (int64) for
    one token: an ``index_copy_`` there, whose room the caller checked."""
    if torch.is_tensor(pos):
        return cache.index_copy_(1, pos, update.to(cache.dtype))
    s = update.shape[1]
    _check_room(pos, s, cache.shape[1])
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
            self.register_parameter(name, _param(d, device, _pdt(cfg)))

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
            p, new_cache = 0, None
        elif "k_scale" in cache:
            # int8-quantized KV cache: int8 codes + per-(token, head) scale
            p = cache["pos"]
            kq, ks = _quant(k)
            vq, vs = _quant(v)
            ck, cks = _write(cache["k"], kq, p), _write(cache["k_scale"], ks, p)
            cv, cvs = _write(cache["v"], vq, p), _write(cache["v_scale"], vs, p)
            k = ck.to(dt) * cks.to(dt)[..., None]
            v = cv.to(dt) * cvs.to(dt)[..., None]
            new_cache = {"k": ck, "v": cv, "k_scale": cks, "v_scale": cvs,
                         "pos": p + q.shape[1]}
        else:
            p = cache["pos"]
            ck = _write(cache["k"], k, p)
            cv = _write(cache["v"], v, p)
            k, v = ck.to(dt), cv.to(dt)
            new_cache = {"k": ck, "v": cv, "pos": p + q.shape[1]}
        y = _sdpa(q, k, v, causal=True, q_offset=p)
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
    if cfg.kv_norm:
        defs["kv_norm"] = {"scale": P((r,), ("lora",), init="ones")}
    return defs


class MLAttention(nn.Module):
    """Latent attention with the reference's parameter names; cached decode
    keeps only the compressed kv latent ``c`` and the RoPE key
    ``k_rope``.  With ``cfg.kv_norm`` the latent is RMS-normalised
    (``kv_norm.scale``) before it is cached or projected; with
    ``cfg.yarn_factor > 1`` the rope takes YaRN's frequencies
    (:func:`yarn_freqs`) and the scores YaRN's temperature,
    ``yarn_mscale(factor, mscale)²`` (mscale is mscale_all_dim, so the
    cos/sin factor, their ratio, is 1).  With ``cfg.rope == "none"``
    (Kimi Linear's NoPE MLA) the ``rope_head_dim`` parts of the query and
    the shared key enter the scores, and the cache, unrotated."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        for name, d in mla_defs(cfg).items():
            if name != "kv_norm":
                self.register_parameter(name, _param(d, device, _pdt(cfg)))
        if cfg.kv_norm:
            self.kv_norm = RMSNorm(cfg.kv_lora_rank, cfg.norm_eps, device,
                                   _pdt(cfg))
        self.scale = (1.0 / math.sqrt(cfg.hd + cfg.rope_head_dim)
                      * yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale) ** 2)

    def rope(self, positions, dtype: torch.dtype):
        """``(cos, sin)`` (..., S, 1, rope_head_dim/2) of ``positions`` in
        ``dtype``: the rotation of every layer's rope dims, which the
        :class:`Transformer` makes once a forward; None without positions
        (``rope="none"``)."""
        cfg = self.cfg
        if cfg.rope == "none":
            return None
        rh = cfg.rope_head_dim
        freqs = (yarn_freqs(cfg, rh, positions.device) if cfg.yarn_factor > 1
                 else rope_freqs(rh, cfg.rope_theta, positions.device))
        ang = positions[..., :, None].float() * freqs
        return (ang.cos()[..., None, :].to(dtype),
                ang.sin()[..., None, :].to(dtype))

    def forward(self, x, positions, cache=None, rope=None):
        """Returns ``(y, new_cache)``; ``cache`` = dict(c, k_rope, pos), one
        layer's; ``rope``: :meth:`rope` of ``positions``, made here if not
        given.  Attention reads the positions written so far: a cached
        step scores against the latent directly (the absorbed decode); a
        step without a cache, or one past ``FLASH_THRESHOLD``² scores a
        head, attends over explicit keys and values (:meth:`_explicit`).
        A one-token step with a cache reads the whole cache, the keys past
        its position masked, whether ``pos`` is an int (eager) or a device
        tensor (the step a CUDA graph records): both sum over the same
        length, so their logits are bit-equal.  Such a step is the span
        ``models.mla.decode`` and adds the latent-cache bytes it reads to
        ``models.mla.latent_bytes``; any other step is
        ``models.mla.prefill``."""
        decode = cache is not None and x.shape[1] == 1
        with telemetry.span("models.mla.decode" if decode
                            else "models.mla.prefill"):
            return self._attend(x, positions, cache, rope)

    def _attend(self, x, positions, cache, rope):
        cfg = self.cfg
        dt = _dt(cfg)
        r, hd = cfg.kv_lora_rank, cfg.hd
        rope = self.rope(positions, dt) if rope is None else rope
        ckv = torch.einsum("bsd,dr->bsr", x, _cast(self.w_dkv, dt))
        c, k_rope = ckv[..., :r], ckv[..., r:]
        if cfg.kv_norm:
            c = self.kv_norm(c)
        k_rope = _rotated(k_rope[:, :, None, :], rope)
        if cfg.q_lora_rank:
            q = torch.einsum("bsd,dr->bsr", x, _cast(self.w_dq, dt))
            q = torch.einsum("bsr,rhk->bshk", q, _cast(self.w_uq, dt))
        else:
            q = torch.einsum("bsd,dhk->bshk", x, _cast(self.w_q, dt))
        q_nope, q_rope = q[..., :hd], _rotated(q[..., hd:], rope)
        b, s = x.shape[:2]
        p, t, new_cache = 0, s, None
        if cache is not None:
            p = cache["pos"]
            cc = _write(cache["c"], c, p)
            cr = _write(cache["k_rope"], k_rope[:, :, 0, :], p)
            new_cache = {"c": cc, "k_rope": cr, "pos": p + s}
            t = cc.shape[1] if s == 1 else p + s
            c, k_rope = cc[:, :t].to(dt), cr[:, :t, None, :].to(dt)
        if cache is None or _long(s, t):
            y = self._explicit(q_nope, q_rope, c, k_rope, p)
        else:
            if s == 1:
                telemetry.count("models.mla.latent_bytes", b * t * (
                    r * cc.element_size()
                    + cfg.rope_head_dim * cr.element_size()))
            q_abs = torch.einsum("bshk,rhk->bshr", q_nope,
                                 _cast(self.w_uk, dt))
            scores = (torch.einsum("bshr,btr->bhst", q_abs, c)
                      + torch.einsum("bshk,btk->bhst", q_rope, k_rope[:, :, 0])
                      ) * self.scale
            scores = torch.where(_causal(s, p, x.device, t),
                                 scores.float(), -1e30)
            w = torch.softmax(scores.float(), -1).to(dt)
            y_lat = torch.einsum("bhst,btr->bshr", w, c)
            y = torch.einsum("bshr,rhk->bshk", y_lat, _cast(self.w_uv, dt))
        y = torch.einsum("bshk,hkd->bsd", y, _cast(self.wo, dt))
        return y, new_cache

    def _explicit(self, q_nope, q_rope, c, k_rope, q_offset: int,
                  block_q: int = FLASH_BLOCK_Q, block_k: int = FLASH_BLOCK_K):
        """Causal attention of queries from position ``q_offset`` over the
        explicit keys and values of latents ``c`` (B,T,r) and rope keys
        ``k_rope`` (B,T,1,rh): plain scores, or past ``FLASH_THRESHOLD``²
        a head the nope/rope components as one head dim through the
        online-softmax path in ``block_q`` × ``block_k`` blocks, so that no
        (B,H,S,T) scores exist."""
        dt = _dt(self.cfg)
        s, t = q_nope.shape[1], c.shape[1]
        k_nope = torch.einsum("btr,rhk->bthk", c, _cast(self.w_uk, dt))
        v = torch.einsum("btr,rhk->bthk", c, _cast(self.w_uv, dt))
        if _long(s, t):
            k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:-1], -1)], -1)
            del k_nope
            return _flash_attn(torch.cat([q_nope, q_rope], -1), k, v,
                               causal=True, q_offset=q_offset,
                               block_q=block_q, block_k=block_k,
                               scale=self.scale)
        scores = (torch.einsum("bshk,bthk->bhst", q_nope, k_nope)
                  + torch.einsum("bshk,btzk->bhst", q_rope, k_rope)
                  ) * self.scale
        scores = torch.where(_causal(s, q_offset, c.device), scores.float(),
                             -1e30)
        w = torch.softmax(scores, -1).to(dt)
        return torch.einsum("bhst,bthk->bshk", w, v)


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
            self.register_parameter(name, _param(d, device, _pdt(cfg)))

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
    ``n_shared_experts``) is a dense :class:`MLP` added to every token.
    With ``cfg.dropless`` every routed pair is computed instead
    (:meth:`_dropless`); ``cfg.norm_topk_prob`` renormalises the gates."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        # the experts held: [first, first + held) of the router's, all here
        self.first, self.held = 0, cfg.n_experts
        for name, d in moe_defs(cfg).items():
            if name != "shared":
                self.register_parameter(name, _param(d, device, _pdt(cfg)))
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
        if self.cfg.norm_topk_prob:
            gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
        return probs, gate_vals, gate_idx

    def forward(self, x):
        """Returns ``(out, aux)``: the output and the load-balance loss."""
        cfg = self.cfg
        if cfg.dropless:
            return self._dropless(x)
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

    def _dropless(self, x):
        """Every token through its top-k experts, none dropped (DeepSeek's
        ``moe_infer``): the (token, expert) pairs sorted by expert
        (``models.moe.route``: router, top-k, sort, gather), each expert's
        rows one group of a grouped product, the outputs put back in pair
        order and summed with their gates in float32 (``models.moe.
        experts``), and the shared experts added.  A layer that holds a
        share of the experts (``first``, ``held``) sorts the pairs of the
        others last, where no group computes them, and they add nothing.
        Nothing here waits on the host; ``models.moe.pairs`` counts the
        pairs routed."""
        cfg = self.cfg
        dt = _dt(cfg)
        b, s, d = x.shape
        e, k = cfg.n_experts, cfg.experts_per_tok
        first, held = self.first, self.held
        n = b * s
        tokens = x.reshape(n, d)
        with telemetry.span("models.moe.route"):
            probs, gate, idx = (t[0] for t in self.route(tokens[None]))
            if held < e:
                idx = torch.where((idx >= first) & (idx < first + held),
                                  idx - first, held)
            experts, order = idx.reshape(-1).sort(stable=True)
            ends = torch.searchsorted(
                experts, torch.arange(1, held + 1, device=x.device)
            ).to(torch.int32)
            xs = tokens[order // k]
        telemetry.count("models.moe.pairs", n * k)
        with telemetry.span("models.moe.experts"):
            # row block i (rows ends[i-1]:ends[i]) times expert i's weight,
            # one grouped product each, the ends read on the device
            ys = self._experts(xs, ends)
            if held < e:
                # rows past the last group's end are no product's
                ys.masked_fill_(experts[:, None] == held, 0)
            y = torch.empty_like(ys).index_copy_(0, order, ys)
            out = (y.view(n, k, d).float() * gate[..., None]).sum(1).to(dt)
        if cfg.n_shared_experts:
            out = out + self.shared(tokens[None])[0]
        counts = torch.diff(ends, prepend=ends.new_zeros(1))
        aux = e * torch.sum(probs.mean(0)[first:first + held]
                            * counts.float() / (n * k))
        return out.reshape(b, s, d), aux

    def _experts(self, xs, ends):
        """The SwiGLU experts over rows ``xs`` grouped by ``ends``."""
        dt = _dt(self.cfg)
        h = (F.silu(torch._grouped_mm(xs, _cast(self.w_gate, dt), offs=ends))
             * torch._grouped_mm(xs, _cast(self.w_up, dt), offs=ends))
        return torch._grouped_mm(h, _cast(self.w_down, dt), offs=ends)


# ---------------------------------------------------------------------------
# nemotron_h's MoE: sigmoid router with a choice bias, relu² or SwiGLU
# experts
# ---------------------------------------------------------------------------

def relu2_mlp_defs(cfg: ModelConfig, d_ff: int):
    d = cfg.d_model
    return {"w_up": P((d, d_ff), ("embed", "mlp")),
            "w_down": P((d_ff, d), ("mlp", "embed"))}


class Relu2MLP(nn.Module):
    """``down(relu(up x)²)``: ``nemotron_h``'s non-gated MLP."""

    def __init__(self, cfg: ModelConfig, device="cuda", d_ff: int = 0):
        super().__init__()
        self.cfg = cfg
        for name, d in relu2_mlp_defs(cfg, d_ff).items():
            self.register_parameter(name, _param(d, device, _pdt(cfg)))

    def forward(self, x):
        dt = _dt(self.cfg)
        h = torch.relu(torch.einsum("bsd,df->bsf", x, _cast(self.w_up, dt)))
        return torch.einsum("bsf,fd->bsd", h.square(), _cast(self.w_down, dt))


def sigmoid_moe_defs(cfg):
    """A :class:`SigmoidMoE`'s parameters: the router over all
    ``n_experts`` and its ``choice_bias`` (the published
    ``e_score_correction_bias``), the ``held`` experts' ``w_up``/``w_down``
    (and ``w_gate``, SwiGLU) and the shared expert of
    ``shared_expert_width``."""
    d, e, h, f = cfg.d_model, cfg.n_experts, cfg.held, cfg.d_expert
    defs = {"router": P((d, e), ("embed", None)),
            "choice_bias": P((e,), (None,), init="zeros"),
            "w_up": P((h, d, f), ("experts", "embed", None)),
            "w_down": P((h, f, d), ("experts", None, "embed"))}
    if cfg.ffn_act == "swiglu":
        defs["w_gate"] = P((h, d, f), ("experts", "embed", None))
        defs["shared"] = mlp_defs(cfg, cfg.shared_expert_width)
    else:
        defs["shared"] = relu2_mlp_defs(cfg, cfg.shared_expert_width)
    return defs


class SigmoidMoE(MoE):
    """``nemotron_h``'s MoE (DeepSeek-V3's router), dropless: scores
    ``sigmoid(h · router)`` in float32; the top-k of ``scores +
    choice_bias`` chosen; their gates the chosen scores, renormalised,
    times ``routed_scaling``; experts of ``cfg.ffn_act`` (relu², or
    SwiGLU as :meth:`MoE._experts` computes them) and one shared expert of
    the same kind added ungated.  It holds experts ``first_expert`` ..
    ``first_expert + held − 1`` and routes over all ``n_experts``: the
    pairs of the others contribute nothing (:meth:`MoE._dropless`)."""

    def __init__(self, cfg, device="cuda"):
        nn.Module.__init__(self)
        self.cfg = cfg
        self.first, self.held = cfg.first_expert, cfg.held
        for name, d in sigmoid_moe_defs(cfg).items():
            if name != "shared":
                self.register_parameter(name, _param(d, device, _pdt(cfg)))
        self.shared = (MLP if cfg.ffn_act == "swiglu" else Relu2MLP)(
            cfg, device, cfg.shared_expert_width)

    def route(self, tokens):
        """Scores (G, S, E), gates and experts (G, S, k) of ``tokens``."""
        scores = torch.sigmoid(torch.einsum("gtd,de->gte", tokens.float(),
                                            self.router.float()))
        idx = torch.topk(scores + self.choice_bias.float(),
                         self.cfg.experts_per_tok)[1]
        gate = scores.gather(-1, idx)
        gate = gate / (gate.sum(-1, keepdim=True) + 1e-20)
        return scores, gate * self.cfg.routed_scaling, idx

    def forward(self, x):
        return self._dropless(x)

    def _experts(self, xs, ends):
        if self.cfg.ffn_act == "swiglu":
            return super()._experts(xs, ends)
        dt = _dt(self.cfg)
        h = torch.relu(torch._grouped_mm(xs, _cast(self.w_up, dt),
                                         offs=ends))
        return torch._grouped_mm(h.square(), _cast(self.w_down, dt),
                                 offs=ends)


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
    """SSD scan of the JAX-parity SSM mixer.  xh: (B,S,nh,hd) inputs ·dt;
    a: (B,S,nh) per-step decay in (0,1);  b,c: (B,S,N), one group.
    Returns (B,S,nh,hd): :func:`_ssd_scan` from a zero state.
    ``f32=False`` rounds the products' operands to bf16 and contracts in
    float32 (the reference's ``preferred_element_type``: a product of bf16
    values is exact in float32); decay and cumsum stay float32.
    """
    mm = None if f32 else (lambda t: t.to(torch.bfloat16).float())
    return _ssd_scan(xh.float(), torch.log(a + 1e-20), b[:, :, None],
                     c[:, :, None], chunk, mm=mm)[0]


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
                self.register_parameter(name, _param(d, device, _pdt(cfg)))
        self.norm = RMSNorm(cfg.d_inner, device=device, dtype=_pdt(cfg))

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


# ---------------------------------------------------------------------------
# nemotron_h's Mamba-2 mixer: grouped B/C, conv bias, a gated norm over
# groups, and a cached prefill that leaves the state decoding would leave
# ---------------------------------------------------------------------------

def mamba2_defs(cfg: ModelConfig):
    """The input projection ``[z | xBC | dt]`` (widths ``d_inner``, the conv
    channels, ``ssm_heads``), the depthwise conv over the ``d_inner +
    2 · ssm_groups · ssm_state`` channels of xBC (and its bias), per head
    ``a_log``, ``d_skip`` and ``dt_bias``, the gated norm's scale and the
    output projection."""
    d, di, nh = cfg.d_model, cfg.d_inner, cfg.n_ssm_heads
    ch = mamba2_conv_channels(cfg)
    defs = {
        "w_in": P((d, di + ch + nh), ("embed", "inner")),
        "conv_w": P((4, ch), (None, "inner"), scale=0.5),
        "a_log": P((nh,), (None,), init="ones"),
        "d_skip": P((nh,), (None,), init="ones"),
        "dt_bias": P((nh,), (None,), init="zeros"),
        "norm": rmsnorm_defs(di),
        "w_out": P((di, d), ("inner", "embed")),
    }
    if cfg.conv_bias:
        defs["conv_b"] = P((ch,), ("inner",), init="zeros")
    return defs


def mamba2_conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def mamba2_cache_shape(cfg: ModelConfig, batch: int):
    """One layer's conv window (the last 3 xBC inputs) and state."""
    return {"conv": (batch, 3, mamba2_conv_channels(cfg)),
            "state": (batch, cfg.n_ssm_heads, cfg.ssm_head_dim,
                      cfg.ssm_state)}


def _short_conv(x, cache, w):
    """The causal depthwise convolution of 4 taps ``w`` (4, ch) over ``x``
    (B,S,ch), after the window of the cache's last 3 inputs (``cache
    ["conv"]``; zeros without a cache).  Returns ``(conv, xpad)``: xpad is
    ``x`` after the window, whose last 3 rows are the next window."""
    window = (x.new_zeros(x.shape[0], 3, x.shape[-1]) if cache is None
              else cache["conv"].to(x.dtype))
    xpad = torch.cat([window, x], 1)
    s = x.shape[1]
    return sum(xpad[:, i:i + s] * w[i] for i in range(4)), xpad


def _segsum(x):
    """``out[..., i, j] = Σ_{j < r ≤ i} x[..., r]`` for j ≤ i, −inf above
    the diagonal, summed without differences of long cumulative sums."""
    t = x.shape[-1]
    ones = torch.ones(t, t, dtype=torch.bool, device=x.device)
    seg = x[..., :, None].expand(*x.shape, t)             # [r, j] = x_r
    seg = seg.masked_fill(~torch.tril(ones, -1), 0).cumsum(-2)
    return seg.masked_fill(~torch.tril(ones), -math.inf)


def _ssd_scan(xdt, la, b, c, chunk: int, h0=None, mm=None):
    """The grouped SSD (Mamba-2) of one or more sequences, in chunks:
    ``y_t = Σ_{s ≤ t} (c_t · b_s) exp(Σ_{s < r ≤ t} la_r) xdt_s
    + exp(Σ_{r ≤ t} la_r) c_t · h0``, and the state after the last
    position, ``h = Σ_s exp(Σ_{s < r} la_r) xdt_s ⊗ b_s + exp(Σ la) h0``.

    xdt: (B,S,nh,hd) float32, the inputs times dt; la: (B,S,nh) the log
    decays A·dt (≤ 0); b, c: (B,S,G,N), head h reading group
    ``h // (nh / G)``; h0: (B,nh,hd,N) or None (zeros).  Any length: a
    ragged last chunk is padded with xdt = 0 and la = 0, which add nothing
    and decay nothing, so the padding is exact.  Within a chunk the
    quadratic form; across chunks each chunk's state is carried by the
    decay matrix of the chunks between (:func:`_segsum`), with no loop.
    ``mm``, where given, rounds the operands of every product (the
    JAX-parity mixer's bf16 rounding, :func:`_ssd_chunked`).
    Returns ``(y (B,S,nh,hd), h (B,nh,hd,N))``, float32."""
    r = mm or (lambda t: t)
    bs, s, nh, hd = xdt.shape
    g, n = b.shape[2:]
    p = nh // g
    pad = -s % chunk
    if pad:
        xdt, la, b, c = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
                         for t in (xdt, la, b, c))
    nc = (s + pad) // chunk
    x = xdt.reshape(bs, nc, chunk, g, p, hd)
    b = b.reshape(bs, nc, chunk, g, n)
    c = c.reshape(bs, nc, chunk, g, n)
    cum = la.reshape(bs, nc, chunk, g, p).cumsum(2)       # (B,Z,Q,G,P)
    # within a chunk: the decay from position s to t ≥ s
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                   device=x.device))[:, :, None, None]
    seg = cum[:, :, :, None] - cum[:, :, None]            # (B,Z,Q,Q,G,P)
    decay = torch.exp(seg.masked_fill(~causal, -math.inf))
    del seg
    cb = torch.einsum("bzqgn,bzsgn->bzqsg", r(c), r(b))
    y = torch.einsum("bzqsgp,bzsgpd->bzqgpd", r(cb)[..., None] * r(decay),
                     r(x))
    del decay, cb
    # each chunk's part of the state at its end, then the state entering
    # every chunk (and the last): h0 and the chunks before, decayed
    to_end = torch.exp(cum[:, :, -1:] - cum)
    states = torch.einsum("bzsgn,bzsgpd->bzgpdn", r(b),
                          r(x) * r(to_end)[..., None])
    if h0 is None:
        h0 = states.new_zeros(bs, g, p, hd, n)
    states = torch.cat([h0.reshape(bs, 1, g, p, hd, n), states], 1)
    last = F.pad(cum[:, :, -1].permute(0, 2, 3, 1), (1, 0))  # (B,G,P,Z+1)
    entering = torch.einsum("bgpzw,bwgpdn->bzgpdn",
                            torch.exp(_segsum(last)), states)
    y = y + (torch.einsum("bzqgn,bzgpdn->bzqgpd", r(c), r(entering[:, :-1]))
             * r(torch.exp(cum))[..., None])
    return (y.reshape(bs, nc * chunk, nh, hd)[:, :s],
            entering[:, -1].reshape(bs, nh, hd, n))


def _gated_group_norm(y, z, scale, groups: int, eps: float, dt):
    """``nemotron_h``'s gated RMSNorm: ``y · silu(z)`` normalised over each
    of ``groups`` equal groups of channels in float32, times ``scale``."""
    v = (y.float() * F.silu(z.float())).unflatten(-1, (groups, -1))
    v = v * torch.rsqrt(v.square().mean(-1, keepdim=True) + eps)
    return v.flatten(-2).to(dt) * _cast(scale, dt)


class Mamba2Mixer(nn.Module):
    """``nemotron_h``'s Mamba-2 mixer (the reference has none; its
    :class:`SSMMixer` is the JAX-parity one).  ``[z | xBC | dt] = x ·
    w_in``; ``xBC = silu(causal depthwise conv4(xBC) + conv_b)``, split into
    x (``d_inner``), B and C (``ssm_groups × ssm_state`` each); ``dt =
    softplus(dt + dt_bias)``, ``A = −exp(a_log)``; the SSD (head h reads
    group h // (heads / groups)) plus ``d_skip · x``; then ``w_out`` of the
    gated norm of ``y · silu(z)`` over groups of ``d_inner / ssm_groups``.

    With a cache (conv window (B,3,ch), float32 state (B,nh,hd,N)) both
    are written in place: a one-token step runs the recurrence
    (``models.ssm.step``); any other forward the chunked scan
    (:func:`_ssd_scan`, ``models.ssm.scan``) from the cached state and
    window, one sequence at a time, leaving the state and window that
    token-by-token decoding would leave.  A cached forward adds the bytes
    of state and window it reads and writes to ``models.ssm.state_bytes``.
    """

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        for name, d in mamba2_defs(cfg).items():
            if name != "norm":
                self.register_parameter(name, _param(d, device, _pdt(cfg)))
        self.norm = RMSNorm(cfg.d_inner, cfg.norm_eps, device, _pdt(cfg))

    def forward(self, x, cache=None):
        """Returns ``(y, None)``; ``cache`` = dict(conv, state), one
        layer's, updated in place."""
        cfg = self.cfg
        dt_ = _dt(cfg)
        b_, s, _ = x.shape
        di, nh, hd = cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_head_dim
        g, n = cfg.ssm_groups, cfg.ssm_state
        gn = g * n
        z, xbc, dt_raw = torch.einsum(
            "bsd,de->bse", x, _cast(self.w_in, dt_)).split(
                [di, di + 2 * gn, nh], -1)
        conv, xpad = _short_conv(xbc, cache, _cast(self.conv_w, dt_))
        if cfg.conv_bias:
            conv = conv + _cast(self.conv_b, dt_)
        xs, bm, cm = F.silu(conv).split([di, gn, gn], -1)
        dtv = _softplus(dt_raw.float() + self.dt_bias.float())  # (B,S,nh)
        la = -torch.exp(self.a_log.float()) * dtv
        xh = xs.reshape(b_, s, nh, hd).float()
        bm = bm.reshape(b_, s, g, n).float()
        cm = cm.reshape(b_, s, g, n).float()
        if cache is not None and s == 1:
            with telemetry.span("models.ssm.step"):
                y = self._step(cache["state"], xh[:, 0], dtv[:, 0], la[:, 0],
                               bm[:, 0], cm[:, 0])[:, None]
        else:
            with telemetry.span("models.ssm.scan"):
                y = self._scan(xh, dtv, la, bm, cm, cache)
        y = y + self.d_skip.float()[:, None] * xh
        y = _gated_group_norm(y.reshape(b_, s, di), z, self.norm.scale, g,
                              cfg.norm_eps, dt_)
        out = torch.einsum("bse,ed->bsd", y, _cast(self.w_out, dt_))
        if cache is not None:
            cache["conv"].copy_(xpad[:, -3:])
            telemetry.count("models.ssm.state_bytes", 2 * sum(
                cache[k].numel() * cache[k].element_size()
                for k in ("conv", "state")))
        return out, None

    def _step(self, state, x, dtv, la, bm, cm):
        """One token: ``h ← exp(la) h + (x · dt) ⊗ B``, ``y = h · C``; the
        state written in place."""
        rep = self.cfg.n_ssm_heads // self.cfg.ssm_groups
        bh, chh = bm.repeat_interleave(rep, 1), cm.repeat_interleave(rep, 1)
        h = (state * torch.exp(la)[..., None, None]
             + (x * dtv[..., None])[..., None] * bh[:, :, None, :])
        state.copy_(h)
        return torch.einsum("bhdn,bhn->bhd", h, chh)

    def _scan(self, xh, dtv, la, bm, cm, cache):
        """The chunked scan, one sequence at a time (which bounds its
        float32 chunk × chunk × heads temporaries), from and into the
        cached state where there is a cache."""
        ys = []
        for i in range(xh.shape[0]):
            one = slice(i, i + 1)
            y, h = _ssd_scan(xh[one] * dtv[one, ..., None], la[one], bm[one],
                             cm[one], self.cfg.ssm_chunk,
                             None if cache is None else cache["state"][one])
            if cache is not None:
                cache["state"][one].copy_(h)
            ys.append(y)
        return torch.cat(ys)


# ---------------------------------------------------------------------------
# Kimi Delta Attention (Kimi Linear): a gated delta rule over a matrix
# state per head, with a decay per key channel
# ---------------------------------------------------------------------------

KDA_CHUNK = 16         # positions a chunk of the chunked delta rule
KDA_GROUP = 4096       # positions (of all sequences) whose chunks are made
                       # ready at once, which bounds the (C, C, K) decays
L2_EPS = 1e-6          # the q/k L2 norm's epsilon (fla's ``l2norm``)


def kda_defs(cfg: ModelConfig):
    """The input projection ``[q | k | v | f_a | g_a | β]`` (widths H·K
    thrice, the gate rank K twice, H), the depthwise conv of 4 taps over
    q, k and v's channels, the gates' up-projections ``f_b`` and ``g_b``
    (K → H·K), ``A_log`` a head, ``dt_bias`` a key channel, the output
    norm's scale (K) and the output projection."""
    d, h, k = cfg.d_model, cfg.kda_heads, cfg.kda_head_dim
    w = h * k
    return {
        "w_in": P((d, 3 * w + 2 * k + h), ("embed", "inner")),
        "conv_w": P((4, 3 * w), (None, "inner"), scale=0.5),
        "f_b": P((k, w), (None, "inner")),
        "g_b": P((k, w), (None, "inner")),
        "a_log": P((h,), (None,), init="ones"),
        "dt_bias": P((w,), ("inner",), init="zeros"),
        "norm": rmsnorm_defs(k),
        "w_out": P((w, d), ("inner", "embed")),
    }


def kda_cache_shape(cfg: ModelConfig, batch: int):
    """One layer's conv window (the last 3 q/k/v inputs) and state."""
    h, k = cfg.kda_heads, cfg.kda_head_dim
    return {"conv": (batch, 3, 3 * h * k), "state": (batch, h, k, k)}


def _l2norm(x):
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + L2_EPS)


def _kda_step(state, q, k, v, g, beta):
    """One token a sequence and head: ``S ← Diag(e^g) S``, ``u = β (v −
    Sᵀk)``, ``S ← S + k uᵀ``, ``o = Sᵀq``.  state (B,H,K,V) float32,
    written in place; q, k, g (B,H,K); v (B,H,V); beta (B,H).  Returns o
    (B,H,V)."""
    state.mul_(torch.exp(g)[..., None])
    u = beta[..., None] * (v - torch.einsum("bhkv,bhk->bhv", state, k))
    state.add_(k[..., :, None] * u[..., None, :])
    return torch.einsum("bhkv,bhk->bhv", state, q)


def _kda_chunked(q, k, v, g, beta, s0=None, group: int = KDA_GROUP):
    """The gated delta rule of whole sequences in chunks of ``KDA_CHUNK``
    positions, from the state ``s0`` (B,H,K,V) (zeros if None): the
    outputs :func:`_kda_step` gives token by token and the state after the
    last position.  q, k (B,T,H,K) float32, k L2-normed (q also scaled);
    v (B,T,H,V); g (B,T,H,K) log decays ≤ 0; beta (B,T,H).

    In a chunk entered with state S₀, Γ_i the inclusive cumulative sum of
    g from the chunk's start: its updates solve ``(I + tril₋₁(diag β ·
    A)) U = diag β · (V − (K ⊙ e^Γ) S₀)``, ``A_ij = Σ_c k_ic k_jc
    e^{Γ_ic − Γ_jc}``; its outputs are ``o_i = S₀ᵀ(q_i ⊙ e^{Γ_i}) +
    Σ_{j ≤ i} u_j Σ_c q_ic k_jc e^{Γ_ic − Γ_jc}``; the state leaving it is
    ``Diag(e^{Γ_C}) S₀ + Σ_j (k_j ⊙ e^{Γ_C − Γ_j}) u_jᵀ``.  Every exponent
    is a difference Γ_i − Γ_j with j ≤ i (Γ_0 = 0), and the pairs above the
    diagonal are masked to −inf before ``exp``, so none is positive.  The
    solve leaves S₀ out: ``U = W_v − W_k S₀`` with ``W = (I + …)⁻¹ diag β
    [V | K ⊙ e^Γ]``, so the chunks' W, decayed q·k products and decays are
    made ``group`` positions (of all the sequences) at a time, no (C, C,
    K) tensor of more, and only the state passes from chunk to chunk, by
    three batched products.  A ragged last chunk is padded with q = k = v
    = 0, β = 0 and g = 0, which update and decay nothing.  Returns ``(o
    (B,T,H,V), state (B,H,K,V))``, float32."""
    b, t, h, dk = k.shape
    dv = v.shape[-1]
    chunk = KDA_CHUNK
    pad = -t % chunk
    if pad:
        q, k, v, g = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v, g))
        beta = F.pad(beta, (0, 0, 0, pad))
    n = (t + pad) // chunk
    state = (q.new_zeros(b * h, dk, dv) if s0 is None
             else s0.reshape(b * h, dk, dv).clone())
    out = q.new_empty(n, b * h, chunk, dv)
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                   device=q.device))
    per = max(1, group // (b * chunk))
    for c0 in range(0, n, per):
        c1 = min(n, c0 + per)
        span = slice(c0 * chunk, c1 * chunk)

        def part(x):        # (G, B·H, C, ·): the group's chunks, batched
            x = x[:, span].unflatten(1, (c1 - c0, chunk))
            return x.movedim(1, 0).transpose(2, 3).flatten(1, 2)
        qg, kg, vg, gg = (part(x) for x in (q, k, v, g))
        bg = part(beta[..., None])
        cum = gg.cumsum(2)                                      # Γ
        # [i, j, c] = e^{Γ_ic − Γ_jc} k_jc for j ≤ i, else 0
        kd = ((cum[..., :, None, :] - cum[..., None, :, :])
              .masked_fill_(~causal[..., None], -math.inf).exp_()
              .mul_(kg[..., None, :, :]))
        a = torch.einsum("...ijc,...ic->...ij", kd, kg)
        qk = torch.einsum("...ijc,...ic->...ij", kd, qg)
        del kd
        eg = cum.exp()
        wy = torch.linalg.solve_triangular(
            a.mul_(bg), torch.cat([vg, kg * eg], -1).mul_(bg),
            upper=False, unitriangular=True)
        wv, wk = (x.contiguous() for x in wy.split([dv, dk], -1))
        qt = qg * eg
        last = cum[..., -1:, :]
        kh = (kg * (last - cum).exp_()).mT.contiguous()   # (G, B·H, K, C)
        dc = last.exp().mT                                  # (G, B·H, K, 1)
        for i in range(c1 - c0):
            u = torch.baddbmm(wv[i], wk[i], state, alpha=-1)
            torch.baddbmm(torch.bmm(qk[i], u), qt[i], state,
                          out=out[c0 + i])
            state = torch.baddbmm(state * dc[i], kh[i], u)
    o = out.unflatten(1, (b, h)).permute(1, 0, 3, 2, 4).reshape(
        b, n * chunk, h, dv)
    return o[:, :t], state.reshape(b, h, dk, dv)


class KDAMixer(nn.Module):
    """Kimi Delta Attention (the reference has none).  ``[q | k | v | f_a
    | g_a | β] = x · w_in``; q, k and v each ``silu(causal depthwise
    conv4)`` (no bias); per head ``q̂ = q / ‖q‖ · K^-½``, ``k̂ = k /
    ‖k‖``; the log decay ``g = −exp(A_log) · softplus(f_a · f_b +
    dt_bias)`` a key channel; ``β = sigmoid(β)``; the delta rule
    (:func:`_kda_step`) over a K × V state a head; then ``w_out`` of
    ``RMSNorm_V(o) · scale · sigmoid(g_a · g_b)``.

    With a cache (conv window (B,3,3·H·K), float32 state (B,H,K,V)) both
    are written in place: a one-token step runs the recurrence
    (``models.kda.step``); any other forward the chunked rule
    (:func:`_kda_chunked`, ``models.kda.prefill``) from the cached state
    and window, leaving the state and window that token-by-token decoding
    would leave.  A cached forward adds the bytes of state and window it
    reads and writes to ``models.kda.state_bytes``."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        for name, d in kda_defs(cfg).items():
            if name != "norm":
                self.register_parameter(name, _param(d, device, _pdt(cfg)))
        self.norm = RMSNorm(cfg.kda_head_dim, cfg.norm_eps, device,
                            _pdt(cfg))

    def forward(self, x, cache=None):
        """Returns ``(y, None)``; ``cache`` = dict(conv, state), one
        layer's, updated in place."""
        cfg = self.cfg
        dt_ = _dt(cfg)
        b_, s, _ = x.shape
        h, hk = cfg.kda_heads, cfg.kda_head_dim
        w = h * hk
        qkv, fa, ga, beta = torch.einsum(
            "bsd,de->bse", x, _cast(self.w_in, dt_)).split(
                [3 * w, hk, hk, h], -1)
        conv, xpad = _short_conv(qkv, cache, _cast(self.conv_w, dt_))
        q, k, v = F.silu(conv).float().unflatten(-1, (3, h, hk)).unbind(2)
        q, k = _l2norm(q) * hk ** -0.5, _l2norm(k)
        g = torch.einsum("bsr,re->bse", fa, _cast(self.f_b, dt_)).float()
        g = (_softplus(g + self.dt_bias.float()).unflatten(-1, (h, hk))
             * -torch.exp(self.a_log.float())[:, None])
        beta = torch.sigmoid(beta.float())
        if cache is not None and s == 1:
            with telemetry.span("models.kda.step"):
                o = _kda_step(cache["state"], q[:, 0], k[:, 0], v[:, 0],
                              g[:, 0], beta[:, 0])[:, None]
        else:
            with telemetry.span("models.kda.prefill"):
                o, state = _kda_chunked(
                    q, k, v, g, beta,
                    None if cache is None else cache["state"])
                if cache is not None:
                    cache["state"].copy_(state)
        gate = torch.einsum("bsr,re->bse", ga, _cast(self.g_b, dt_))
        o = (o * torch.rsqrt(o.square().mean(-1, keepdim=True) + cfg.norm_eps)
             * torch.sigmoid(gate.float().unflatten(-1, (h, hk))))
        o = o.to(dt_) * _cast(self.norm.scale, dt_)
        out = torch.einsum("bse,ed->bsd", o.flatten(2), _cast(self.w_out, dt_))
        if cache is not None:
            cache["conv"].copy_(xpad[:, -3:])
            telemetry.count("models.kda.state_bytes", 2 * sum(
                cache[n].numel() * cache[n].element_size()
                for n in ("conv", "state")))
        return out, None
