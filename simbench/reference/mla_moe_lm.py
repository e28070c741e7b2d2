"""DeepSeek-V2 (Lite) in plain PyTorch float32: multi-head latent
attention and a dropless MoE, as the published model describes them
(arXiv:2405.04434, §2; the released ``modeling_deepseek.py``).

The forward pass a configuration file of this folder states, by its
published keys: token embedding; per layer a pre-norm block of RMSNorm,
latent attention, then RMSNorm and an FFN; a final RMSNorm and an untied
LM head.

* **Attention, explicit (not absorbed).**  Queries ``q = h · w_q`` (no q
  compression) split into ``qk_nope_head_dim`` and ``qk_rope_head_dim``
  parts; the joint latent ``h · w_dkv`` splits into ``c`` (``kv_lora_rank``)
  and one shared rope key; ``c`` is RMS-normalised (``kv_norm``), then
  ``k_nope = c · w_uk`` and ``v = c · w_uv`` per head.  The rope parts
  rotate with YaRN's frequencies (``rope_scaling``: the original
  frequencies below the correction range of ``beta_fast``/``beta_slow``
  rotations over ``original_max_position_embeddings``, those divided by
  ``factor`` above it, a linear ramp between; cos/sin scaled by
  ``mscale(factor, mscale) / mscale(factor, mscale_all_dim)``), and the
  causal softmax of ``[q_nope, q_rope] · [k_nope, k_rope]`` runs at
  ``(nope + rope)^-0.5 · mscale(factor, mscale_all_dim)²`` over values of
  ``v_head_dim``.  A sequence at a time, queries in blocks.
* **FFN.**  The first ``first_k_dense_replace`` layers a SwiGLU of
  ``intermediate_size``; the others route each token to its top
  ``num_experts_per_tok`` of ``n_routed_experts`` SwiGLU experts of
  ``moe_intermediate_size`` by the softmax of ``h · router`` (greedy top-k;
  the gates are the probabilities, renormalised only with
  ``norm_topk_prob``, else times ``routed_scaling_factor``), every routed
  pair computed (dropless), plus ``n_shared_experts`` experts as one
  SwiGLU of their summed width on every token.

Rotary pairs are interleaved (``x[0::2]``, ``x[1::2]``), where the
released code first permutes the checkpoint's rope dims into halves: the
same rotation of the same pairs, so every score is the same.  No other
departure.  Each layer's weights are upcast from the shared bfloat16
buffer when the layer runs.  ``matmul`` replaces the products of the
weight matrices (projections, experts, LM head), so a lower precision can
stand in for the program (:func:`fp8_matmul`); the router, the norms and
the attention stay float32.  TF32 is off throughout.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from simbench.reference.moe_lm import _no_tf32, fp8_matmul, rmsnorm

__all__ = ["fp8_matmul", "logits", "yarn_inv_freq", "softmax_scale"]

QUERY_BLOCK = 1024          # query rows a block of attention scores
HEAD_BLOCK = 4096           # positions a block of LM-head logits


def _mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(cfg: dict, device=None) -> torch.Tensor:
    """The rope's inverse frequencies (``qk_rope_head_dim`` / 2,)."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    pw = base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                               device=device) / dim)
    rs = cfg.get("rope_scaling")
    if not rs:
        return 1.0 / pw

    def corr(rot):
        return (dim * math.log(rs["original_max_position_embeddings"]
                               / (rot * 2 * math.pi))) / (2 * math.log(base))
    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    extra = 1.0 - ramp                   # weight of the original frequency
    return 1.0 / (rs["factor"] * pw) * (1 - extra) + 1.0 / pw * extra


def _cos_sin_factor(cfg: dict) -> float:
    rs = cfg.get("rope_scaling")
    if not rs:
        return 1.0
    return (_mscale(rs["factor"], rs["mscale"])
            / _mscale(rs["factor"], rs["mscale_all_dim"]))


def softmax_scale(cfg: dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling")
    if rs:
        scale *= _mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return scale


def rope(x, cos, sin):
    """Rotate interleaved pairs of ``x`` (B, T, H, dim); ``cos``/``sin``
    (T, dim / 2)."""
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       -1).reshape(x.shape)


def attention(h, w: dict, cfg: dict, cos, sin, matmul):
    b, t, d = h.shape
    nh, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    flat = h.reshape(b * t, d)
    q = matmul(flat, w["w_q"].reshape(d, -1)).reshape(b, t, nh, dn + dr)
    ckv = matmul(flat, w["w_dkv"])
    c = rmsnorm(ckv[:, :r], w["kv_norm"], cfg["rms_norm_eps"])
    k_nope = matmul(c, w["w_uk"].reshape(r, -1)).reshape(b, t, nh, dn)
    v = matmul(c, w["w_uv"].reshape(r, -1)).reshape(b, t, nh, dv)
    k_pe = rope(ckv[:, r:].reshape(b, t, 1, dr), cos, sin)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], cos, sin)], -1)
    k = torch.cat([k_nope, k_pe.expand(b, t, nh, dr)], -1)
    del k_nope, k_pe, ckv, c
    scale = softmax_scale(cfg)
    pos = torch.arange(t, device=h.device)
    out = torch.empty(b, t, nh, dv, dtype=q.dtype, device=h.device)
    for i in range(b):
        for q0 in range(0, t, QUERY_BLOCK):
            q1 = min(t, q0 + QUERY_BLOCK)
            scores = torch.einsum("qhd,khd->hqk", q[i, q0:q1], k[i, :q1])
            scores = (scores * scale).masked_fill(
                pos[None, q0:q1, None] < pos[None, None, :q1], -math.inf)
            out[i, q0:q1] = torch.einsum("hqk,khd->qhd",
                                         torch.softmax(scores, -1), v[i, :q1])
            del scores
    return matmul(out.reshape(b * t, nh * dv),
                  w["wo"].reshape(nh * dv, d)).reshape(b, t, d)


def swiglu(x, w_gate, w_up, w_down, matmul):
    return matmul(F.silu(matmul(x, w_gate)) * matmul(x, w_up), w_down)


def moe(h, w: dict, cfg: dict, matmul):
    """Dropless top-k over ``h`` (tokens, d), plus the shared experts."""
    k = cfg["num_experts_per_tok"]
    probs = torch.softmax(h @ w["router"], -1)
    gate, chosen = torch.topk(probs, k)
    if cfg["norm_topk_prob"]:
        gate = gate / gate.sum(-1, keepdim=True)
    else:
        gate = gate * cfg["routed_scaling_factor"]
    out = torch.zeros_like(h)
    for e in range(cfg["n_routed_experts"]):
        rows, slot = torch.nonzero(chosen == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        y = swiglu(h[rows], w["w_gate"][e], w["w_up"][e], w["w_down"][e],
                   matmul)
        out.index_add_(0, rows, y * gate[rows, slot, None])
    return out + swiglu(h, w["shared.w_gate"], w["shared.w_up"],
                        w["shared.w_down"], matmul)


def layer_weights(weights: dict, i: int) -> dict:
    """Layer ``i``'s weights, upcast to float32, by short names
    (``w_q``, ``kv_norm``, ``router``, ``shared.w_up``, ...)."""
    p = f"blocks.{i}."
    out = {}
    for name, t in weights.items():
        if name.startswith(p):
            short = name[len(p):]
            for pre in ("attn.", "ffn."):
                short = short.removeprefix(pre)
            out[short.removesuffix(".scale")] = t.float()
    return out


@torch.no_grad()
def logits(weights: dict, cfg: dict, tokens: torch.Tensor, positions,
           matmul=torch.matmul) -> torch.Tensor:
    """Logits (B, len(positions), vocab) of ``tokens`` (B, T) at
    ``positions``; ``weights`` maps the parameter names (``embed``,
    ``blocks.<i>.attn.w_q``, ``blocks.<i>.ffn.w_gate``,
    ``final_norm.scale``, ``lm_head``, ...) to tensors on one device."""
    if cfg.get("q_lora_rank"):
        raise ValueError("the reference has no q compression")
    with _no_tf32():
        b, t = tokens.shape
        eps = cfg["rms_norm_eps"]
        x = weights["embed"][tokens].float()
        ang = (torch.arange(t, dtype=torch.float32, device=x.device)[:, None]
               * yarn_inv_freq(cfg, x.device))
        f = _cos_sin_factor(cfg)
        cos, sin = ang.cos() * f, ang.sin() * f
        for i in range(cfg["num_hidden_layers"]):
            w = layer_weights(weights, i)
            x = x + attention(rmsnorm(x, w["ln1"], eps), w, cfg, cos, sin,
                              matmul)
            h = rmsnorm(x, w["ln2"], eps).reshape(b * t, -1)
            if i < cfg["first_k_dense_replace"]:
                y = swiglu(h, w["w_gate"], w["w_up"], w["w_down"], matmul)
            else:
                y = moe(h, w, cfg, matmul)
            x = x + y.reshape(b, t, -1)
            del w, h, y
        x = rmsnorm(x[:, list(positions)], weights["final_norm.scale"].float(),
                    eps)
        x = x.reshape(-1, x.shape[-1])
        head = weights["lm_head"].float()
        out = torch.cat([matmul(x[i:i + HEAD_BLOCK], head)
                         for i in range(0, x.shape[0], HEAD_BLOCK)])
        return out.reshape(b, len(positions), -1)
