"""A decoder-only attention MoE language model in plain PyTorch float32.

The forward pass a configuration file of this folder states (OLMoE's
shape): token embedding; per layer a pre-norm block of RMSNorm, multi-head
attention with rotary positions on interleaved pairs (``x[0::2]``,
``x[1::2]``) and a causal softmax, then RMSNorm and a top-k MoE of SwiGLU
experts whose gates are the router's softmax probabilities of the chosen
experts, renormalised to sum to one; a final RMSNorm and an untied LM
head.  The MoE is capacity-bound as the configuration states: tokens route
in groups, an expert takes at most ``int(capacity_factor · group · k / E)``
(at least one) of a group's tokens in group order, and a token's share for
an expert that is full is dropped.  A served request routes its prompt in
groups of ``moe_group`` tokens over the (sequence, position) order and each
later position as one group of its batch's tokens, the way one prefill
call and one-token decode steps see them.

``matmul`` replaces the products of the weight matrices (the projections,
the experts and the LM head), so a lower precision can stand in for the
program (:func:`fp8_matmul`); the router and the attention stay float32.
TF32 is off throughout.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0          # largest finite float8_e4m3fn


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with both operands rounded to float8 e4m3, each under one
    scale of its own (its largest magnitude at the format's largest value),
    and the product accumulated in float32."""
    def q(t):
        s = t.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return q(a) @ q(b)


@contextlib.contextmanager
def _no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, positions, theta: float):
    """Rotary positions on interleaved pairs; ``x`` (B, T, H, hd)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = positions[:, None].float() * inv
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       -1).reshape(x.shape)


def attention(h, w: dict, cfg: dict, matmul):
    b, t, d = h.shape
    hd, nh, nkv = head_dim(cfg), cfg["n_heads"], cfg["n_kv_heads"]
    flat = h.reshape(b * t, d)
    q = matmul(flat, w["wq"].reshape(d, nh * hd)).reshape(b, t, nh, hd)
    k = matmul(flat, w["wk"].reshape(d, nkv * hd)).reshape(b, t, nkv, hd)
    v = matmul(flat, w["wv"].reshape(d, nkv * hd)).reshape(b, t, nkv, hd)
    pos = torch.arange(t, device=h.device)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    g = nh // nkv
    k, v = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    causal = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()
    out = torch.empty(b, t, nh, hd, dtype=q.dtype, device=h.device)
    for i in range(b):                  # a sequence at a time: (H, T, T)
        scores = torch.einsum("qhd,khd->hqk", q[i], k[i]) / math.sqrt(hd)
        probs = torch.softmax(scores.masked_fill(~causal, -math.inf), -1)
        out[i] = torch.einsum("hqk,khd->qhd", probs, v[i])
        del scores, probs
    return matmul(out.reshape(b * t, nh * hd),
                  w["wo"].reshape(nh * hd, d)).reshape(b, t, d)


def _group_size(n: int, cap: int) -> int:
    gs = min(cap, n)
    while n % gs:
        gs //= 2
    return gs


def routing_groups(batch: int, length: int, prompt: int, moe_group: int,
                   device) -> list[torch.Tensor]:
    """Index tensors (groups, size) into the (batch · length) flattened
    tokens, one tensor per kind of group: the prompt's groups over the
    (sequence, position) order, then one group of ``batch`` tokens for each
    later position."""
    idx = torch.arange(batch * length, device=device).reshape(batch, length)
    pre = idx[:, :prompt].reshape(-1)
    out = [pre.reshape(-1, _group_size(pre.numel(), moe_group))]
    if length > prompt:
        later = idx[:, prompt:].t()                        # (positions, B)
        gs = _group_size(batch, moe_group)
        out.append(later.reshape(-1, gs))
    return out


def moe_weights(h, router, groups, cfg: dict):
    """(tokens, E) weight of each expert for each token: the renormalised
    gate where the token routes to the expert within capacity, else 0."""
    e, k = cfg["n_experts"], cfg["experts_per_tok"]
    weights = torch.zeros(h.shape[0], e, dtype=torch.float32, device=h.device)
    for idx in groups:
        gs = idx.shape[1]
        probs = torch.softmax(h[idx] @ router, -1)         # (G, gs, E)
        gate, chosen = torch.topk(probs, k)
        gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
        assign = torch.zeros_like(probs).scatter_(-1, chosen, 1.0)
        combine = torch.zeros_like(probs).scatter_(-1, chosen, gate)
        slot = torch.cumsum(assign, 1) - assign
        cap = max(1, int(cfg["capacity_factor"] * gs * k / e))
        weights[idx.reshape(-1)] = (combine * (slot < cap)).reshape(-1, e)
    return weights


def moe(h, w: dict, groups, cfg: dict, matmul):
    weights = moe_weights(h, w["router"], groups, cfg)
    out = torch.zeros_like(h)
    for e in range(cfg["n_experts"]):
        rows = torch.nonzero(weights[:, e]).reshape(-1)
        if rows.numel() == 0:
            continue
        x = h[rows]
        y = matmul(F.silu(matmul(x, w["w_gate"][e])) * matmul(x, w["w_up"][e]),
                   w["w_down"][e])
        out.index_add_(0, rows, y * weights[rows, e, None])
    return out


def layer_weights(weights: dict, i: int) -> dict:
    p = f"blocks.{i}."
    return {"ln1": weights[p + "ln1.scale"], "ln2": weights[p + "ln2.scale"],
            **{n: weights[p + "attn." + n] for n in ("wq", "wk", "wv", "wo")},
            **{n: weights[p + "ffn." + n]
               for n in ("router", "w_gate", "w_up", "w_down")}}


@torch.no_grad()
def logits(weights: dict, cfg: dict, tokens: torch.Tensor, prompt: int,
           positions, matmul=torch.matmul) -> torch.Tensor:
    """Logits (B, len(positions), vocab) of ``tokens`` (B, T) at
    ``positions``, the first ``prompt`` tokens routed as one prefill.
    ``weights`` maps the parameter names (``embed``, ``blocks.<i>.attn.wq``,
    ``blocks.<i>.ffn.w_gate``, ``final_norm.scale``, ``lm_head``, ...) to
    float32 tensors on one device."""
    with _no_tf32():
        b, t = tokens.shape
        eps = cfg["norm_eps"]
        x = weights["embed"][tokens].float()
        groups = routing_groups(b, t, prompt, cfg["moe_group"], x.device)
        for i in range(cfg["n_layers"]):
            w = layer_weights(weights, i)
            x = x + attention(rmsnorm(x, w["ln1"], eps), w, cfg, matmul)
            h = rmsnorm(x, w["ln2"], eps).reshape(b * t, -1)
            x = x + moe(h, w, groups, cfg, matmul).reshape(b, t, -1)
        x = rmsnorm(x[:, list(positions)], weights["final_norm.scale"], eps)
        d = x.shape[-1]
        return matmul(x.reshape(-1, d), weights["lm_head"]).reshape(
            b, len(positions), -1)
