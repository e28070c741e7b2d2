"""NVIDIA Nemotron-H (``nemotron_h``) in plain PyTorch float32: Mamba-2,
MoE and attention blocks in one stack, as the published model describes
them (Nemotron-H, arXiv:2504.03624; Nemotron 3 Nano's ``config.json`` and
its released ``modeling_nemotron_h.py``).

The forward pass a configuration file of this folder states, by its
published keys: token embedding; one pre-norm block a letter of
``hybrid_override_pattern``, each ``x + mixer(RMSNorm(x))``; a final
RMSNorm and an untied LM head.  Every RMSNorm has ``layer_norm_epsilon``.

* **``M``, Mamba-2.**  ``[z | xBC | dt] = h · w_in`` (widths
  ``mamba_num_heads · mamba_head_dim``, that plus ``2 · n_groups ·
  ssm_state_size``, ``mamba_num_heads``); ``xBC = silu(causal depthwise
  conv of conv_kernel taps + bias)`` split into x, B and C (``n_groups``
  groups of ``ssm_state_size``); ``dt = softplus(dt + dt_bias)``, ``A =
  −exp(A_log)``; head h reads group ``h // (heads / n_groups)``.  The SSD
  as its masked quadratic form over the whole sequence, ``y_t = Σ_{s ≤ t}
  (C_t · B_s) · exp(Σ_{s < r ≤ t} A dt_r) · dt_s x_s``, a sequence at a
  time with queries in blocks (the decays from a float64 cumulative sum,
  so no long sum loses its low digits); then ``+ D x``; then the gated
  RMSNorm of ``y · silu(z)`` over ``n_groups`` groups of channels, and
  ``w_out``.
* **``E``, MoE.**  Scores ``sigmoid(h · router)``; each token's
  ``num_experts_per_tok`` experts are the top of ``scores +
  e_score_correction_bias`` (the bias chooses, and is in no gate); the
  gates are the chosen scores over their sum, times
  ``routed_scaling_factor``; experts ``down(relu(up x)²)``, every routed
  pair computed, plus one shared expert of
  ``moe_shared_expert_intermediate_size``, ungated.  Where the file holds a
  share of the experts (``expert_share``: ``n_routed_experts`` of them
  from ``first_expert``, the router over ``published_n_routed_experts``),
  the pairs routed to the others add nothing.
* **``*``, attention.**  GQA of ``num_attention_heads`` query and
  ``num_key_value_heads`` key/value heads of ``head_dim``, no positional
  encoding (``nemotron_h`` attention has none), causal softmax at
  ``head_dim^-0.5``; a sequence at a time, queries in blocks.

No departure.  Each block's weights are upcast from the shared bfloat16
buffer when the block runs.  ``matmul`` replaces the products of the
weight matrices (projections, experts, LM head), so a lower precision can
stand in for the program (:func:`fp8_matmul`); the router, the conv, the
SSD, the norms and the attention stay float32.  TF32 is off throughout.

An expert choice is a hard one: where two experts' ``scores + bias`` lie
closer than a lower precision rounds them, the choice can fall either
way, and the token then moves by a whole expert's output (the gates sum
to ``routed_scaling_factor``), so a bf16 program and this reference part
on many tokens after a few blocks.  :class:`Routing` lets the reference
compute a program's own choices, each checked against its own: how far
the least of a token's followed choices falls below its own k-th.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from simbench.reference.moe_lm import _no_tf32, fp8_matmul, rmsnorm

__all__ = ["fp8_matmul", "logits", "route", "expert_share", "Routing"]

QUERY_BLOCK = 1024          # query rows a block of attention scores
SSD_BLOCK = 128             # query rows a block of the SSD's quadratic form
HEAD_BLOCK = 4096           # positions a block of LM-head logits
LETTERS = {"M": "ssm_blocks", "E": "moe_blocks", "*": "attn_blocks"}


def expert_share(cfg: dict) -> tuple[int, int, int]:
    """(router width, first expert held, experts held)."""
    share = cfg.get("expert_share")
    held = cfg["n_routed_experts"]
    if not share:
        return held, 0, held
    return (share["published_n_routed_experts"], share["first_expert"],
            held)


def attention(h, w: dict, cfg: dict, matmul):
    b, t, d = h.shape
    nh, nkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"])
    flat = h.reshape(b * t, d)
    q = matmul(flat, w["wq"].reshape(d, -1)).reshape(b, t, nkv, nh // nkv,
                                                     hd)
    k = matmul(flat, w["wk"].reshape(d, -1)).reshape(b, t, nkv, hd)
    v = matmul(flat, w["wv"].reshape(d, -1)).reshape(b, t, nkv, hd)
    pos = torch.arange(t, device=h.device)
    out = torch.empty_like(q)
    for i in range(b):
        for q0 in range(0, t, QUERY_BLOCK):
            q1 = min(t, q0 + QUERY_BLOCK)
            scores = torch.einsum("qkgd,skd->kgqs", q[i, q0:q1],
                                  k[i, :q1]) * hd ** -0.5
            scores = scores.masked_fill(
                pos[q0:q1, None] < pos[None, :q1], -math.inf)
            out[i, q0:q1] = torch.einsum("kgqs,skd->qkgd",
                                         torch.softmax(scores, -1), v[i, :q1])
            del scores
    return matmul(out.reshape(b * t, nh * hd),
                  w["wo"].reshape(nh * hd, d)).reshape(b, t, d)


def ssd(x, dt, a, bm, cm):
    """One sequence's SSD by its quadratic form: x (T, H, P), dt (T, H), a
    (H,) = A, bm and cm (T, G, N).  Returns y (T, H, P)."""
    t, nh, p = x.shape
    g = bm.shape[1]
    cum = torch.cumsum((a * dt).double(), 0)                  # (T, H)
    xdt = (x * dt[..., None]).reshape(t, g, nh // g, p)
    pos = torch.arange(t, device=x.device)
    y = torch.empty_like(x)
    for q0 in range(0, t, SSD_BLOCK):
        q1 = min(t, q0 + SSD_BLOCK)
        seg = (cum[q0:q1, None] - cum[None, :q1]).float()     # (Q, S, H)
        seg = seg.masked_fill((pos[q0:q1, None] < pos[None, :q1])[..., None],
                              -math.inf)
        decay = torch.exp(seg).reshape(q1 - q0, q1, g, nh // g)
        del seg
        cb = torch.einsum("qgn,sgn->qsg", cm[q0:q1], bm[:q1])
        y[q0:q1] = torch.einsum("qsgh,sghp->qghp", cb[..., None] * decay,
                                xdt[:q1]).reshape(q1 - q0, nh, p)
        del decay, cb
    return y


def mamba2(h, w: dict, cfg: dict, matmul):
    b, t, d = h.shape
    nh, p = cfg["mamba_num_heads"], cfg["mamba_head_dim"]
    g, n = cfg["n_groups"], cfg["ssm_state_size"]
    di = nh * p
    zxbcdt = matmul(h.reshape(b * t, d), w["w_in"]).reshape(b, t, -1)
    z, xbc, dt = zxbcdt.split([di, di + 2 * g * n, nh], -1)
    taps = w["conv_w"].shape[0]
    conv = F.conv1d(xbc.transpose(1, 2), w["conv_w"].t()[:, None, :],
                    w.get("conv_b"), padding=taps - 1,
                    groups=xbc.shape[-1])[..., :t].transpose(1, 2)
    xs, bm, cm = F.silu(conv).split([di, g * n, g * n], -1)
    dt = F.softplus(dt + w["dt_bias"])
    a = -torch.exp(w["a_log"])
    xs = xs.reshape(b, t, nh, p)
    y = torch.stack([ssd(xs[i], dt[i], a, bm[i].reshape(t, g, n),
                         cm[i].reshape(t, g, n)) for i in range(b)])
    y = (y + w["d_skip"][:, None] * xs).reshape(b, t, di) * F.silu(z)
    y = y.reshape(b, t, g, -1)
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True)
                        + cfg["layer_norm_epsilon"])
    y = y.reshape(b * t, di) * w["norm"]
    return matmul(y, w["w_out"]).reshape(b, t, d)


def relu2_mlp(x, w_up, w_down, matmul):
    return matmul(torch.relu(matmul(x, w_up)).square(), w_down)


def route(h, router, bias, cfg: dict, chosen=None):
    """(experts chosen (T, k), their gates (T, k)) of ``h`` (T, d): the top
    ``num_experts_per_tok`` of ``scores + bias``, or ``chosen`` where
    given."""
    scores = torch.sigmoid(h @ router)
    if chosen is None:
        chosen = torch.topk(scores + bias, cfg["num_experts_per_tok"]).indices
    gate = scores.gather(1, chosen)
    gate = gate / gate.sum(-1, keepdim=True)
    return chosen, gate * cfg["routed_scaling_factor"]


def shortfall(h, router, bias, cfg: dict, chosen) -> float:
    """The widest shortfall of ``chosen`` (T, k) below the reference's own
    choice over ``h`` (T, d): over the tokens, the least ``scores + bias``
    of its own top k less the least of them over ``chosen`` (0 where every
    choice is its own; never below 0)."""
    pick = torch.sigmoid(h @ router) + bias
    own = torch.topk(pick, cfg["num_experts_per_tok"]).values[:, -1]
    return float((own - pick.gather(1, chosen).min(1).values).max())


def moe(h, w: dict, cfg: dict, matmul, chosen=None):
    """The experts held over ``h`` (tokens, d), every routed pair to them
    computed, plus the shared expert; the pairs are the reference's own
    choice, or ``chosen`` (tokens, k) where given."""
    _, first, held = expert_share(cfg)
    chosen, gate = route(h, w["router"], w["choice_bias"], cfg, chosen)
    out = torch.zeros_like(h)
    for e in range(held):
        rows, slot = torch.nonzero(chosen == first + e, as_tuple=True)
        if rows.numel() == 0:
            continue
        y = relu2_mlp(h[rows], w["w_up"][e], w["w_down"][e], matmul)
        out.index_add_(0, rows, y * gate[rows, slot, None])
    return out + relu2_mlp(h, w["shared.w_up"], w["shared.w_down"], matmul)


@dataclasses.dataclass
class Routing:
    """The experts the MoE blocks compute.  With ``given`` (one (B, T, k)
    tensor of expert ids an ``E`` block, in the pattern's order: a
    program's choices), each block computes those pairs, gated by its own
    scores, and appends to ``shortfall`` their widest shortfall below its
    own choice (:func:`shortfall`).  Without, each block computes its own
    top k and appends them to ``chosen``."""
    given: list | None = None
    chosen: list = dataclasses.field(default_factory=list)
    shortfall: list = dataclasses.field(default_factory=list)


def block_weights(weights: dict, prefix: str) -> dict:
    """One block's weights, upcast to float32, by short names (``ln``,
    ``w_in``, ``norm``, ``router``, ``shared.w_up``, ...)."""
    out = {}
    for name, t in weights.items():
        if name.startswith(prefix):
            short = name[len(prefix):].removeprefix("mixer.")
            out[short.removesuffix(".scale")] = t.float()
    return out


MIXERS = {"M": mamba2, "*": attention}


@torch.no_grad()
def logits(weights: dict, cfg: dict, tokens: torch.Tensor, positions,
           matmul=torch.matmul, routing: Routing | None = None
           ) -> torch.Tensor:
    """Logits (B, len(positions), vocab) of ``tokens`` (B, T) at
    ``positions``; ``weights`` maps the parameter names (``embed``,
    ``ssm_blocks.<i>.mixer.w_in``, ``moe_blocks.<i>.mixer.router``,
    ``attn_blocks.<i>.mixer.wq``, ``final_norm.scale``, ``lm_head``, ...)
    to tensors on one device.  ``routing``, where given, gives the MoE
    blocks' choices or takes the reference's own (:class:`Routing`)."""
    with _no_tf32():
        b, t = tokens.shape
        eps = cfg["layer_norm_epsilon"]
        x = weights["embed"][tokens].float()
        seen = dict.fromkeys(LETTERS, 0)
        for letter in cfg["hybrid_override_pattern"]:
            i = seen[letter]
            w = block_weights(weights, f"{LETTERS[letter]}.{i}.")
            seen[letter] += 1
            h = rmsnorm(x, w["ln"], eps)
            if letter == "E":
                h = h.reshape(b * t, -1)
                chosen = None
                if routing is not None and routing.given is not None:
                    chosen = routing.given[i].reshape(b * t, -1)
                    routing.shortfall.append(shortfall(
                        h, w["router"], w["choice_bias"], cfg, chosen))
                elif routing is not None:
                    chosen = route(h, w["router"], w["choice_bias"], cfg)[0]
                    routing.chosen.append(chosen.reshape(b, t, -1))
                y = moe(h, w, cfg, matmul, chosen).reshape(b, t, -1)
            else:
                y = MIXERS[letter](h, w, cfg, matmul)
            x = x + y
            del w, h, y
        x = rmsnorm(x[:, list(positions)], weights["final_norm.scale"].float(),
                    eps)
        x = x.reshape(-1, x.shape[-1])
        head = weights["lm_head"].float()
        out = torch.cat([matmul(x[i:i + HEAD_BLOCK], head)
                         for i in range(0, x.shape[0], HEAD_BLOCK)])
        return out.reshape(b, len(positions), -1)
