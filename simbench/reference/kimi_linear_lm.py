"""Kimi Linear (``kimi_linear``) in plain PyTorch float32: Kimi Delta
Attention and latent attention layers over a sigmoid-routed MoE, as the
published model describes them (the Kimi Linear technical report, Moonshot
AI, 2025; Kimi-Linear-48B-A3B's ``config.json`` and its released
``modeling_kimi.py``).

The forward pass a configuration file of this folder states, by its
published keys: token embedding; per layer i (1-based) ``x = x +
mixer(RMSNorm(x))``, then ``x = x + ffn(RMSNorm(x))``; a final RMSNorm
and an untied LM head.  Every RMSNorm has ``rms_norm_eps``.

* **KDA** (layers in ``linear_attn_config.kda_layers``; H =
  ``num_heads``, K = V = ``head_dim``, h the normed x).  ``q, k, v =
  silu(conv(h W_q)), silu(conv(h W_k)), silu(conv(h W_v))``, each conv
  causal and depthwise over H·K channels with ``short_conv_kernel_size``
  taps and no bias; per head ``q̂ = q / ‖q‖ · K^-½`` and ``k̂ = k / ‖k‖``
  (‖x‖ = √(Σx² + 10⁻⁶), fla's ``l2norm``); the log decay of each key
  channel ``g = −exp(A_log[head]) · softplus(f_b(f_a(h)) + dt_bias)``
  (f_a: d → K, f_b: K → H·K, so g ≤ 0); ``β = sigmoid(h W_b)`` a head.
  The state S (K × V a head) takes, at each token t, ``S' = Diag(e^{g_t})
  S``, ``u_t = β_t (v_t − S'ᵀ k̂_t)``, ``S = S' + k̂_t u_tᵀ``, ``o_t = Sᵀ
  q̂_t`` (:func:`kda_recurrence`).  The output is ``W_o ·
  [RMSNorm_V(o_t) ⊙ w ⊙ sigmoid(g_b(g_a(h)))]`` (g_a: d → K, g_b: K → H·K,
  no bias; w of V, shared by the heads).
  Computed chunked (:func:`kda`), a sequence at a time, in chunks of
  ``KDA_CHUNK`` positions entered with state S₀: with Γ_i the inclusive
  cumulative sum of g over the chunk (in float64), the chunk's updates
  solve ``(I + tril₋₁(diag β · A)) U = diag β · (V − (K ⊙ e^Γ) S₀)``,
  ``A_jl = Σ_c k_jc k_lc e^{Γ_jc − Γ_lc}``; its outputs are ``o_i =
  S₀ᵀ(q_i ⊙ e^{Γ_i}) + Σ_{j ≤ i} u_j Σ_c q_ic k_jc e^{Γ_ic − Γ_jc}``; the
  state leaving it ``Diag(e^{Γ_C}) S₀ + Σ_j (k_j ⊙ e^{Γ_C − Γ_j}) u_jᵀ``.
  Only differences Γ_i − Γ_j with j ≤ i enter an exponent, masked to
  −inf above the diagonal first, so none is positive.  The last chunk is
  as long as the positions left.
* **MLA** (``full_attn_layers``, ``mla_use_nope``): DeepSeek-V2's latent
  attention (:func:`~simbench.reference.mla_moe_lm.attention`) with the
  latent norm, no q compression, ``qk_nope_head_dim +
  qk_rope_head_dim`` query and key dims and ``v_head_dim`` values, at
  ``(nope + rope)^-½`` (no rope scaling), and no positions: the rope
  parts enter the scores unrotated (cos 1, sin 0).
* **FFN.**  The first ``first_k_dense_replace`` layers a SwiGLU of
  ``intermediate_size``; the others a MoE: scores ``sigmoid(h ·
  router)``, each token's ``num_experts_per_token`` experts the top of
  ``scores + e_score_correction_bias``, gates the chosen scores over their
  sum times ``routed_scaling_factor``
  (:func:`~simbench.reference.hybrid_moe_lm.route`); SwiGLU experts of
  ``moe_intermediate_size``, every routed pair computed, plus
  ``num_shared_experts`` SwiGLU experts of that width, ungated.  Where
  the file holds a share of the experts (``expert_share``: ``num_experts``
  of them from ``first_expert``, the router over
  ``published_num_experts``), the pairs routed to the others add nothing.

Departures: none in the math.  ``use_grouped_topk`` with one group
(``num_expert_group`` = ``topk_group`` = 1) is the plain top k.  Each
block's weights are upcast from the shared bfloat16 buffer when the block
runs; the weights are the port's, by its names (``kda_blocks.<i>``,
``mla_blocks.<i>``, ``mlp_blocks.<i>``, ``moe_blocks.<i>``, each ``ln``
and ``mixer``), the KDA's ``W_q, W_k, W_v, f_a, g_a, W_b`` side by side
in one ``w_in``.  ``matmul`` replaces the products of the weight matrices
(projections, gates' up-projections, experts, LM head), so a lower
precision can stand in for the program (:func:`fp8_matmul`); the router,
the convs, the delta rule, the norms and the attention stay float32.
TF32 is off throughout.  Expert choices are hard, as in
:mod:`~simbench.reference.hybrid_moe_lm`: :class:`Routing` lets the
reference compute a program's own choices.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from simbench.reference.hybrid_moe_lm import (Routing, block_weights, route,
                                              shortfall)
from simbench.reference.mla_moe_lm import attention as mla_attention
from simbench.reference.mla_moe_lm import swiglu
from simbench.reference.moe_lm import _no_tf32, fp8_matmul, rmsnorm

__all__ = ["fp8_matmul", "logits", "kda", "kda_recurrence", "Routing",
           "expert_share", "layer_blocks"]

KDA_CHUNK = 64              # positions a chunk of the chunked delta rule
HEAD_BLOCK = 4096           # positions a block of LM-head logits
L2_EPS = 1e-6


def expert_share(cfg: dict) -> tuple[int, int, int]:
    """(router width, first expert held, experts held)."""
    share = cfg.get("expert_share")
    held = cfg["num_experts"]
    if not share:
        return held, 0, held
    return share["published_num_experts"], share["first_expert"], held


def layer_blocks(cfg: dict) -> list[tuple[str, str]]:
    """Each layer's (mixer block, FFN block) weight prefixes, in order."""
    kda_layers = set(cfg["linear_attn_config"]["kda_layers"])
    seen = {"kda": 0, "mla": 0, "mlp": 0, "moe": 0}
    out = []
    for i in range(1, cfg["num_hidden_layers"] + 1):
        mixer = "kda" if i in kda_layers else "mla"
        ffn = "mlp" if i <= cfg["first_k_dense_replace"] else "moe"
        out.append(tuple(f"{kind}_blocks.{seen[kind]}." for kind in
                         (mixer, ffn)))
        seen[mixer] += 1
        seen[ffn] += 1
    return out


def _l2norm(x):
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + L2_EPS)


def kda_recurrence(q, k, v, g, beta, state=None):
    """The delta rule token by token: q, k, g (T, H, K), v (T, H, V), beta
    (T, H); ``state`` (H, K, V) or zeros.  Returns (o (T, H, V), the state
    after the last token)."""
    t, nh, dk = k.shape
    s = (torch.zeros(nh, dk, v.shape[-1], dtype=v.dtype, device=v.device)
         if state is None else state.clone())
    out = []
    for i in range(t):
        s = torch.exp(g[i])[..., None] * s
        u = beta[i, :, None] * (v[i] - torch.einsum("hkv,hk->hv", s, k[i]))
        s = s + k[i, :, :, None] * u[:, None, :]
        out.append(torch.einsum("hkv,hk->hv", s, q[i]))
    return torch.stack(out), s


def kda(q, k, v, g, beta, state=None, chunk: int = KDA_CHUNK):
    """The delta rule of one sequence in chunks (the module docstring's
    form), from ``state`` (H, K, V) or zeros; shapes as
    :func:`kda_recurrence`'s.  Returns (o (T, H, V), the last state)."""
    t, nh, dk = k.shape
    dv = v.shape[-1]
    s = (torch.zeros(nh, dk, dv, dtype=v.dtype, device=v.device)
         if state is None else state.clone())
    out = torch.empty(t, nh, dv, dtype=v.dtype, device=v.device)
    for c0 in range(0, t, chunk):
        c1 = min(t, c0 + chunk)
        n = c1 - c0
        qc, kc, vc, bc = q[c0:c1], k[c0:c1], v[c0:c1], beta[c0:c1]
        cum = g[c0:c1].double().cumsum(0)                       # (n, H, K)
        lower = torch.ones(n, n, dtype=torch.bool, device=v.device).tril()
        seg = (cum[:, None] - cum[None, :]).masked_fill(
            ~lower[:, :, None, None], -math.inf)                # [i, j]
        dec = torch.exp(seg.float())
        del seg
        a = torch.einsum("ihc,jhc,ijhc->hij", kc, kc, dec)
        qk = torch.einsum("ihc,jhc,ijhc->hij", qc, kc, dec)
        del dec
        eg = torch.exp(cum.float())                             # e^{Γ_i}
        bt = bc.t()[..., None]                                  # (H, n, 1)
        rhs = bt * (vc.transpose(0, 1)
                    - (kc * eg).transpose(0, 1) @ s)            # (H, n, V)
        system = (torch.eye(n, dtype=v.dtype, device=v.device)
                  + (bt * a).tril(-1))
        u = torch.linalg.solve_triangular(system, rhs, upper=False)
        out[c0:c1] = ((qc * eg).transpose(0, 1) @ s + qk @ u).transpose(0, 1)
        to_end = torch.exp((cum[-1] - cum).float())             # e^{Γ_C − Γ_j}
        s = (torch.exp(cum[-1].float())[..., None] * s
             + (kc * to_end).permute(1, 2, 0) @ u)
    return out, s


def kda_layer(h, w: dict, cfg: dict, matmul):
    """A KDA mixer over ``h`` (B, T, d), a sequence at a time."""
    lc = cfg["linear_attn_config"]
    nh, hk = lc["num_heads"], lc["head_dim"]
    wd = nh * hk
    b, t, d = h.shape
    outs = []
    for i in range(b):
        x = matmul(h[i], w["w_in"])
        qkv, fa, ga, beta = x.split([3 * wd, hk, hk, nh], -1)
        taps = w["conv_w"].shape[0]
        conv = F.conv1d(qkv.t()[None], w["conv_w"].t()[:, None, :],
                        padding=taps - 1, groups=3 * wd)[0, :, :t].t()
        q, k, v = F.silu(conv).reshape(t, 3, nh, hk).unbind(1)
        q, k = _l2norm(q) * hk ** -0.5, _l2norm(k)
        g = -torch.exp(w["a_log"])[:, None] * F.softplus(
            matmul(fa, w["f_b"]) + w["dt_bias"]).reshape(t, nh, hk)
        o = kda(q, k, v, g, torch.sigmoid(beta))[0]
        gate = torch.sigmoid(matmul(ga, w["g_b"])).reshape(t, nh, hk)
        o = (o * torch.rsqrt(o.square().mean(-1, keepdim=True)
                             + cfg["rms_norm_eps"]) * w["norm"] * gate)
        outs.append(matmul(o.reshape(t, wd), w["w_out"]))
    return torch.stack(outs)


def mla_layer(h, w: dict, cfg: dict, matmul):
    """Latent attention without positions: the rope dims unrotated."""
    t = h.shape[1]
    half = cfg["qk_rope_head_dim"] // 2
    cos = torch.ones(t, half, device=h.device)
    return mla_attention(h, w, cfg, cos, torch.zeros_like(cos), matmul)


def moe(h, w: dict, cfg: dict, matmul, chosen=None):
    """The experts held over ``h`` (tokens, d), every routed pair to them
    computed, plus the shared experts; the pairs are the reference's own
    choice, or ``chosen`` (tokens, k) where given."""
    _, first, held = expert_share(cfg)
    chosen, gate = route(h, w["router"], w["choice_bias"], _router(cfg),
                         chosen)
    out = torch.zeros_like(h)
    for e in range(held):
        rows, slot = torch.nonzero(chosen == first + e, as_tuple=True)
        if rows.numel() == 0:
            continue
        y = swiglu(h[rows], w["w_gate"][e], w["w_up"][e], w["w_down"][e],
                   matmul)
        out.index_add_(0, rows, y * gate[rows, slot, None])
    return out + swiglu(h, w["shared.w_gate"], w["shared.w_up"],
                        w["shared.w_down"], matmul)


def _router(cfg: dict) -> dict:
    """The keys :func:`route` and :func:`shortfall` read, by their names
    there."""
    return {"num_experts_per_tok": cfg["num_experts_per_token"],
            "routed_scaling_factor": cfg["routed_scaling_factor"]}


@torch.no_grad()
def logits(weights: dict, cfg: dict, tokens: torch.Tensor, positions,
           matmul=torch.matmul, routing: Routing | None = None
           ) -> torch.Tensor:
    """Logits (B, len(positions), vocab) of ``tokens`` (B, T) at
    ``positions``; ``weights`` maps the port's parameter names to tensors
    on one device.  ``routing``, where given, gives the MoE blocks'
    choices or takes the reference's own (:class:`Routing`)."""
    with _no_tf32():
        b, t = tokens.shape
        eps = cfg["rms_norm_eps"]
        x = weights["embed"][tokens].float()
        e = 0
        for mixer, ffn in layer_blocks(cfg):
            w = block_weights(weights, mixer)
            layer = kda_layer if mixer.startswith("kda") else mla_layer
            x = x + layer(rmsnorm(x, w["ln"], eps), w, cfg, matmul)
            w = block_weights(weights, ffn)
            h = rmsnorm(x, w["ln"], eps).reshape(b * t, -1)
            if ffn.startswith("mlp"):
                y = swiglu(h, w["w_gate"], w["w_up"], w["w_down"], matmul)
            else:
                chosen = None
                if routing is not None and routing.given is not None:
                    chosen = routing.given[e].reshape(b * t, -1)
                    routing.shortfall.append(shortfall(
                        h, w["router"], w["choice_bias"], _router(cfg),
                        chosen))
                elif routing is not None:
                    chosen = route(h, w["router"], w["choice_bias"],
                                   _router(cfg))[0]
                    routing.chosen.append(chosen.reshape(b, t, -1))
                y = moe(h, w, cfg, matmul, chosen)
                e += 1
            x = x + y.reshape(b, t, -1)
            del w, h, y
        x = rmsnorm(x[:, list(positions)], weights["final_norm.scale"].float(),
                    eps)
        x = x.reshape(-1, x.shape[-1])
        head = weights["lm_head"].float()
        out = torch.cat([matmul(x[i:i + HEAD_BLOCK], head)
                         for i in range(0, x.shape[0], HEAD_BLOCK)])
        return out.reshape(b, len(positions), -1)
