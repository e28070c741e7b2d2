"""Weights of a ``kimi_linear`` model (KDA and MLA layers over a dense
layer and sigmoid-routed SwiGLU experts), drawn by the benchmark from the
seed.

One bfloat16 buffer on the device holds every parameter, as the published
checkpoint stores them; each parameter is a view into it, starting on a
64-element boundary (the grouped expert products read 16-byte aligned
matrices), and the parameters of one initialisation lie side by side, so
the buffer is filled in a few calls: one normal draw over all of it, its
scalings, and the draws and fills of the KDA's decay parameters.  The same
views go to the program (loaded into its module without a copy) and to
the reference, which upcasts them a block at a time, so the card holds
one copy.

The sizes are the configuration's published keys; the names and shapes
are the port's, two blocks a layer (``reference.kimi_linear_lm.
layer_blocks``), each ``ln.scale`` (d,) and its ``mixer``.  A KDA block
``kda_blocks.<i>``: ``mixer.w_in`` (d, 3·H·K + 2·K + H) (q, k, v, f_a,
g_a, β side by side), ``mixer.conv_w`` (taps, 3·H·K), ``mixer.f_b`` and
``mixer.g_b`` (K, H·K), ``mixer.a_log`` (H,), ``mixer.dt_bias`` (H·K,),
``mixer.norm.scale`` (K,), ``mixer.w_out`` (H·K, d).  An MLA block
``mla_blocks.<i>``: ``mixer.w_q`` (d, H, nope + rope), ``mixer.w_dkv`` (d,
r + rope), ``mixer.kv_norm.scale`` (r,), ``mixer.w_uk``/``mixer.w_uv`` (r,
H, nope / v), ``mixer.wo`` (H, v, d).  The dense block ``mlp_blocks.0``:
``mixer.w_gate``/``w_up`` (d, ``intermediate_size``), ``mixer.w_down``.
A MoE block ``moe_blocks.<i>``: ``mixer.router`` (d, E) over the router's
experts, ``mixer.choice_bias`` (E,) (the published
``e_score_correction_bias``), ``mixer.w_gate``/``w_up`` (held, d, f),
``mixer.w_down`` (held, f, d), ``mixer.shared.w_gate``/``w_up`` (d, fs),
``mixer.shared.w_down`` (fs, d).  Then ``embed`` (V, d),
``final_norm.scale`` and ``lm_head`` (d, V).

Initialisations (the configuration's ``assumed``): ``std`` normal ×
``init_std``; ``embed_std`` normal × ``embed_std``; ``choice_bias``
normal × ``choice_bias_std``; ``ones`` (norm scales); ``conv`` uniform in
±``conv_bound``; ``a_log`` log of uniform in [1, 16]; ``dt_bias``
softplus⁻¹ of dt log-uniform in [``dt_min``, ``dt_max``], floored at
``dt_floor``.
"""
from __future__ import annotations

import math

import torch

from simbench.harness import seeds
from simbench.reference.kimi_linear_lm import expert_share, layer_blocks

ALIGN = 64            # elements: each view starts on a 128-byte boundary
INITS = ("std", "choice_bias", "embed_std", "ones", "conv", "a_log",
         "dt_bias")


def layout(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, init) of every parameter, grouped by init in the
    order of ``INITS``."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    lc = cfg["linear_attn_config"]
    h, k = lc["num_heads"], lc["head_dim"]
    w = h * k
    nh, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    e, _, held = expert_share(cfg)
    f, fd = cfg["moe_intermediate_size"], cfg["intermediate_size"]
    fs = cfg["num_shared_experts"] * f
    mixers = {
        "kda": [("w_in", (d, 3 * w + 2 * k + h), "std"),
                ("conv_w", (lc["short_conv_kernel_size"], 3 * w), "conv"),
                ("f_b", (k, w), "std"), ("g_b", (k, w), "std"),
                ("a_log", (h,), "a_log"), ("dt_bias", (w,), "dt_bias"),
                ("norm.scale", (k,), "ones"), ("w_out", (w, d), "std")],
        "mla": [("w_q", (d, nh, dn + dr), "std"),
                ("w_dkv", (d, r + dr), "std"),
                ("kv_norm.scale", (r,), "ones"),
                ("w_uk", (r, nh, dn), "std"), ("w_uv", (r, nh, dv), "std"),
                ("wo", (nh, dv, d), "std")],
        "mlp": [("w_gate", (d, fd), "std"), ("w_up", (d, fd), "std"),
                ("w_down", (fd, d), "std")],
        "moe": [("router", (d, e), "std"),
                ("choice_bias", (e,), "choice_bias"),
                ("w_gate", (held, d, f), "std"), ("w_up", (held, d, f), "std"),
                ("w_down", (held, f, d), "std"),
                ("shared.w_gate", (d, fs), "std"),
                ("shared.w_up", (d, fs), "std"),
                ("shared.w_down", (fs, d), "std")],
    }
    items = []
    for blocks in layer_blocks(cfg):
        for prefix in blocks:
            items.append((prefix + "ln.scale", (d,), "ones"))
            items += [(prefix + "mixer." + n, s, i)
                      for n, s, i in mixers[prefix.partition("_")[0]]]
    items += [("embed", (v, d), "embed_std"), ("lm_head", (d, v), "embed_std"),
              ("final_norm.scale", (d,), "ones")]
    return sorted(items, key=lambda item: INITS.index(item[2]))


def n_params(cfg: dict) -> int:
    return sum(math.prod(s) for _, s, _ in layout(cfg))


def _offsets(items) -> tuple[list[int], int]:
    offs, off = [], 0
    for _, shape, _ in items:
        offs.append(off)
        off += -(-math.prod(shape) // ALIGN) * ALIGN
    return offs, off


def _dt_bias(cfg: dict, n: int, gen, device) -> torch.Tensor:
    """softplus⁻¹ of dt, log-uniform in [dt_min, dt_max] and floored at
    dt_floor (Mamba's initialisation, which fla's KDA layer keeps)."""
    lo, hi = math.log(cfg["dt_min"]), math.log(cfg["dt_max"])
    dt = torch.empty(n, device=device).uniform_(lo, hi, generator=gen).exp()
    dt = dt.clamp(min=cfg["dt_floor"])
    return dt + torch.log(-torch.expm1(-dt))


def draw(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """name → bfloat16 view of one buffer drawn on ``device`` from
    ``seed``."""
    items = layout(cfg)
    offs, total = _offsets(items)
    flat = torch.empty(total, dtype=torch.bfloat16, device=device)
    flat.normal_(generator=seeds.torch_generator(seed, 10, device))
    spans: dict[str, list[int]] = {}
    out = {}
    for (name, shape, init), off in zip(items, offs):
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape)
        spans.setdefault(init, [off, off])[1] = off + n
    span = {init: flat[slice(*lo_hi)] for init, lo_hi in spans.items()}
    gen = seeds.torch_generator(seed, 11, device)
    span["std"].mul_(cfg["init_std"])
    span["embed_std"].mul_(cfg["embed_std"])
    span["choice_bias"].mul_(cfg["choice_bias_std"])
    span["ones"].fill_(1.0)
    span["conv"].uniform_(-cfg["conv_bound"], cfg["conv_bound"], generator=gen)
    span["a_log"].uniform_(1.0, 16.0, generator=gen).log_()
    span["dt_bias"].copy_(_dt_bias(cfg, span["dt_bias"].numel(), gen, device))
    return out
