"""Weights of a DeepSeek-V2 language model (MLA and a dropless MoE),
drawn by the benchmark from the seed.

One bfloat16 buffer on the device holds every parameter, as the published
checkpoint stores them; it is filled in four calls (one normal draw over
all of it, two scalings, one fill of the norm scales), and each parameter
is a view into it, starting on a 64-element boundary (the grouped expert
products read 16-byte aligned matrices).  The same views go to the program
(loaded into its module without a copy) and to the reference, which
upcasts them a layer at a time, so the card holds one copy.

The sizes are the configuration's published keys (``hidden_size``,
``kv_lora_rank``, ``n_routed_experts``, ...); the names and shapes are
the port's parameter names: ``embed`` (V, d); per layer
``blocks.<i>.{ln1,ln2}.scale`` (d,), ``blocks.<i>.attn.w_q`` (d, H,
nope + rope), ``attn.w_dkv`` (d, r + rope), ``attn.kv_norm.scale`` (r,),
``attn.w_uk`` (r, H, nope), ``attn.w_uv`` (r, H, v), ``attn.wo`` (H, v,
d); the first ``first_k_dense_replace`` layers ``ffn.{w_gate,w_up}`` (d,
``intermediate_size``) and ``ffn.w_down``; the others ``ffn.router`` (d,
E), ``ffn.{w_gate,w_up}`` (E, d, f), ``ffn.w_down`` (E, f, d) and
``ffn.shared.{w_gate,w_up,w_down}`` of width ``n_shared_experts`` · f;
``final_norm.scale`` and ``lm_head`` (d, V).
"""
from __future__ import annotations

import math

import torch

from simbench.harness import seeds

ALIGN = 64            # elements: each view starts on a 128-byte boundary


def layout(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, init) of every parameter, grouped by init: ``std``
    (normal × ``init_std``), ``embed_std`` (normal × ``embed_std``),
    ``ones``."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    nh, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    e, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    fs = cfg["n_shared_experts"] * f
    std, ones = [], []
    for i in range(cfg["num_hidden_layers"]):
        p = f"blocks.{i}."
        std += [(p + "attn.w_q", (d, nh, dn + dr)),
                (p + "attn.w_dkv", (d, r + dr)),
                (p + "attn.w_uk", (r, nh, dn)), (p + "attn.w_uv", (r, nh, dv)),
                (p + "attn.wo", (nh, dv, d))]
        if i < cfg["first_k_dense_replace"]:
            fd = cfg["intermediate_size"]
            std += [(p + "ffn.w_gate", (d, fd)), (p + "ffn.w_up", (d, fd)),
                    (p + "ffn.w_down", (fd, d))]
        else:
            std += [(p + "ffn.router", (d, e)), (p + "ffn.w_gate", (e, d, f)),
                    (p + "ffn.w_up", (e, d, f)), (p + "ffn.w_down", (e, f, d)),
                    (p + "ffn.shared.w_gate", (d, fs)),
                    (p + "ffn.shared.w_up", (d, fs)),
                    (p + "ffn.shared.w_down", (fs, d))]
        ones += [(p + "ln1.scale", (d,)), (p + "attn.kv_norm.scale", (r,)),
                 (p + "ln2.scale", (d,))]
    ones += [("final_norm.scale", (d,))]
    return ([(n, s, "std") for n, s in std]
            + [(n, s, "embed_std") for n, s in
               [("embed", (v, d)), ("lm_head", (d, v))]]
            + [(n, s, "ones") for n, s in ones])


def n_params(cfg: dict) -> int:
    return sum(math.prod(s) for _, s, _ in layout(cfg))


def _offsets(items) -> tuple[list[int], int]:
    offs, off = [], 0
    for _, shape, _ in items:
        offs.append(off)
        off += -(-math.prod(shape) // ALIGN) * ALIGN
    return offs, off


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
        lo_hi = spans.setdefault(init, [off, off])
        lo_hi[1] = off + n
    flat[slice(*spans["std"])].mul_(cfg["init_std"])
    flat[slice(*spans["embed_std"])].mul_(cfg["embed_std"])
    flat[slice(*spans["ones"])].fill_(1.0)
    return out
