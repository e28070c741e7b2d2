"""Weights of an attention MoE LM, drawn by the benchmark from the seed.

One float32 buffer on the device holds every parameter; it is filled in
four calls (one normal draw over all of it, two scalings, one fill of the
norm scales), and each parameter is a view into it.  The same views go to
the program (loaded into its module without a copy) and to the reference,
so the card holds one copy.  Names and shapes are the port's parameter
names: ``embed`` (V, d), ``blocks.<i>.attn.{wq,wk,wv}`` (d, heads, hd),
``blocks.<i>.attn.wo`` (heads, hd, d), ``blocks.<i>.ffn.router`` (d, E),
``blocks.<i>.ffn.{w_gate,w_up}`` (E, d, f), ``blocks.<i>.ffn.w_down``
(E, f, d), ``blocks.<i>.{ln1,ln2}.scale``, ``final_norm.scale`` (d,) and
``lm_head`` (d, V).
"""
from __future__ import annotations

import math

import torch

from simbench.harness import seeds


def layout(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, init) of every parameter, grouped by init: ``std``
    (normal × ``init_std``), ``embed_std`` (normal × ``embed_std``),
    ``ones``."""
    d, v = cfg["d_model"], cfg["vocab"]
    hd = cfg.get("head_dim") or d // cfg["n_heads"]
    nh, nkv = cfg["n_heads"], cfg["n_kv_heads"]
    e, f = cfg["n_experts"], cfg["d_expert"]
    std, table, ones = [], [], []
    for i in range(cfg["n_layers"]):
        p = f"blocks.{i}."
        std += [(p + "attn.wq", (d, nh, hd)), (p + "attn.wk", (d, nkv, hd)),
                (p + "attn.wv", (d, nkv, hd)), (p + "attn.wo", (nh, hd, d)),
                (p + "ffn.router", (d, e)), (p + "ffn.w_gate", (e, d, f)),
                (p + "ffn.w_up", (e, d, f)), (p + "ffn.w_down", (e, f, d))]
        ones += [(p + "ln1.scale", (d,)), (p + "ln2.scale", (d,))]
    table += [("embed", (v, d)), ("lm_head", (d, v))]
    ones += [("final_norm.scale", (d,))]
    return ([(n, s, "std") for n, s in std]
            + [(n, s, "embed_std") for n, s in table]
            + [(n, s, "ones") for n, s in ones])


def n_params(cfg: dict) -> int:
    return sum(math.prod(s) for _, s, _ in layout(cfg))


def draw(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """name → float32 view of one buffer drawn on ``device`` from ``seed``."""
    items = layout(cfg)
    flat = torch.empty(n_params(cfg), dtype=torch.float32, device=device)
    flat.normal_(generator=seeds.torch_generator(seed, 10, device))
    spans: dict[str, list[int]] = {}
    out, off = {}, 0
    for name, shape, init in items:
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape)
        lo_hi = spans.setdefault(init, [off, off])
        lo_hi[1] = off + n
        off += n
    flat[slice(*spans["std"])].mul_(cfg["init_std"])
    flat[slice(*spans["embed_std"])].mul_(cfg["embed_std"])
    flat[slice(*spans["ones"])].fill_(1.0)
    return out
