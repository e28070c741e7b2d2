"""Weights of a ``nemotron_h`` hybrid (Mamba-2, MoE and attention blocks),
drawn by the benchmark from the seed.

One bfloat16 buffer on the device holds every parameter, as the published
checkpoint stores them; each parameter is a view into it, starting on a
64-element boundary (the grouped expert products read 16-byte aligned
matrices), and the parameters of one initialisation lie side by side, so
the buffer is filled in a few calls: one normal draw over all of it, its
scalings, and the draws and fills of the Mamba-2 parameters.  The same
views go to the program (loaded into its module without a copy) and to
the reference, which upcasts them a block at a time, so the card holds
one copy.

The sizes are the configuration's published keys; the names and shapes
are the port's.  Block i of letter ``M`` is ``ssm_blocks.<i>``: ``ln.scale``
(d,), ``mixer.w_in`` (d, di + ch + H) with di = heads · head dim and ch =
di + 2 · groups · state, ``mixer.conv_w`` (taps, ch), ``mixer.conv_b``
(ch,), ``mixer.a_log``, ``mixer.d_skip``, ``mixer.dt_bias`` (H,),
``mixer.norm.scale`` (di,), ``mixer.w_out`` (di, d).  Of letter ``E``,
``moe_blocks.<i>``: ``ln.scale``, ``mixer.router`` (d, E) over the
router's experts, ``mixer.choice_bias`` (E,) (the published
``e_score_correction_bias``), ``mixer.w_up`` (held, d, f), ``mixer.w_down``
(held, f, d), ``mixer.shared.w_up`` (d, fs), ``mixer.shared.w_down`` (fs,
d).  Of letter ``*``, ``attn_blocks.<i>``: ``ln.scale``, ``mixer.wq`` (d,
H, hd), ``mixer.wk``/``mixer.wv`` (d, KV, hd), ``mixer.wo`` (H, hd, d).
Then ``embed`` (V, d), ``final_norm.scale`` and ``lm_head`` (d, V).

Initialisations (the configuration's ``assumed``): ``std`` normal ×
``init_std``; ``embed_std`` normal × ``embed_std``; ``choice_bias``
normal × ``choice_bias_std``; ``ones`` (norm scales and ``D``); ``conv``
uniform in ±``conv_bound``; ``a_log`` log of uniform in [1, 16];
``dt_bias`` softplus⁻¹ of dt log-uniform in [``time_step_min``,
``time_step_max``], floored at ``time_step_floor``.
"""
from __future__ import annotations

import math

import torch

from simbench.harness import seeds
from simbench.reference.hybrid_moe_lm import LETTERS, expert_share

ALIGN = 64            # elements: each view starts on a 128-byte boundary
INITS = ("std", "choice_bias", "embed_std", "ones", "conv", "a_log",
         "dt_bias")


def layout(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, init) of every parameter, grouped by init in the
    order of ``INITS``."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    nh, p = cfg["mamba_num_heads"], cfg["mamba_head_dim"]
    di = nh * p
    ch = di + 2 * cfg["n_groups"] * cfg["ssm_state_size"]
    e, _, held = expert_share(cfg)
    f, fs = (cfg["moe_intermediate_size"],
             cfg["moe_shared_expert_intermediate_size"])
    hq, hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"])
    mixers = {
        "M": [("w_in", (d, di + ch + nh), "std"),
              ("conv_w", (cfg["conv_kernel"], ch), "conv"),
              ("conv_b", (ch,), "conv"), ("a_log", (nh,), "a_log"),
              ("d_skip", (nh,), "ones"), ("dt_bias", (nh,), "dt_bias"),
              ("norm.scale", (di,), "ones"), ("w_out", (di, d), "std")],
        "E": [("router", (d, e), "std"), ("choice_bias", (e,), "choice_bias"),
              ("w_up", (held, d, f), "std"), ("w_down", (held, f, d), "std"),
              ("shared.w_up", (d, fs), "std"),
              ("shared.w_down", (fs, d), "std")],
        "*": [("wq", (d, hq, hd), "std"), ("wk", (d, hkv, hd), "std"),
              ("wv", (d, hkv, hd), "std"), ("wo", (hq, hd, d), "std")],
    }
    items = []
    seen = dict.fromkeys(LETTERS, 0)
    for letter in cfg["hybrid_override_pattern"]:
        prefix = f"{LETTERS[letter]}.{seen[letter]}."
        seen[letter] += 1
        items.append((prefix + "ln.scale", (d,), "ones"))
        items += [(prefix + "mixer." + n, s, i) for n, s, i in mixers[letter]]
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
    """softplus⁻¹ of dt, log-uniform in [time_step_min, time_step_max] and
    floored at time_step_floor (Mamba-2's initialisation)."""
    lo, hi = math.log(cfg["time_step_min"]), math.log(cfg["time_step_max"])
    dt = torch.empty(n, device=device).uniform_(lo, hi, generator=gen).exp()
    dt = dt.clamp(min=cfg["time_step_floor"])
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
