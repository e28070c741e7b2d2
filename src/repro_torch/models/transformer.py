"""Model composition for the dense and vlm families: a decoder LM of
attention blocks with per-layer KV caches.

Entry points (the reference's, :mod:`repro.models.transformer`)
----------------------------------------------------------------
``model_defs(cfg)``                       ParamDef tree (stacked ``blocks``)
``Transformer(cfg, device)``              the module; ``load_params(tree)``
                                          fills it from such a tree
``Transformer(...)(batch, caches=None)``  → (logits, aux, new_caches)
``init_cache_shapes(cfg, batch, seq)``    decode-cache (shape, dtype) tree
``init_caches(cfg, batch, seq, ...)``     the zeroed decode caches

MoE, MLA, SSM, hybrid and enc-dec (audio) models are not ported yet
(ROADMAP A.2b): ``model_defs`` and ``Transformer`` raise
``NotImplementedError`` for them.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from .layers import (MLP, Attention, ParamDef, PumMLP, RMSNorm, _dt,
                     _param, attention_defs, mlp_defs, rmsnorm_defs)
from .params import stack_defs, tree_leaves

P = ParamDef


def _check_ported(cfg: ModelConfig) -> None:
    missing = [what for what, on in (
        (f"the {cfg.family!r} family", cfg.family not in ("dense", "vlm")),
        ("MoE", cfg.moe), ("MLA", cfg.mla), ("enc-dec", cfg.enc_dec)) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} is not ported yet (ROADMAP "
            "A.2b); repro_torch.models runs the dense and vlm families")


# ---------------------------------------------------------------------------
# Block definitions
# ---------------------------------------------------------------------------

def attn_block_defs(cfg: ModelConfig):
    _check_ported(cfg)
    return {"ln1": rmsnorm_defs(cfg.d_model), "attn": attention_defs(cfg),
            "ln2": rmsnorm_defs(cfg.d_model), "ffn": mlp_defs(cfg)}


class AttnBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.attn = Attention(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.ffn = (PumMLP if cfg.pum_mlp else MLP)(cfg, device)

    def forward(self, x, positions, cache=None, mrope_positions=None):
        """Returns ``(x, new_cache)`` (a dense block has no auxiliary
        loss)."""
        y, new_cache = self.attn(self.ln1(x), positions, cache,
                                 mrope_positions)
        x = x + y
        return x + self.ffn(self.ln2(x)), new_cache


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------

def n_attn_layers(cfg: ModelConfig) -> int:
    return sum(k == "attn" for k in cfg.pattern())


def model_defs(cfg: ModelConfig):
    _check_ported(cfg)
    d, v = cfg.d_model, cfg.vocab
    defs: dict = {"embed": P((v, d), ("vocab", "embed"), scale=0.01),
                  "blocks": stack_defs(attn_block_defs(cfg),
                                       n_attn_layers(cfg)),
                  "final_norm": rmsnorm_defs(d)}
    if not cfg.tie_embeddings:
        defs["lm_head"] = P((d, v), ("embed", "vocab"), scale=0.01)
    return defs


class Transformer(nn.Module):
    """The decoder LM.  Parameter names follow the reference's tree with
    the stacked ``blocks`` unstacked into ``blocks.<i>`` (``embed``,
    ``blocks.0.attn.wq``, ``final_norm.scale``, ``lm_head`` unless the
    embeddings are tied).  Built uninitialised on ``device`` (``"cuda"``
    unless the caller asks for the CPU); fill it with :meth:`load_params`.

    ``cfg.scan_layers`` and ``cfg.remat`` do not change the computation:
    the layer loop is Python either way, and there is nothing to
    rematerialise without a backward pass.
    """

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        _check_ported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        defs = model_defs(cfg)
        self.embed = _param(defs["embed"], dev)
        self.blocks = nn.ModuleList(AttnBlock(cfg, dev)
                                    for _ in range(n_attn_layers(cfg)))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, dev)
        if not cfg.tie_embeddings:
            self.lm_head = _param(defs["lm_head"], dev)

    def load_params(self, tree) -> "Transformer":
        """Copy a parameter tree shaped like ``model_defs(cfg)`` (tensors on
        any device) into the module, unstacking ``blocks`` along its
        leading layer axis.  Every parameter must be given, and nothing
        else (so a tied model takes no ``lm_head``)."""
        state = {}
        for path, t in tree_leaves(tree):
            if path.startswith("blocks."):
                for i in range(len(self.blocks)):
                    state[f"blocks.{i}.{path[len('blocks.'):]}"] = t[i]
            else:
                state[path] = t
        self.load_state_dict(state, strict=True)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, batch: dict, caches=None):
        """batch: tokens (B,S) [+ positions, mrope_positions (B,S,3)].

        Returns (logits, aux_loss, new_caches).  ``caches=None`` → full
        causal attention; otherwise the tokens are decoded against the
        caches (one token, or a cache-populating prefill), whose key and
        value tensors are written in place, without autograd.
        """
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and caches is None):
            return self._forward(batch, caches)

    def _forward(self, batch, caches):
        cfg = self.cfg
        dt = _dt(cfg)
        tokens = batch["tokens"]
        # the gather commutes with the reference's cast of the whole table
        x = self.embed[tokens].to(dt)
        start = int(caches["pos"]) if caches is not None else 0
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(start, start + tokens.shape[1],
                                     device=tokens.device)[None, :]
        mrope = batch.get("mrope_positions")
        layers = caches["layers"] if caches is not None else None
        layer_pos = []
        for i, block in enumerate(self.blocks):
            lcache = None
            if layers is not None:
                lcache = {k: t[i] for k, t in layers.items() if k != "pos"}
                lcache["pos"] = int(layers["pos"][i])
            x, nc = block(x, positions, lcache, mrope)
            if nc is not None:
                layer_pos.append(nc["pos"])
        x = self.final_norm(x)
        new_caches = None
        if caches is not None:
            new_caches = {"pos": caches["pos"] + tokens.shape[1],
                          "layers": dict(layers, pos=torch.tensor(
                              layer_pos, dtype=torch.int32))}
        head = self.embed.t() if cfg.tie_embeddings else self.lm_head
        logits = torch.einsum("bsd,dv->bsv", x, head.to(dt)).float()
        # the dense and vlm families have no auxiliary (MoE) loss
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return logits, aux, new_caches


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

def init_cache_shapes(cfg: ModelConfig, batch: int, max_seq: int,
                      dtype: torch.dtype = torch.bfloat16):
    """(shape, dtype) pairs of the decode caches: ``pos`` (a scalar) and
    per layer ``k``/``v`` (and ``k_scale``/``v_scale`` for the int8
    cache) stacked over layers, with the layers' ``pos`` (n,)."""
    _check_ported(cfg)
    n = n_attn_layers(cfg)
    int8 = cfg.kv_cache_dtype == "int8"
    kv = ((n, batch, max_seq, cfg.n_kv_heads, cfg.hd),
          torch.int8 if int8 else dtype)
    layers = {"k": kv, "v": kv, "pos": ((n,), torch.int32)}
    if int8:
        sc = ((n, batch, max_seq, cfg.n_kv_heads), torch.float32)
        layers["k_scale"] = sc
        layers["v_scale"] = sc
    return {"pos": ((), torch.int32), "layers": layers}


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """Zeroed decode caches: keys, values and scales on ``device``; the
    ``pos`` counters on the CPU (host bookkeeping: slicing the cache at
    ``pos`` then needs no device synchronisation)."""
    dev = resolve_device(device)
    shapes = init_cache_shapes(cfg, batch, max_seq, dtype)

    def zeros(name, spec):
        shape, dt = spec
        return torch.zeros(shape, dtype=dt,
                           device="cpu" if name == "pos" else dev)

    return {"pos": zeros("pos", shapes["pos"]),
            "layers": {k: zeros(k, s) for k, s in shapes["layers"].items()}}
