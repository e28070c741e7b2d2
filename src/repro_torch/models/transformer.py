"""Model composition: decoder LMs (dense, vlm), MoE LMs (with MLA for
DeepSeek-V2), enc-dec (whisper), hybrid (zamba2) and pure-SSM (mamba2)
stacks, with per-family decode caches.

Entry points (the reference's, :mod:`repro.models.transformer`)
----------------------------------------------------------------
``model_defs(cfg)``                       ParamDef tree (stacked ``blocks``,
                                          ``ssm_blocks``, ``enc_blocks``)
``Transformer(cfg, device)``              the module; ``load_params(tree)``
                                          fills it from such a tree,
                                          ``draw_params(generator)`` draws
                                          it in place
``Transformer(...)(batch, caches=None)``  → (logits, aux, new_caches);
                                          ``return_hidden=True`` gives the
                                          final-norm hidden states instead
                                          of logits (the chunked loss)
``prime_encdec_caches(model, cfg, ...)``  run the encoder once into the
                                          caches (enc-dec serving)
``init_cache_shapes(cfg, batch, seq)``    decode-cache (shape, dtype) tree
``init_caches(cfg, batch, seq, ...)``     the zeroed decode caches

Under autograd without caches, ``cfg.remat != "none"`` ("full" and
"dots" alike) recomputes each block in the backward pass, where the
reference applies ``jax.checkpoint``: an attention block, an SSM block,
and the hybrid's SSM layer together with the shared block after it.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import checkpoint

from .. import telemetry
from ..configs.base import ModelConfig
from ..device import resolve_device
from .layers import (MLP, Attention, MLAttention, MoE, ParamDef, PumMLP,
                     RMSNorm, SSMMixer, _cast, _dt, _param, _sdpa, apply_rope,
                     attention_defs, mla_defs, mlp_defs, moe_defs,
                     rmsnorm_defs, ssm_cache_shape, ssm_defs)
from .params import stack_defs, tree_leaves

P = ParamDef

ATTN_FAMILIES = ("dense", "moe", "audio", "vlm")
# parameter subtrees stacked over layers in the reference's tree
STACKED = ("blocks", "ssm_blocks", "enc_blocks")
SHARED_EVERY = 6       # hybrid: the shared attention block after every 6th


# ---------------------------------------------------------------------------
# Block definitions
# ---------------------------------------------------------------------------

def attn_block_defs(cfg: ModelConfig, cross: bool = False):
    defs = {
        "ln1": rmsnorm_defs(cfg.d_model),
        "attn": mla_defs(cfg) if cfg.mla else attention_defs(cfg),
        "ln2": rmsnorm_defs(cfg.d_model),
        "ffn": moe_defs(cfg) if cfg.moe else mlp_defs(cfg),
    }
    if cross:
        defs["ln_x"] = rmsnorm_defs(cfg.d_model)
        defs["xattn"] = attention_defs(cfg)
    return defs


def ssm_block_defs(cfg: ModelConfig):
    return {"ln": rmsnorm_defs(cfg.d_model), "mixer": ssm_defs(cfg)}


def _cross_attention(xattn: Attention, x, encoder_out, kv=None):
    """Non-causal attention over encoder frames (whisper decoder), with
    ``xattn``'s projections, no bias and no RoPE.  ``kv``: precomputed
    (k, v) from the cross-KV cache."""
    dt = _dt(xattn.cfg)
    q = torch.einsum("bsd,dhk->bshk", x, _cast(xattn.wq, dt))
    if kv is not None:
        k, v = kv[0].to(dt), kv[1].to(dt)
    else:
        k = torch.einsum("btd,dhk->bthk", encoder_out, _cast(xattn.wk, dt))
        v = torch.einsum("btd,dhk->bthk", encoder_out, _cast(xattn.wv, dt))
    y = _sdpa(q, k, v, causal=False)
    return torch.einsum("bshk,hkd->bsd", y, _cast(xattn.wo, dt))


def _noncausal_self_attn(attn: Attention, x, positions):
    """The encoder's self-attention: RoPE, no bias, no mask."""
    cfg = attn.cfg
    dt = _dt(cfg)
    q = torch.einsum("bsd,dhk->bshk", x, _cast(attn.wq, dt))
    k = torch.einsum("bsd,dhk->bshk", x, _cast(attn.wk, dt))
    v = torch.einsum("bsd,dhk->bshk", x, _cast(attn.wv, dt))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    y = _sdpa(q, k, v, causal=False)
    return torch.einsum("bshk,hkd->bsd", y, _cast(attn.wo, dt))


class AttnBlock(nn.Module):
    """Pre-norm attention block: GQA or MLA attention, then (enc-dec) the
    cross-attention ``ln_x``/``xattn``, then the dense, PuM or MoE FFN."""

    def __init__(self, cfg: ModelConfig, device="cuda", cross: bool = False):
        super().__init__()
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.attn = (MLAttention if cfg.mla else Attention)(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        if cfg.moe:
            self.ffn = MoE(cfg, device)
        else:
            self.ffn = (PumMLP if cfg.pum_mlp else MLP)(cfg, device)
        if cross:
            self.ln_x = RMSNorm(cfg.d_model, cfg.norm_eps, device)
            self.xattn = Attention(cfg, device)

    def forward(self, x, positions, cache=None, mrope_positions=None,
                encoder_out=None):
        """Returns ``(x, aux, new_cache)``.  A cache may carry ``xk``/``xv``
        (the precomputed cross-attention keys and values), which pass
        through to the new cache."""
        cfg = self.cfg
        cross_kv = None
        if cache is not None and "xk" in cache:
            cross_kv = (cache["xk"], cache["xv"])
            cache = {k: v for k, v in cache.items() if k not in ("xk", "xv")}
        h = self.ln1(x)
        with telemetry.span("models.attn"):
            if cfg.mla:
                y, new_cache = self.attn(h, positions, cache)
            else:
                y, new_cache = self.attn(h, positions, cache,
                                         mrope_positions)
        x = x + y
        if encoder_out is not None or cross_kv is not None:
            x = x + _cross_attention(self.xattn, self.ln_x(x), encoder_out,
                                     kv=cross_kv)
        if cross_kv is not None and new_cache is not None:
            new_cache = dict(new_cache, xk=cross_kv[0], xv=cross_kv[1])
        h = self.ln2(x)
        with telemetry.span("models.ffn"):
            if cfg.moe:
                y, aux = self.ffn(h)
            else:
                y = self.ffn(h)
                aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + y, aux, new_cache


class SSMBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.mixer = SSMMixer(cfg, device)

    def forward(self, x, cache=None):
        y, new_cache = self.mixer(self.ln(x), cache)
        return x + y, new_cache


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------

def n_attn_layers(cfg: ModelConfig) -> int:
    return sum(k == "attn" for k in cfg.pattern())


def n_ssm_layers(cfg: ModelConfig) -> int:
    return sum(k == "ssm" for k in cfg.pattern())


def _shared_after(cfg: ModelConfig) -> list[bool]:
    """Hybrid: whether SSM layer i is followed by the shared block."""
    return [(i + 1) % SHARED_EVERY == 0 for i in range(n_ssm_layers(cfg))]


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    # the encoder's blocks are dense (and never binarized: ``_encode``
    # calls the plain MLP); pum_mlp changes no parameter definition
    return dataclasses.replace(cfg, moe=False, mla=False, pum_mlp=False)


def model_defs(cfg: ModelConfig):
    d, v = cfg.d_model, cfg.vocab
    defs: dict = {"embed": P((v, d), ("vocab", "embed"), scale=0.01)}
    if cfg.family == "hybrid":
        defs["ssm_blocks"] = stack_defs(ssm_block_defs(cfg), n_ssm_layers(cfg))
        defs["shared_attn"] = attn_block_defs(cfg)          # weight-tied
    elif cfg.family == "ssm":
        defs["ssm_blocks"] = stack_defs(ssm_block_defs(cfg), n_ssm_layers(cfg))
    else:
        defs["blocks"] = stack_defs(
            attn_block_defs(cfg, cross=cfg.enc_dec), n_attn_layers(cfg))
    if cfg.enc_dec:
        defs["enc_blocks"] = stack_defs(attn_block_defs(_encoder_cfg(cfg)),
                                        cfg.n_encoder_layers)
        defs["enc_norm"] = rmsnorm_defs(d)
    defs["final_norm"] = rmsnorm_defs(d)
    if not cfg.tie_embeddings:
        defs["lm_head"] = P((d, v), ("embed", "vocab"), scale=0.01)
    return defs


def _layer_names(path: str, n_layers: int) -> list[str]:
    head, _, rest = path.partition(".")
    if head in STACKED:
        return [f"{head}.{i}.{rest}" for i in range(n_layers)]
    return [path]


def leaf_names(cfg: ModelConfig) -> list[list[str]]:
    """The :class:`Transformer`'s parameter names of each ``model_defs(cfg)``
    leaf, in the reference's leaf order: one per layer (the leaf's leading
    axis) for a stacked subtree."""
    return [_layer_names(path, d.shape[0])
            for path, d in tree_leaves(model_defs(cfg))]


class Transformer(nn.Module):
    """The LM of any family.  Parameter names follow the reference's tree
    with the stacked subtrees unstacked into ``<name>.<i>`` (``embed``,
    ``blocks.0.attn.wq``, ``blocks.0.ffn.shared.w_up``,
    ``ssm_blocks.3.mixer.a_log``, ``enc_blocks.1.ffn.w_down``,
    ``final_norm.scale``, ``lm_head`` unless the embeddings are tied); the
    hybrid's weight-tied ``shared_attn`` is one block, called after every
    sixth SSM layer.  Built uninitialised on ``device`` (``"cuda"`` unless
    the caller asks for the CPU); fill it with :meth:`load_params` or
    :meth:`draw_params`.

    ``cfg.scan_layers`` does not change the computation: the layer loop
    is Python either way.  ``cfg.remat`` recomputes blocks in the backward
    pass (module docstring) and changes no value.
    """

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        defs = model_defs(cfg)
        self.embed = _param(defs["embed"], dev)
        if cfg.family in ("ssm", "hybrid"):
            self.ssm_blocks = nn.ModuleList(SSMBlock(cfg, dev)
                                            for _ in range(n_ssm_layers(cfg)))
            if cfg.family == "hybrid":
                self.shared_attn = AttnBlock(cfg, dev)
        else:
            self.blocks = nn.ModuleList(
                AttnBlock(cfg, dev, cross=cfg.enc_dec)
                for _ in range(n_attn_layers(cfg)))
        if cfg.enc_dec:
            enc_cfg = _encoder_cfg(cfg)
            self.enc_blocks = nn.ModuleList(
                AttnBlock(enc_cfg, dev) for _ in range(cfg.n_encoder_layers))
            self.enc_norm = RMSNorm(cfg.d_model, cfg.norm_eps, dev)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, dev)
        if not cfg.tie_embeddings:
            self.lm_head = _param(defs["lm_head"], dev)

    def _names(self, path: str) -> list[str]:
        """The module's parameter names of a ``model_defs`` leaf: one per
        layer for a stacked subtree, in layer order."""
        head = path.partition(".")[0]
        return _layer_names(path, len(getattr(self, head))
                            if head in STACKED else 1)

    def load_params(self, tree) -> "Transformer":
        """Copy a parameter tree shaped like ``model_defs(cfg)`` (tensors on
        any device) into the module, unstacking ``blocks``, ``ssm_blocks``
        and ``enc_blocks`` along their leading layer axis.  Every parameter
        must be given, and nothing else (so a tied model takes no
        ``lm_head``)."""
        state = {}
        for path, t in tree_leaves(tree):
            names = self._names(path)
            if len(names) == 1 and names[0] == path:
                state[path] = t
            else:
                state.update((name, t[i]) for i, name in enumerate(names))
        self.load_state_dict(state, strict=True)
        return self

    @torch.no_grad()
    def draw_params(self, generator: torch.Generator) -> "Transformer":
        """Fill every parameter in place as ``init_params`` defines it
        (``normal × scale``, zeros or ones), drawing from ``generator`` (on
        the module's device type) leaf by leaf in sorted-key order, a
        stacked leaf layer by layer.  Holds one copy of the parameters
        where ``load_params(init_params(...))`` holds two; the draws differ
        from ``init_params``'s."""
        params = dict(self.named_parameters())
        for path, d in tree_leaves(model_defs(self.cfg)):
            for name in self._names(path):
                p = params[name]
                if d.init == "zeros":
                    p.zero_()
                elif d.init == "ones":
                    p.fill_(1.0)
                else:
                    p.normal_(generator=generator).mul_(d.scale)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, batch: dict, caches=None, return_hidden: bool = False):
        """batch: tokens (B,S) [+ positions, mrope_positions (B,S,3),
        encoder_frames (B,T,d)].

        Returns (logits, aux_loss, new_caches).  ``caches=None`` → full
        causal attention; otherwise the tokens are decoded against the
        caches (one token, or a cache-populating prefill), whose tensors
        are written in place, without autograd.  ``return_hidden=True``
        returns the final-norm hidden states (B,S,d) of the compute dtype
        instead of logits (the chunked-vocab loss).
        """
        telemetry.count("models.forwards")
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and caches is None), \
                telemetry.span("models.forward"):
            return self._forward(batch, caches, return_hidden)

    def _forward(self, batch, caches, return_hidden):
        cfg = self.cfg
        remat = (cfg.remat != "none" and caches is None
                 and torch.is_grad_enabled())
        dt = _dt(cfg)
        tokens = batch["tokens"]
        # the gather commutes with the reference's cast of the whole table;
        # in bf16 the backward's scatter-add of repeated tokens then sums in
        # float32 here and in bf16 there (within the bf16 tolerance)
        x = F.embedding(tokens, _whole_table(self.embed)).to(dt)
        start = int(caches["pos"]) if caches is not None else 0
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(start, start + tokens.shape[1],
                                     device=tokens.device)[None, :]
        mrope = batch.get("mrope_positions")
        encoder_out = self._encode(batch, caches) if cfg.enc_dec else None
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new_caches = None if caches is None else {}
        if cfg.family in ATTN_FAMILIES:
            layers = caches["layers"] if caches is not None else None
            layer_pos = []
            for i, block in enumerate(self.blocks):
                x, a, nc = _call(remat, block, x, positions,
                                 _layer_cache(layers, i), mrope, encoder_out)
                aux = aux + a
                if nc is not None:
                    layer_pos.append(nc["pos"])
            if caches is not None:
                new_caches["layers"] = dict(layers, pos=_pos(layer_pos))
        elif cfg.family == "ssm":
            layers = caches["layers"] if caches is not None else None
            x, new_layers = self._ssm_stack(x, layers, remat=remat)
            if caches is not None:
                new_caches["layers"] = new_layers
        elif cfg.family == "hybrid":
            x, hc = self._hybrid_stack(x, positions, caches, remat)
            if caches is not None:
                new_caches.update(hc)
        else:
            raise ValueError(cfg.family)
        x = self.final_norm(x)
        if caches is not None:
            new_caches["pos"] = caches["pos"] + tokens.shape[1]
            if cfg.enc_dec:
                new_caches["encoder_out"] = encoder_out
        if return_hidden:
            return x, aux, new_caches
        head = self.embed.t() if cfg.tie_embeddings else self.lm_head
        logits = torch.einsum("bsd,dv->bsv", x, _cast(head, dt)).float()
        return logits, aux, new_caches

    def _ssm_stack(self, x, layers, shared=None, remat: bool = False):
        """The SSM layers over ``x``; ``shared(i, x)`` (hybrid) runs after
        each, inside layer ``i``'s recomputed body under ``remat``.
        Returns ``(x, new layer caches)`` (None without caches).  A conv
        window whose dtype is not the compute dtype's comes back as a new
        stacked tensor, as the reference's scan stacks it."""
        def body(i, block, x, cache):
            x, nc = block(x, cache)
            if shared is not None:
                x = shared(i, x)
            return x, nc

        convs, layer_pos = [], []
        for i, block in enumerate(self.ssm_blocks):
            x, nc = _call(remat, body, i, block, x, _layer_cache(layers, i))
            if nc is not None:
                convs.append(nc["conv"])
                layer_pos.append(nc["pos"])
        if layers is None:
            return x, None
        conv = layers["conv"]
        if convs and convs[0].dtype != conv.dtype:
            conv = torch.stack(convs)
        return x, dict(layers, conv=conv, pos=_pos(layer_pos))

    def _hybrid_stack(self, x, positions, caches, remat: bool = False):
        """Zamba2-style: Mamba2 layers with the single weight-tied attention
        block after every sixth; with caches, invocation j of the shared
        block has KV cache j (``shared_attn.k[j]``), at the model's
        ``pos``."""
        after = _shared_after(self.cfg)
        order = {i: j for j, i in enumerate(i for i, on in enumerate(after)
                                             if on)}
        attn_caches = caches["shared_attn"] if caches is not None else None

        def shared(i, x):
            if not after[i]:
                return x
            c = None
            if attn_caches is not None:
                c = {"k": attn_caches["k"][order[i]],
                     "v": attn_caches["v"][order[i]],
                     "pos": int(caches["pos"])}
            return self.shared_attn(x, positions, c)[0]

        x, ssm = self._ssm_stack(x, caches["ssm"] if caches is not None
                                 else None, shared=shared, remat=remat)
        if caches is None:
            return x, None
        return x, {"ssm": ssm, "shared_attn": attn_caches}

    def _encode(self, batch, caches):
        """Whisper encoder over precomputed frame embeddings (the conv
        frontend is a stub: ``encoder_frames`` are frame embeddings).  With
        caches it returns their ``encoder_out``, primed or still zero."""
        cfg = self.cfg
        if caches is not None and "encoder_out" in caches:
            return caches["encoder_out"]
        x = batch["encoder_frames"].to(_dt(cfg))
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        for blk in self.enc_blocks:
            x = x + _noncausal_self_attn(blk.attn, blk.ln1(x), pos)
            x = x + blk.ffn(blk.ln2(x))
        return self.enc_norm(x)


def check_cfg(model: Transformer, cfg: ModelConfig) -> None:
    """The port's model carries its config; an entry point that takes
    ``cfg`` to keep the reference's signature needs the same one."""
    if cfg is not model.cfg and cfg != model.cfg:
        raise ValueError(f"cfg {cfg.name!r} is not the model's config "
                         f"({model.cfg.name!r} with other fields)")


def _whole_table(embed):
    """The embedding table for a lookup, gathered over the mesh dimensions
    that shard its vocabulary (a DTensor), explicitly: DTensor's
    vocab-parallel lookup leaves masked partial sums that torch 2.11
    cannot reduce after a later op, nor take the gradient of, and its rule
    for an index's backward (``index_put``) fails there too.  The
    gradient goes back to the table's shards by the redistribution's own
    backward (a local slice)."""
    if not isinstance(embed, DTensor):
        return embed
    return embed.redistribute(embed.device_mesh,
                              [Replicate()] * embed.device_mesh.ndim)


def _call(remat: bool, fn, *args):
    """``fn(*args)``, recomputed in the backward pass under ``remat`` (the
    reference's ``jax.checkpoint``; the model draws no random numbers, so
    no RNG state is kept)."""
    if not remat:
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _layer_cache(layers, i: int):
    """Layer ``i``'s view of stacked layer caches (None without), its
    ``pos`` a Python int."""
    if layers is None:
        return None
    lcache = {k: t[i] for k, t in layers.items() if k != "pos"}
    lcache["pos"] = int(layers["pos"][i])
    return lcache


def _pos(layer_pos: list[int]) -> torch.Tensor:
    return torch.tensor(layer_pos, dtype=torch.int32)


@torch.no_grad()
def prime_encdec_caches(model: Transformer, cfg: ModelConfig, batch: dict,
                        caches: dict) -> dict:
    """Serving-time priming for enc-dec models: run the encoder once on
    ``batch["encoder_frames"]`` and precompute every decoder layer's
    cross-attention K/V.  Returns new caches dicts that hold the encoder
    output and (with ``cfg.cross_kv_cache``) ``xk``/``xv`` as new tensors
    of the compute dtype, as the reference's do; the other tensors are
    ``caches``'s."""
    check_cfg(model, cfg)
    enc = model._encode(batch, None)
    caches = dict(caches, encoder_out=enc)
    if cfg.cross_kv_cache:
        dt = _dt(cfg)
        xk, xv = [], []
        for blk in model.blocks:
            xk.append(torch.einsum("btd,dhk->bthk", enc,
                                   _cast(blk.xattn.wk, dt)).to(dt))
            xv.append(torch.einsum("btd,dhk->bthk", enc,
                                   _cast(blk.xattn.wv, dt)).to(dt))
        caches["layers"] = dict(caches["layers"], xk=torch.stack(xk),
                                xv=torch.stack(xv))
    return caches


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

def init_cache_shapes(cfg: ModelConfig, batch: int, max_seq: int,
                      dtype: torch.dtype = torch.bfloat16):
    """(shape, dtype) pairs of the decode caches, the reference's tree:
    ``pos`` (a scalar) and per family, stacked over layers with the
    layers' ``pos`` (n,):

    * attention (dense, vlm, moe, audio): ``layers`` of ``k``/``v`` (and
      ``k_scale``/``v_scale`` for the int8 cache), or MLA's ``c`` and
      ``k_rope``; enc-dec adds ``encoder_out`` and the cross ``xk``/``xv``;
    * ssm: ``layers`` of ``conv`` and a float32 ``state``;
    * hybrid: ``ssm`` (as ssm's ``layers``) and ``shared_attn`` ``k``/``v``
      per invocation of the shared block (no ``pos`` of their own)."""
    out: dict = {"pos": ((), torch.int32)}
    if cfg.family in ATTN_FAMILIES:
        n = n_attn_layers(cfg)
        if cfg.mla:
            layers = {"c": ((n, batch, max_seq, cfg.kv_lora_rank), dtype),
                      "k_rope": ((n, batch, max_seq, cfg.rope_head_dim),
                                 dtype)}
        else:
            int8 = cfg.kv_cache_dtype == "int8"
            kv = ((n, batch, max_seq, cfg.n_kv_heads, cfg.hd),
                  torch.int8 if int8 else dtype)
            layers = {"k": kv, "v": kv}
            if int8:
                sc = ((n, batch, max_seq, cfg.n_kv_heads), torch.float32)
                layers["k_scale"] = sc
                layers["v_scale"] = sc
        layers["pos"] = ((n,), torch.int32)
        out["layers"] = layers
        if cfg.enc_dec:
            out["encoder_out"] = ((batch, cfg.encoder_seq, cfg.d_model),
                                  dtype)
            if cfg.cross_kv_cache:
                xkv = ((n, batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.hd),
                       dtype)
                layers["xk"] = xkv
                layers["xv"] = xkv
    elif cfg.family in ("ssm", "hybrid"):
        n = n_ssm_layers(cfg)
        shapes = ssm_cache_shape(cfg, batch)
        ssm = {"conv": ((n,) + shapes["conv"], dtype),
               "state": ((n,) + shapes["state"], torch.float32),
               "pos": ((n,), torch.int32)}
        if cfg.family == "ssm":
            out["layers"] = ssm
        else:
            n_inv = sum(_shared_after(cfg))
            kv = ((n_inv, batch, max_seq, cfg.n_kv_heads, cfg.hd), dtype)
            out["ssm"] = ssm
            out["shared_attn"] = {"k": kv, "v": kv}
    else:
        raise ValueError(cfg.family)
    return out


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """Zeroed decode caches: every tensor on ``device`` but the ``pos``
    counters, which live on the CPU (host bookkeeping: slicing the cache
    at ``pos`` then needs no device synchronisation)."""
    dev = resolve_device(device)

    def zeros(tree):
        return {name: zeros(spec) if isinstance(spec, dict) else
                torch.zeros(spec[0], dtype=spec[1],
                            device="cpu" if name == "pos" else dev)
                for name, spec in tree.items()}

    return zeros(init_cache_shapes(cfg, batch, max_seq, dtype))
