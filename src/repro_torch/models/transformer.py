"""Model composition: decoder LMs (dense, vlm), MoE LMs (with MLA for
DeepSeek-V2), enc-dec (whisper), hybrid (zamba2), pure-SSM (mamba2) and
hybrid MoE stacks (``nemotron_h``: Mamba-2, MoE and attention blocks;
``kimi_linear``: Kimi Delta Attention, NoPE MLA, dense and MoE blocks),
with per-family decode caches.

Entry points (the reference's, :mod:`repro.models.transformer`)
----------------------------------------------------------------
``model_defs(cfg)``                       ParamDef tree (stacked ``blocks``,
                                          ``ssm_blocks``, ``enc_blocks``;
                                          ``dense_blocks`` for leading
                                          dense layers of a MoE model;
                                          a hybrid MoE's blocks of each
                                          letter)
``Transformer(cfg, device)``              the module; ``load_params(tree)``
                                          fills it from such a tree,
                                          ``draw_params(generator)`` draws
                                          it in place
``Transformer(...)(batch, caches=None)``  → (logits, aux, new_caches);
                                          ``return_hidden=True`` gives the
                                          final-norm hidden states instead
                                          of logits (the chunked loss, the
                                          prefill), ``model.logits(h)``
                                          their logits
``prime_encdec_caches(model, cfg, ...)``  run the encoder once into the
                                          caches (enc-dec serving)
``init_cache_shapes(cfg, batch, seq)``    decode-cache (shape, dtype) tree
``init_caches(cfg, batch, seq, ...)``     the zeroed decode caches

Under autograd without caches, ``cfg.remat != "none"`` ("full" and
"dots" alike) recomputes each block in the backward pass, where the
reference applies ``jax.checkpoint``: an attention block, an SSM block,
and the hybrid's SSM layer together with the shared block after it.

On the card, a cached one-token forward of an attention model or a
hybrid MoE is one CUDA graph replay (:class:`DecodeGraph`): the model
holds one graph, for one set of decode caches, which records the eager
forward on the first such step over them and is replayed with the
position filled in on the device.  Where it engages is
:meth:`Transformer.in_graph`; every other forward is eager.  Without grad
(every cached forward) the weights are the parameters' compute-dtype
copies, cast once (``layers._cast``).
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
from .layers import (MLP, Attention, KDAMixer, Mamba2Mixer, MLAttention,
                     MoE, ParamDef, PumMLP, RMSNorm, SigmoidMoE, SSMMixer,
                     _cast, _check_room, _dt, _flash, _kept_copy, _param,
                     _pdt, _sdpa, apply_rope, attention_defs,
                     kda_cache_shape, kda_defs, mamba2_cache_shape,
                     mamba2_defs, mla_defs, mlp_defs, moe_defs, rmsnorm_defs,
                     sigmoid_moe_defs, ssm_cache_shape, ssm_defs)
from .params import stack_defs, tree_leaves

P = ParamDef

ATTN_FAMILIES = ("dense", "moe", "audio", "vlm")
# the families whose one-token step a DecodeGraph records
GRAPH_FAMILIES = ATTN_FAMILIES + ("hybrid_moe",)
# parameter subtrees stacked over layers in the reference's tree (and the
# port's ``dense_blocks``: a MoE model's leading dense layers, named
# ``blocks.<i>`` in the module before the MoE layers; and a hybrid MoE's
# blocks of each kind)
STACKED = ("blocks", "ssm_blocks", "enc_blocks", "dense_blocks",
           "attn_blocks", "moe_blocks", "kda_blocks", "mla_blocks",
           "mlp_blocks")


class DenseFFN(MLP):
    """A hybrid MoE's dense block: the SwiGLU of ``d_ff``, ``(y, None)``
    as a mixer returns."""

    def forward(self, x):
        return super().forward(x), None


# a hybrid MoE's letters: each one's stacked subtree, mixer and its defs
LETTERS = {"M": ("ssm_blocks", Mamba2Mixer, mamba2_defs),
           "E": ("moe_blocks", SigmoidMoE, sigmoid_moe_defs),
           "*": ("attn_blocks", Attention, attention_defs),
           "K": ("kda_blocks", KDAMixer, kda_defs),
           "L": ("mla_blocks", MLAttention, mla_defs),
           "D": ("mlp_blocks", DenseFFN, mlp_defs)}
# a hybrid MoE's recurrent kind (its config's ``RECURRENT``): one layer's
# conv window and state
RECURRENT_CACHE = {"ssm": mamba2_cache_shape, "kda": kda_cache_shape}
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
        pdt = _pdt(cfg)
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, device, pdt)
        self.attn = (MLAttention if cfg.mla else Attention)(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, device, pdt)
        if cfg.moe:
            self.ffn = MoE(cfg, device)
        else:
            self.ffn = (PumMLP if cfg.pum_mlp else MLP)(cfg, device)
        if cross:
            self.ln_x = RMSNorm(cfg.d_model, cfg.norm_eps, device, pdt)
            self.xattn = Attention(cfg, device)

    def forward(self, x, positions, cache=None, mrope_positions=None,
                encoder_out=None, rope=None):
        """Returns ``(x, aux, new_cache)``.  A cache may carry ``xk``/``xv``
        (the precomputed cross-attention keys and values), which pass
        through to the new cache; ``rope``: MLA's cos/sin of
        ``positions`` (:meth:`MLAttention.rope`), if made already."""
        cfg = self.cfg
        cross_kv = None
        if cache is not None and "xk" in cache:
            cross_kv = (cache["xk"], cache["xv"])
            cache = {k: v for k, v in cache.items() if k not in ("xk", "xv")}
        h = self.ln1(x)
        with telemetry.span("models.attn"):
            if cfg.mla:
                y, new_cache = self.attn(h, positions, cache, rope)
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


class MixerBlock(nn.Module):
    """``x + mixer(RMSNorm(x))``: a pre-norm block of one mixer (``ln``,
    ``mixer``), whose ``(y, extra)`` it returns as ``(x + y, extra)``."""

    def __init__(self, cfg: ModelConfig, mixer: nn.Module, device="cuda"):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, cfg.norm_eps, device, _pdt(cfg))
        self.mixer = mixer

    def forward(self, x, *args):
        y, extra = self.mixer(self.ln(x), *args)
        return x + y, extra


class SSMBlock(MixerBlock):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__(cfg, SSMMixer(cfg, device), device)


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


def _dense_cfg(cfg: ModelConfig) -> ModelConfig:
    """A leading dense layer's config: the SwiGLU of ``d_ff`` for the MoE."""
    return dataclasses.replace(cfg, moe=False)


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    # the encoder's blocks are dense (and never binarized: ``_encode``
    # calls the plain MLP); pum_mlp changes no parameter definition
    return dataclasses.replace(cfg, moe=False, mla=False, pum_mlp=False)


def _letters(cfg: ModelConfig):
    """The hybrid MoE letters ``cfg.block_pattern`` uses, with their
    subtree, mixer and defs."""
    return [(c, v) for c, v in LETTERS.items() if c in cfg.block_pattern]


def model_defs(cfg: ModelConfig):
    d, v = cfg.d_model, cfg.vocab
    defs: dict = {"embed": P((v, d), ("vocab", "embed"), scale=0.01)}
    if cfg.family == "hybrid_moe":
        for letter, (name, _, mixer_defs) in _letters(cfg):
            defs[name] = stack_defs(
                {"ln": rmsnorm_defs(d), "mixer": mixer_defs(cfg)},
                cfg.block_pattern.count(letter))
    elif cfg.family == "hybrid":
        defs["ssm_blocks"] = stack_defs(ssm_block_defs(cfg), n_ssm_layers(cfg))
        defs["shared_attn"] = attn_block_defs(cfg)          # weight-tied
    elif cfg.family == "ssm":
        defs["ssm_blocks"] = stack_defs(ssm_block_defs(cfg), n_ssm_layers(cfg))
    else:
        k = cfg.first_k_dense
        defs["blocks"] = stack_defs(
            attn_block_defs(cfg, cross=cfg.enc_dec), n_attn_layers(cfg) - k)
        if k:
            defs["dense_blocks"] = stack_defs(
                attn_block_defs(_dense_cfg(cfg)), k)
    if cfg.enc_dec:
        defs["enc_blocks"] = stack_defs(attn_block_defs(_encoder_cfg(cfg)),
                                        cfg.n_encoder_layers)
        defs["enc_norm"] = rmsnorm_defs(d)
    defs["final_norm"] = rmsnorm_defs(d)
    if not cfg.tie_embeddings:
        defs["lm_head"] = P((d, v), ("embed", "vocab"), scale=0.01)
    return defs


def _layer_names(path: str, n_layers: int, first_k_dense: int = 0
                 ) -> list[str]:
    head, _, rest = path.partition(".")
    if head == "dense_blocks":
        return [f"blocks.{i}.{rest}" for i in range(n_layers)]
    if head in STACKED:
        first = first_k_dense if head == "blocks" else 0
        return [f"{head}.{first + i}.{rest}" for i in range(n_layers)]
    return [path]


def leaf_names(cfg: ModelConfig) -> list[list[str]]:
    """The :class:`Transformer`'s parameter names of each ``model_defs(cfg)``
    leaf, in the reference's leaf order: one per layer (the leaf's leading
    axis) for a stacked subtree."""
    return [_layer_names(path, d.shape[0], cfg.first_k_dense)
            for path, d in tree_leaves(model_defs(cfg))]


class Transformer(nn.Module):
    """The LM of any family.  Parameter names follow the reference's tree
    with the stacked subtrees unstacked into ``<name>.<i>`` (``embed``,
    ``blocks.0.attn.wq``, ``blocks.0.ffn.shared.w_up``,
    ``ssm_blocks.3.mixer.a_log``, ``enc_blocks.1.ffn.w_down``,
    ``final_norm.scale``, ``lm_head`` unless the embeddings are tied); the
    hybrid's weight-tied ``shared_attn`` is one block, called after every
    sixth SSM layer; a hybrid MoE's blocks of each letter are numbered
    apart (``ssm_blocks.<i>``, ``moe_blocks.<i>``, ``attn_blocks.<i>``,
    ``kda_blocks.<i>``, ``mla_blocks.<i>``, ``mlp_blocks.<i>``, each ``ln``
    and ``mixer``) and run in ``cfg.block_pattern``'s order;
    a MoE model's ``cfg.first_k_dense`` leading blocks have the dense
    SwiGLU of ``d_ff`` (``blocks.0.ffn.w_gate``, ...).
    Parameters are held in ``cfg.param_dtype``.  Built uninitialised on
    ``device`` (``"cuda"`` unless the caller asks for the CPU); fill it
    with :meth:`load_params` or :meth:`draw_params`.

    ``cfg.scan_layers`` does not change the computation: the layer loop
    is Python either way.  ``cfg.remat`` recomputes blocks in the backward
    pass (module docstring) and changes no value.

    A one-token decode step on the card is a replay of the model's
    :class:`DecodeGraph` where :meth:`in_graph` allows; the graph reads the
    parameters it was captured with, and their compute-dtype copies, which
    a replay first refills where a parameter's version counter moved, so
    change them in place only.
    """

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        defs = model_defs(cfg)
        pdt = _pdt(cfg)
        self.embed = _param(defs["embed"], dev, pdt)
        if cfg.family == "hybrid_moe":
            for letter, (name, mixer, _) in _letters(cfg):
                setattr(self, name, nn.ModuleList(
                    MixerBlock(cfg, mixer(cfg, dev), dev)
                    for _ in range(cfg.block_pattern.count(letter))))
        elif cfg.family in ("ssm", "hybrid"):
            self.ssm_blocks = nn.ModuleList(SSMBlock(cfg, dev)
                                            for _ in range(n_ssm_layers(cfg)))
            if cfg.family == "hybrid":
                self.shared_attn = AttnBlock(cfg, dev)
        else:
            self.blocks = nn.ModuleList(
                AttnBlock(_dense_cfg(cfg) if i < cfg.first_k_dense else cfg,
                          dev, cross=cfg.enc_dec)
                for i in range(n_attn_layers(cfg)))
        if cfg.enc_dec:
            enc_cfg = _encoder_cfg(cfg)
            self.enc_blocks = nn.ModuleList(
                AttnBlock(enc_cfg, dev) for _ in range(cfg.n_encoder_layers))
            self.enc_norm = RMSNorm(cfg.d_model, cfg.norm_eps, dev, pdt)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, dev, pdt)
        if not cfg.tie_embeddings:
            self.lm_head = _param(defs["lm_head"], dev, pdt)
        self._graph = None

    def _names(self, path: str) -> list[str]:
        """The module's parameter names of a ``model_defs`` leaf: one per
        layer for a stacked subtree, in layer order."""
        head = path.partition(".")[0]
        k = self.cfg.first_k_dense
        if head == "dense_blocks":
            n = k
        elif head in STACKED:
            n = len(getattr(self, head)) - (k if head == "blocks" else 0)
        else:
            n = 1
        return _layer_names(path, n, k)

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
        instead of logits (the chunked-vocab loss).  A forward on other
        caches than the model's :class:`DecodeGraph`'s drops that graph
        first; a one-token step that :meth:`in_graph` allows is the graph's
        (:meth:`_graph_step`).
        """
        telemetry.count("models.forwards")
        grad = torch.is_grad_enabled()
        if self._graph is not None and not self._graph.serves(caches):
            self._graph = None
        with torch.set_grad_enabled(grad and caches is None), \
                telemetry.span("models.forward"):
            if not grad and not return_hidden and self.in_graph(batch, caches):
                return self._graph_step(batch["tokens"], caches)
            return self._forward(batch, caches, return_hidden)

    def in_graph(self, batch: dict, caches) -> bool:
        """Whether a forward of ``batch`` on ``caches`` (without grad, for
        logits) is a CUDA graph's step: an attention model or a hybrid MoE
        (not enc-dec, no M-RoPE, no int8 cache, no DTensor parameters) on
        the card, one token a sequence of the caches' batch and nothing
        else in the batch, and for GQA a cache that one query attends over
        on the plain path (:func:`~.layers._flash`; the flash path keeps a
        host offset)."""
        cfg = self.cfg
        if (caches is None or cfg.family not in GRAPH_FAMILIES
                or cfg.enc_dec or cfg.rope == "mrope"
                or cfg.kv_cache_dtype == "int8" or len(batch) != 1):
            return False
        tokens = batch["tokens"]
        b, t = _cache_size(cfg, caches)
        if (tuple(tokens.shape) != (b, 1) or not _cuda(tokens)
                or (not cfg.mla and _flash(1, t))):
            return False
        # a graph held here serves these caches (the forward drops any
        # other), and its capture checked the parameters
        return self._graph is not None or not any(
            isinstance(p, DTensor) for p in self.parameters())

    def _graph_step(self, tokens, caches):
        """One token a sequence through the graph of these caches, captured
        here if the model holds none (that step runs eagerly, its output
        returned); the positions advance on the host, which checks the
        room first."""
        pos = int(caches["pos"])
        _check_room(pos, 1, _cache_size(self.cfg, caches)[1])
        if self._graph is None:
            self._graph, (logits, aux) = DecodeGraph.capture(
                self._forward, caches, tokens, pos, self.parameters())
        else:
            logits, aux = self._graph.replay(tokens, pos)
        return logits, aux, dict(
            {k: dict(c, pos=c["pos"] + 1) for k, c in caches.items()
             if k in DecodeGraph.GROUPS}, pos=caches["pos"] + 1)

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
        s = tokens.shape[1]
        # a cached forward starts at the caches' host counter (0-d), or at
        # the device tensor of shape (1,) that a DecodeGraph records with
        start = 0 if caches is None else caches["pos"]
        if torch.is_tensor(start) and start.ndim == 0:
            start = int(start)
        positions = batch.get("positions")
        if positions is None:
            positions = (torch.arange(s, device=tokens.device)
                         + start)[None, :]
        mrope = batch.get("mrope_positions")
        encoder_out = self._encode(batch, caches) if cfg.enc_dec else None
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new_caches = None if caches is None else {}
        if cfg.family in ATTN_FAMILIES:
            layers = caches["layers"] if caches is not None else None
            # MLA: the rope's cos/sin, made once for every layer
            rope = self.blocks[0].attn.rope(positions, dt) if cfg.mla else None
            for i, block in enumerate(self.blocks):
                x, a, _ = _call(remat, block, x, positions,
                                _layer_cache(layers, i, start), mrope,
                                encoder_out, rope)
                aux = aux + a
            if caches is not None:
                new_caches["layers"] = dict(layers, pos=layers["pos"] + s)
        elif cfg.family == "ssm":
            layers = caches["layers"] if caches is not None else None
            x, new_layers = self._ssm_stack(x, layers, remat=remat)
            if caches is not None:
                new_caches["layers"] = new_layers
        elif cfg.family == "hybrid":
            x, hc = self._hybrid_stack(x, positions, caches, remat)
            if caches is not None:
                new_caches.update(hc)
        elif cfg.family == "hybrid_moe":
            x, aux = self._hybrid_moe_stack(x, positions, caches, start,
                                            remat)
            if caches is not None:
                for name in ("layers", "ssm"):
                    new_caches[name] = dict(caches[name],
                                            pos=caches[name]["pos"] + s)
        else:
            raise ValueError(cfg.family)
        x = self.final_norm(x)
        if caches is not None:
            new_caches["pos"] = caches["pos"] + s
            if cfg.enc_dec:
                new_caches["encoder_out"] = encoder_out
        if return_hidden:
            return x, aux, new_caches
        return self.logits(x), aux, new_caches

    def logits(self, x):
        """float32 logits (B,S,V) of final-norm hidden states ``x``."""
        cfg = self.cfg
        dt = _dt(cfg)
        head = (_cast(self.embed, dt).t() if cfg.tie_embeddings
                else _cast(self.lm_head, dt))
        return torch.einsum("bsd,dv->bsv", x, head).float()

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

        convs = []
        for i, block in enumerate(self.ssm_blocks):
            x, nc = _call(remat, body, i, block, x, _layer_cache(layers, i))
            if nc is not None:
                convs.append(nc["conv"])
        if layers is None:
            return x, None
        conv = layers["conv"]
        if convs and convs[0].dtype != conv.dtype:
            conv = torch.stack(convs)
        return x, dict(layers, conv=conv, pos=layers["pos"] + x.shape[1])

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

    def _hybrid_moe_stack(self, x, positions, caches, start,
                          remat: bool = False):
        """A hybrid MoE: the blocks in ``cfg.block_pattern``'s order, the
        i-th of a letter from its stack; with caches, the i-th ``*`` or
        ``L`` block attends over KV or latent cache i (``layers``) at
        ``start``, and the i-th block of the config's ``RECURRENT`` kind
        (``M`` Mamba-2 or ``K`` KDA) keeps recurrent cache i (``ssm``).
        Returns ``(x, aux)``."""
        cfg = self.cfg
        kv, ssm = (None, None) if caches is None else (caches["layers"],
                                                         caches["ssm"])
        seen = dict.fromkeys(LETTERS, 0)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for letter in cfg.block_pattern:
            i = seen[letter]
            seen[letter] += 1
            block = getattr(self, LETTERS[letter][0])[i]
            kind = cfg.LETTERS[letter]
            if kind == cfg.RECURRENT:
                x, _ = _call(remat, block, x, _layer_cache(ssm, i, start))
            elif kind == "attn":
                with telemetry.span("models.attn"):
                    x, _ = _call(remat, block, x, positions,
                                 _layer_cache(kv, i, start))
            else:
                with telemetry.span("models.ffn"):
                    x, a = _call(remat, block, x)
                if a is not None:
                    aux = aux + a
        return x, aux

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


def _cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def _cache_size(cfg: ModelConfig, caches) -> tuple[int, int]:
    """(sequences, positions) of an attention model's or a hybrid MoE's
    decode caches, from its attention layers' cache: MLA's latent ``c``,
    else the KV cache ``k``."""
    b, t = caches["layers"]["c" if cfg.mla else "k"].shape[1:3]
    return b, t


def _uncounted(fn):
    """``fn()`` and the counters it added, taken back out of the
    registry: ``(result, {name: n})``."""
    before = telemetry.snapshot()["counters"]
    out = fn()
    added = {k: n - before.get(k, 0)
             for k, n in telemetry.snapshot()["counters"].items()
             if n != before.get(k, 0)}
    _recount({k: -n for k, n in added.items()})
    return out, added


def _recount(added: dict) -> None:
    """Add each counter's ``added[name]`` to the registry."""
    for k, n in added.items():
        telemetry.count(k, n)


class DecodeGraph:
    """One-token decode steps over one set of decode caches as one CUDA
    graph of the model's eager forward (:meth:`Transformer._forward`) on
    static ``tokens`` and a static device position ``pos`` (int64, shape
    (1,)): each layer writes its cache there and attends over the whole
    cache with the keys past it masked, and nothing reads a Python
    position or synchronises.  :meth:`replay` refills in place the
    compute-dtype copy (``layers._Copy``) of each parameter in ``weights``
    whose version counter moved since its fill, fills the position and the
    tokens in on the device, launches the graph on the caller's stream
    (span ``models.graph.replay``; ``models.graph.replays``), adds to the
    registry the counters the recorded step added (``counts``), and
    returns copies of the outputs, so a later replay overwrites nothing a
    caller holds.  It writes the cache tensors of ``layers`` (KV or
    latent) and, for a hybrid MoE, ``ssm`` (Mamba-2's or KDA's states and
    conv windows, in place)."""

    GROUPS = ("layers", "ssm")
    ssm: dict = {}           # the SSM caches it writes (none: attention)

    @classmethod
    def capture(cls, forward, caches: dict, tokens: torch.Tensor, pos: int,
                params):
        """The first step of ``forward(batch, caches, return_hidden)`` over
        ``caches`` at ``pos`` runs eagerly on a side stream (the real step;
        it also warms that stream's kernels and workspaces, and casts the
        copies of ``params`` it reads if none were cast before), then is
        recorded there, after the allocator's unused cache is given back
        to the device, and joined to the caller's stream by stream waits
        (``models.graph.captures``).  The graph keeps ``weights``: each of
        ``params`` that has a copy then, with it.  Returns ``(graph,
        (logits, aux))`` of that first step."""
        g = cls()
        dev = tokens.device
        g.layers, g.ssm = ({k: t for k, t in caches.get(group, {}).items()
                            if k != "pos"} for group in cls.GROUPS)
        g.tokens = tokens.clone()
        g.pos = torch.full((1,), pos, dtype=torch.long, device=dev)
        g.graph = torch.cuda.CUDAGraph()

        def step():
            # the new caches it returns are dropped: the caller advances
            # the host counters
            return forward({"tokens": g.tokens}, dict(caches, pos=g.pos),
                           False)[:2]

        def record():
            g.graph.capture_begin(capture_error_mode="thread_local")
            try:
                return step()
            finally:
                g.graph.capture_end()
        main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            first = step()
            # a capture cannot give back memory the allocator caches unused
            # (the prefill's, the caller's stream's): what the recording
            # needs must be free on the device, so it is given back first,
            # at the cost of one synchronisation a capture
            torch.cuda.empty_cache()
            (g.logits, g.aux), g.counts = _uncounted(record)
        main.wait_stream(side)
        g.weights = [(p, c) for p in params
                     if (c := _kept_copy(p)) is not None]
        # made on the side stream (a copy perhaps), used on the caller's
        for t in (*first, *(c.out for _, c in g.weights)):
            t.record_stream(main)
        telemetry.count("models.graph.captures")
        return g, first

    def serves(self, caches) -> bool:
        """Whether ``caches`` are the caches this graph writes."""
        caches = caches or {}
        return all(caches.get(group, {}).get(k) is t
                   for group, held in zip(self.GROUPS, (self.layers, self.ssm))
                   for k, t in held.items())

    def replay(self, tokens: torch.Tensor, pos: int):
        for w, c in self.weights:
            if w._version != c.version:
                c.fill(w)
        self.pos.fill_(pos)
        self.tokens.copy_(tokens)
        with telemetry.span("models.graph.replay"):
            self.graph.replay()
        telemetry.count("models.graph.replays")
        _recount(self.counts)
        return self.logits.clone(), self.aux.clone()


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


def _layer_cache(layers, i: int, pos=None):
    """Layer ``i``'s view of stacked layer caches (None without) at
    ``pos``: a Python int, or a device tensor of shape (1,); the layer's
    own ``pos`` as an int unless given."""
    if layers is None:
        return None
    lcache = {k: t[i] for k, t in layers.items() if k != "pos"}
    lcache["pos"] = int(layers["pos"][i]) if pos is None else pos
    return lcache


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
      per invocation of the shared block (no ``pos`` of their own);
    * hybrid MoE: ``layers`` of ``k``/``v`` (or MLA's ``c`` and
      ``k_rope``) for its attention blocks, and ``ssm`` of ``conv`` and a
      float32 ``state`` for its Mamba-2 or KDA blocks."""
    out: dict = {"pos": ((), torch.int32)}
    if cfg.family == "hybrid_moe":
        n = n_attn_layers(cfg)
        if cfg.mla:
            out["layers"] = _mla_cache_shapes(cfg, n, batch, max_seq, dtype)
        else:
            kv = ((n, batch, max_seq, cfg.n_kv_heads, cfg.hd), dtype)
            out["layers"] = {"k": kv, "v": kv}
        out["layers"]["pos"] = ((n,), torch.int32)
        m = cfg.pattern().count(cfg.RECURRENT)
        shapes = RECURRENT_CACHE[cfg.RECURRENT](cfg, batch)
        out["ssm"] = {"conv": ((m,) + shapes["conv"], dtype),
                      "state": ((m,) + shapes["state"], torch.float32),
                      "pos": ((m,), torch.int32)}
    elif cfg.family in ATTN_FAMILIES:
        n = n_attn_layers(cfg)
        if cfg.mla:
            layers = _mla_cache_shapes(cfg, n, batch, max_seq, dtype)
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


def _mla_cache_shapes(cfg: ModelConfig, n: int, batch: int, max_seq: int,
                      dtype: torch.dtype) -> dict:
    return {"c": ((n, batch, max_seq, cfg.kv_lora_rank), dtype),
            "k_rope": ((n, batch, max_seq, cfg.rope_head_dim), dtype)}


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
