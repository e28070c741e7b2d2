"""Model/runtime configuration system.

One ``ModelConfig`` covers all ten assigned architecture families (dense,
MoE, MLA, hybrid SSM, pure SSM, enc-dec audio, VLM).  Every architecture
config file in this package exports ``CONFIG`` (full size, dry-run only) and
``reduced()`` (CPU-smoke-test size, same family/topology).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 → d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rope: str = "rope"               # rope | mrope | none
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # -- MoE ------------------------------------------------------------
    moe: bool = False
    n_experts: int = 0
    experts_per_tok: int = 0
    d_expert: int = 0                # expert FFN hidden dim
    n_shared_experts: int = 0
    capacity_factor: float = 1.25

    # -- MLA (DeepSeek-V2 multi-head latent attention) --------------------
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64          # decoupled RoPE key dim

    # -- SSM (Mamba2/SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0               # 0 → d_inner // 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    # layer pattern: per-layer 'attn' | 'ssm' | 'shared_attn'; empty → attn
    layer_pattern: tuple[str, ...] = ()

    # -- enc-dec (whisper) --------------------------------------------------
    enc_dec: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500          # frames after the conv frontend (stub)

    # -- modality frontends (stubs per assignment) --------------------------
    frontend: str = "none"           # none | audio_stub | vision_stub

    # -- paper integration (SIMDRAM bit-serial layers) ----------------------
    pum_mlp: bool = False            # binarized (XNOR-popcount) MLP path
    pum_bits: int = 8

    # -- training/runtime ----------------------------------------------------
    remat: str = "full"              # none | full | dots
    scan_layers: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    loss_chunk: int = 0              # >0: chunked-vocab loss (§Perf)
    ssd_f32: bool = True             # SSD scan internals in f32 (vs bf16)
    cross_kv_cache: bool = True      # enc-dec decode: cache cross-attn K/V
    kv_cache_dtype: str = "bfloat16"  # bfloat16 | int8 (quantized KV cache)

    # -- DeepSeek-V2 options the ten configs above lack: plain class
    # attributes here, holding each option's off value, so ``asdict`` and
    # the reference's ``ModelConfig(**asdict(cfg))`` see the ten configs
    # unchanged; :class:`DeepSeekV2Config` makes them fields -------------
    first_k_dense = 0                # leading layers with a dense FFN
    dropless = False                 # MoE computes every routed pair
    norm_topk_prob = True            # top-k gates renormalised to sum 1
    kv_norm = False                  # MLA: RMSNorm on the kv latent
    yarn_factor = 1.0                # > 1: YaRN rope scaling (MLA)
    yarn_mscale = 1.0                # YaRN's mscale (= mscale_all_dim)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:        # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or max(1, self.d_inner // 64)

    def pattern(self) -> tuple[str, ...]:
        if self.layer_pattern:
            assert len(self.layer_pattern) == self.n_layers
            return self.layer_pattern
        return ("attn",) * self.n_layers

    def decode_supported(self) -> bool:
        return True                  # all assigned archs have a decoder

    def long_context_supported(self) -> bool:
        """long_500k runs only for sub-quadratic (SSM/hybrid) archs; pure
        full-attention archs skip it (see DESIGN.md §Arch-applicability)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS and memory plans)."""
        d, v = self.d_model, self.vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        for kind in self.pattern():
            if kind == "ssm":
                di, st, nh = self.d_inner, self.ssm_state, self.n_ssm_heads
                # in_proj (z,x,B,C,dt) + out_proj + conv (as in mamba2)
                total += d * (2 * di + 2 * st + nh) + di * d + 3 * di
            else:
                if self.mla:
                    r, rh = self.kv_lora_rank, self.rope_head_dim
                    qd = self.n_heads * (self.hd + rh)
                    total += d * (r + rh) + r * self.n_heads * 2 * self.hd
                    total += (d * self.q_lora_rank + self.q_lora_rank * qd
                              if self.q_lora_rank else d * qd)
                    total += self.n_heads * self.hd * d
                else:
                    total += d * self.hd * (self.n_heads + 2 * self.n_kv_heads)
                    total += self.n_heads * self.hd * d
                if self.moe:
                    e = self.n_experts * 3 * d * self.d_expert
                    e += self.n_shared_experts * 3 * d * self.d_expert
                    total += e + d * self.n_experts
                else:
                    total += 3 * d * self.d_ff
        if self.enc_dec:
            # encoder layers: self-attn + mlp; decoder cross-attn already in
            # n_layers accounting above? encoder counted here:
            enc = self.n_encoder_layers * (4 * d * self.hd * self.n_heads // 1
                                           + 3 * d * self.d_ff)
            total += enc
        return total

    def active_param_count(self) -> int:
        """Active (per-token) params — the MoE-aware count for MODEL_FLOPS."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        dense_experts = self.experts_per_tok + self.n_shared_experts
        per_layer_active = dense_experts * 3 * d * self.d_expert + d * self.n_experts
        per_layer_all = ((self.n_experts + self.n_shared_experts) * 3 * d
                         * self.d_expert + d * self.n_experts)
        return self.param_count() - self.n_layers * (per_layer_all - per_layer_active)


@dataclasses.dataclass(frozen=True)
class DeepSeekV2Config(ModelConfig):
    """A :class:`ModelConfig` with the DeepSeek-V2 options as fields (port
    only: the reference has no such class).  The defaults are the plain
    class's off values."""
    first_k_dense: int = ModelConfig.first_k_dense
    dropless: bool = ModelConfig.dropless
    norm_topk_prob: bool = ModelConfig.norm_topk_prob
    kv_norm: bool = ModelConfig.kv_norm
    yarn_factor: float = ModelConfig.yarn_factor
    yarn_mscale: float = ModelConfig.yarn_mscale

    def param_count(self) -> int:
        """As :meth:`ModelConfig.param_count`, with the leading dense
        layers' SwiGLU of ``d_ff`` in place of their MoE and the latent
        norms' scales."""
        d = self.d_model
        moe = ((self.n_experts + self.n_shared_experts) * 3 * d
               * self.d_expert + d * self.n_experts)
        return (super().param_count()
                - self.first_k_dense * (moe - 3 * d * self.d_ff)
                + self.n_layers * self.kv_lora_rank * self.kv_norm)

    def active_param_count(self) -> int:
        d = self.d_model
        idle = (self.n_experts - self.experts_per_tok) * 3 * d * self.d_expert
        return self.param_count() - (self.n_layers - self.first_k_dense) * idle


@dataclasses.dataclass(frozen=True)
class NemotronHConfig(ModelConfig):
    """A ``nemotron_h`` hybrid (port only): one single-mixer pre-norm block
    a letter of ``block_pattern`` — ``M`` a grouped Mamba-2 mixer, ``E`` a
    dropless MoE of ``ffn_act`` experts (non-gated relu², or SwiGLU) under
    a sigmoid router, ``*`` GQA attention without positions
    (``rope="none"``).  The Mamba-2 inner width is ``ssm_heads ×
    ssm_head_dim`` (not ``ssm_expand · d_model``), head h reading B/C
    group ``h // (ssm_heads / ssm_groups)``.  The MoE holds
    ``experts_held`` of the router's ``n_experts`` (0: all), from
    ``first_expert`` on: a chip's share under expert parallelism."""
    block_pattern: str = ""
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_bias: bool = True
    ffn_act: str = "relu2"
    router: str = "sigmoid"
    routed_scaling: float = 1.0
    shared_expert_width: int = 0
    experts_held: int = 0
    first_expert: int = 0

    LETTERS = {"M": "ssm", "E": "moe", "*": "attn"}
    # the kind of its recurrent blocks, whose states the decode caches
    # hold (``ssm``); one a config, so no pattern mixes two
    RECURRENT = "ssm"
    # the expert activations the port computes: weight matrices an expert
    ACTIVATIONS = {"relu2": 2, "swiglu": 3}

    def __post_init__(self):
        for field, value, want in (("ffn_act", self.ffn_act,
                                    tuple(self.ACTIVATIONS)),
                                   ("router", self.router, ("sigmoid",))):
            if value not in want:
                raise ValueError(f"{field} = {value!r}: the port computes "
                                 f"{' and '.join(map(repr, want))} only")
        unknown = set(self.block_pattern) - set(self.LETTERS)
        if unknown:
            raise ValueError(f"block_pattern letters {sorted(unknown)}: "
                             f"this config has {sorted(self.LETTERS)}")
        if not 0 <= self.first_expert < self.first_expert + self.held \
                <= self.n_experts:
            raise ValueError(f"experts {self.first_expert}.."
                             f"{self.first_expert + self.held - 1} are not "
                             f"among the router's {self.n_experts}")
        if self.ssm_heads % self.ssm_groups:
            raise ValueError("ssm_heads must be a multiple of ssm_groups")

    @property
    def held(self) -> int:
        """Experts this model holds of each MoE layer."""
        return self.experts_held or self.n_experts

    @property
    def d_inner(self) -> int:
        return self.ssm_heads * self.ssm_head_dim

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads

    def pattern(self) -> tuple[str, ...]:
        assert len(self.block_pattern) == self.n_layers
        return tuple(self.LETTERS[c] for c in self.block_pattern)

    def _block_params(self) -> dict[str, int]:
        """Parameters of one block of each kind, its norm left out."""
        d = self.d_model
        di, nh = self.d_inner, self.n_ssm_heads
        ch = di + 2 * self.ssm_groups * self.ssm_state
        mats = self.ACTIVATIONS[self.ffn_act]
        return {
            "ssm": d * (di + ch + nh) + 4 * ch + ch * self.conv_bias
            + 3 * nh + di + di * d,
            "moe": (d + 1) * self.n_experts
            + mats * d * (self.held * self.d_expert
                          + self.shared_expert_width),
            "attn": 2 * d * self.hd * (self.n_heads + self.n_kv_heads),
        }

    def param_count(self) -> int:
        """Parameters held: embedding, untied head, final norm, and each
        block's norm and mixer (the MoE's router over all ``n_experts``,
        its choice bias, the ``held`` experts and the shared expert)."""
        d, v = self.d_model, self.vocab
        per = self._block_params()
        return (v * d * (1 if self.tie_embeddings else 2) + d
                + sum(per[k] + d for k in self.pattern()))


@dataclasses.dataclass(frozen=True)
class KimiLinearConfig(NemotronHConfig):
    """A ``kimi_linear`` hybrid (port only) as a stack of single-mixer
    blocks, two a published layer: its mixer — ``K`` Kimi Delta Attention
    (``kda_heads`` heads of ``kda_head_dim`` for keys and values, short
    convolutions of 4 taps, a low-rank gate of ``kda_head_dim``), or ``L``
    MLA without positions (``mla``, ``rope="none"``, the latent norm
    ``kv_norm``) — then its FFN — ``D`` a dense SwiGLU of ``d_ff``, or
    ``E`` the sigmoid-routed MoE of SwiGLU experts.  ``n_layers`` counts
    the blocks."""
    kda_heads: int = 0
    kda_head_dim: int = 128
    kv_norm = True                   # MLA's latent norm, always applied

    LETTERS = {"K": "kda", "L": "attn", "D": "dense", "E": "moe"}
    RECURRENT = "kda"

    def __post_init__(self):
        super().__post_init__()
        if "L" in self.block_pattern and not (self.mla and
                                              self.rope == "none"):
            raise ValueError("an L block is MLA without positions: mla "
                             "and rope='none'")
        if self.q_lora_rank:
            raise ValueError("q_lora_rank: the port's MLA here has no q "
                             "compression")

    def _block_params(self) -> dict[str, int]:
        d, h, k = self.d_model, self.kda_heads, self.kda_head_dim
        w = h * k
        nh, hd = self.n_heads, self.hd
        r, rh = self.kv_lora_rank, self.rope_head_dim
        return dict(
            super()._block_params(),
            # w_in [q|k|v|f_a|g_a|β], the conv, f_b and g_b, A_log,
            # dt_bias, the output norm, w_out
            kda=d * (3 * w + 2 * k + h) + 4 * 3 * w + 2 * k * w + h + w + k
            + w * d,
            attn=d * nh * (hd + rh) + d * (r + rh) + 2 * r * nh * hd
            + nh * hd * d + r * self.kv_norm,
            dense=3 * d * self.d_ff)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> bool:
    if shape == "long_500k":
        return cfg.long_context_supported()
    return True
