"""nemotron-3-nano-30b-a3b [hybrid_moe] — 52 single-mixer blocks
(``nemotron_h``): 23 grouped Mamba-2 (64 heads of 64, 8 groups of state
128, conv 4 with bias, chunk 128), 23 MoE (128 sigmoid-routed relu²
experts of 1,856, top-6 of score + correction bias, gates renormalised ×
2.5, one shared relu² expert of 3,712) and 6 GQA attention without
positions (32 heads, 2 KV, head 128); d_model 2,688, vocab 131,072,
untied head.  31,577,940,288 parameters whole; this chip holds experts
0–63 of each MoE layer (two H100s share each by expert parallelism, the
router keeps 128): 16,890,536,256, in bf16.
[https://huggingface.co/nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16]

Port only: the reference has no such config, so it stays out of ``ARCHS``
and ``get_config("nemotron-3-nano-30b-a3b")`` finds it by its alias."""
import dataclasses

from .base import NemotronHConfig

CONFIG = NemotronHConfig(
    name="nemotron-3-nano-30b-a3b", family="hybrid_moe", n_layers=52,
    d_model=2688, n_heads=32, n_kv_heads=2, head_dim=128, d_ff=0,
    vocab=131072, rope="none", norm_eps=1e-5,
    moe=True, n_experts=128, experts_per_tok=6, d_expert=1856,
    n_shared_experts=1,
    ssm_state=128, ssm_heads=64, ssm_chunk=128,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    kv_cache_dtype="bfloat16",
    block_pattern="MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME",
    ssm_head_dim=64, ssm_groups=8, conv_bias=True,
    routed_scaling=2.5, shared_expert_width=3712,
    experts_held=64, first_expert=0,
)


def reduced() -> NemotronHConfig:
    """``MEM*EME`` at toy widths: 4 Mamba-2 heads of 8 in 2 groups of
    state 8, chunk 8; 4 of 8 experts held (top-3) and a shared expert;
    GQA 4/2 heads of 16; every mechanism of ``CONFIG`` kept."""
    return dataclasses.replace(
        CONFIG, name="nemotron-3-nano-30b-a3b-reduced", n_layers=7,
        block_pattern="MEM*EME", d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, vocab=256, n_experts=8, experts_per_tok=3, d_expert=32,
        ssm_state=8, ssm_heads=4, ssm_head_dim=8, ssm_groups=2, ssm_chunk=8,
        shared_expert_width=48, experts_held=4)
