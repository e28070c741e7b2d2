"""``kimi_linear_decode``: one caller sending greedy-decode requests to the
port's ``kimi_linear`` model (KDA and NoPE MLA layers over a dense layer
and sigmoid-routed SwiGLU experts).

Configuration (``kind`` ``lm``): the published keys of the model's
``config.json`` (``hidden_size``, ``linear_attn_config``,
``num_experts``, ...), ``expert_share`` where the chip holds a share of
the experts (``num_experts`` of the router's ``published_num_experts``,
from ``first_expert``), the port's configuration ``port_config`` whose
sizes they replace (:func:`port_config`), the storage and compute dtypes,
the weights' initialisation (:mod:`simbench.harness.kimi_linear_weights`),
its plain ``reference`` and, in that module, the ``control``.  Traffic and
run as ``hybrid_moe_decode``'s (:func:`~simbench.drivers.
hybrid_moe_decode.decode_run`), whose check follows the program's expert
choices (:func:`~simbench.drivers.hybrid_moe_decode.program_routes`).
"""
from __future__ import annotations

import dataclasses
import importlib

from simbench.counts.kimi_linear_flops import request_flops
from simbench.drivers.hybrid_moe_decode import decode_run, program_routes
from simbench.harness import kimi_linear_weights
from simbench.reference.kimi_linear_lm import expert_share

# published key → the port's KimiLinearConfig field of the same size
PORT_FIELDS = {
    "hidden_size": "d_model", "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads", "qk_nope_head_dim": "head_dim",
    "vocab_size": "vocab", "rms_norm_eps": "norm_eps",
    "intermediate_size": "d_ff", "kv_lora_rank": "kv_lora_rank",
    "qk_rope_head_dim": "rope_head_dim",
    "num_experts_per_token": "experts_per_tok",
    "moe_intermediate_size": "d_expert",
    "routed_scaling_factor": "routed_scaling",
    "param_dtype": "param_dtype", "compute_dtype": "compute_dtype",
    "kv_cache_dtype": "kv_cache_dtype",
}
# published settings the port computes only at these values
FIXED = {"model_type": "kimi_linear", "mla_use_nope": True,
         "hidden_act": "silu", "moe_router_activation_func": "sigmoid",
         "moe_renormalize": True, "num_expert_group": 1, "topk_group": 1,
         "moe_layer_freq": 1, "num_nextn_predict_layers": 0,
         "q_lora_rank": None, "rope_scaling": None,
         "tie_word_embeddings": False}


def port_config(config: dict):
    """The port's config of ``config``: the port's ``port_config`` with
    every published size in its port field, two blocks a layer (the
    mixer, then the FFN) and the expert share.  Raises where the program
    lacks the configuration, before anything is drawn."""
    for key, want in FIXED.items():
        if config.get(key, want) != want:
            raise ValueError(f"{key} = {config[key]!r}: the port computes "
                             f"{want!r} only")
    lc = config["linear_attn_config"]
    if lc["short_conv_kernel_size"] != 4:
        raise ValueError(f"short_conv_kernel_size = "
                         f"{lc['short_conv_kernel_size']}: the port's "
                         "convs have 4 taps")
    if config["qk_nope_head_dim"] != config["v_head_dim"]:
        raise ValueError("qk_nope_head_dim and v_head_dim differ: the "
                         "port's MLA has one head dim for both")
    n = config["num_hidden_layers"]
    kda, full = set(lc["kda_layers"]), set(lc["full_attn_layers"])
    if kda & full or kda | full != set(range(1, n + 1)):
        raise ValueError("kda_layers and full_attn_layers do not split "
                         f"layers 1..{n}")
    from repro_torch.configs import get_config
    from repro_torch.configs.kimi_linear_48b_a3b import block_pattern
    sizes = {field: config[key] for key, field in PORT_FIELDS.items()}
    width, first, held = expert_share(config)
    pattern = block_pattern(n, full_attn=full,
                            dense=config["first_k_dense_replace"])
    return dataclasses.replace(
        get_config(config["port_config"]), **sizes, n_layers=len(pattern),
        block_pattern=pattern, kda_heads=lc["num_heads"],
        kda_head_dim=lc["head_dim"], n_experts=width, experts_held=held,
        first_expert=first, shared_expert_width=config["num_shared_experts"]
        * config["moe_intermediate_size"])


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, mark_window, control: bool = False) -> dict:
    return decode_run(
        config, traffic, seed, seconds, trace, device, mark_window, control,
        cfg=port_config(config), draw=kimi_linear_weights.draw,
        request_flops=request_flops,
        reference=importlib.import_module(
            f"simbench.reference.{config['reference']}"),
        routes=program_routes)
