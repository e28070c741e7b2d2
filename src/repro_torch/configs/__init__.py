"""Assigned-architecture configs.  ``get_config(arch)`` / ``get_reduced(arch)``."""
from __future__ import annotations

import importlib

ARCHS = (
    "codeqwen1_5_7b", "qwen1_5_0_5b", "stablelm_12b", "granite_34b",
    "qwen2_vl_2b", "deepseek_v2_236b", "olmoe_1b_7b", "zamba2_7b",
    "whisper_large_v3", "mamba2_130m",
)

ALIASES = {a.replace("_", "-"): a for a in ARCHS}
ALIASES.update({
    "codeqwen1.5-7b": "codeqwen1_5_7b", "qwen1.5-0.5b": "qwen1_5_0_5b",
    "stablelm-12b": "stablelm_12b", "granite-34b": "granite_34b",
    "qwen2-vl-2b": "qwen2_vl_2b", "deepseek-v2-236b": "deepseek_v2_236b",
    "olmoe-1b-7b": "olmoe_1b_7b", "zamba2-7b": "zamba2_7b",
    "whisper-large-v3": "whisper_large_v3", "mamba2-130m": "mamba2_130m",
})
# port-only configs: found by name, never in ``ARCHS`` (the reference's ten)
ALIASES["deepseek-v2-lite"] = "deepseek_v2_lite"
ALIASES["nemotron-3-nano-30b-a3b"] = "nemotron_3_nano_30b_a3b"
ALIASES["kimi-linear-48b-a3b"] = "kimi_linear_48b_a3b"


def _module(arch: str):
    key = ALIASES.get(arch, arch)
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_reduced(arch: str):
    return _module(arch).reduced()
