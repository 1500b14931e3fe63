"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig.

Lists only the archs the port can run.  The other ids of the JAX registry
raise and name the ROADMAP.md item that ports them.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig, reduce_config

_ARCH_MODULES: Dict[str, str] = {
    "llama3.1-8b":      "llama3_1_8b",
    "qwen3-4b":         "qwen3_4b",
    "deepseek-v3-16b":  "deepseek_v3_16b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "rwkv6-3b":         "rwkv6_3b",
    "mistral-7b":       "mistral_7b",
    "deepseek-7b":      "deepseek_7b",
    "qwen2.5-32b":      "qwen2_5_32b",
    "nemotron-4-15b":   "nemotron_4_15b",
}

# archs of the JAX registry that a later slice of the port brings, with the
# ROADMAP.md item that brings each
_NOT_YET_PORTED: Dict[str, str] = {
    "grok-1-314b":          "item 13b, the TP-expert layout",
    "hymba-1.5b":           "item 16, the hybrid SSM family",
    "whisper-medium":       "item 18, the encoder-decoder family",
    "llama-3.2-vision-90b": "item 18, the vision family",
}


def get_config(arch: str) -> ModelConfig:
    if arch in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet; see ROADMAP.md "
            f"§1, {_NOT_YET_PORTED[arch]}")
    if arch not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; available: {', '.join(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def get_reduced_config(arch: str) -> ModelConfig:
    return reduce_config(get_config(arch))
