"""Architecture registry: ``--arch <id>`` -> exact published config."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen2-0.5b": "qwen2_0_5b",
    "minicpm-2b": "minicpm_2b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "stablelm-12b": "stablelm_12b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "zamba2-1.2b": "zamba2_1_2b",
    "whisper-tiny": "whisper_tiny",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "qwen2-vl-7b": "qwen2_vl_7b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG
