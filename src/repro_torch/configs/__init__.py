"""Config registry: ``full(arch)`` / ``smoke(arch)`` -> ``ModelConfig``,
``skip_shapes(arch)`` -> {shape name: reason}.

Port of ``repro.configs``, every architecture it registers: MLA
(DeepSeek), the attention families (dense GQA / MQA / MHA with sliding
windows, MoE over GQA, a VLM patch prefix), the recurrent ones (Jamba's
hybrid Mamba / GQA / MoE stack, xLSTM) and the encoder-decoder
(whisper-medium, ``models.whisper``).
"""
from __future__ import annotations

import importlib
from typing import Dict

from ..models.common import ModelConfig
from .shapes import SHAPES, Shape

_MODULES: Dict[str, str] = {
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "gemma3-1b": "gemma3_1b",
    "granite-34b": "granite_34b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "starcoder2-7b": "starcoder2_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "xlstm-350m": "xlstm_350m",
    "whisper-medium": "whisper_medium",
    "internvl2-26b": "internvl2_26b",
    "deepseek-v3-671b": "deepseek_v3_671b",     # the paper's Table 1
}

ARCHS = list(_MODULES)


def _load(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"{__name__}.{_MODULES[arch]}")


def full(arch: str) -> ModelConfig:
    return _load(arch).FULL


def smoke(arch: str) -> ModelConfig:
    return _load(arch).SMOKE


def skip_shapes(arch: str) -> dict:
    return _load(arch).SKIP_SHAPES


__all__ = ["ARCHS", "SHAPES", "Shape", "full", "skip_shapes", "smoke"]
