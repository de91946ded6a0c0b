"""Config registry: ``full(arch)`` / ``smoke(arch)`` -> ``ModelConfig``.

Port of ``repro.configs``.  Only the architectures the port can serve are
registered; the other families' configs come with their model code.
"""
from __future__ import annotations

import importlib
from typing import Dict

from ..models.common import ModelConfig

_MODULES: Dict[str, str] = {
    "deepseek-v2-236b": "deepseek_v2_236b",
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
