"""Architecture registry of the port: one module per architecture.

``get_config(arch)`` returns the exact published config; ``get_smoke(arch)``
returns a reduced same-family config for CPU tests.  The registry lists
the reference's ten architectures, in its order; each module is a copy
of the reference's.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import List

from ..models.config import ModelConfig

_ARCHS = {
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "granite-moe-3b-a800m": "granite_moe",
    "mamba2-780m": "mamba2_780m",
    "whisper-small": "whisper_small",
    "internlm2-20b": "internlm2_20b",
    "granite-34b": "granite_34b",
    "smollm-135m": "smollm_135m",
    "starcoder2-7b": "starcoder2_7b",
    "llama-3.2-vision-11b": "llama32_vision",
    "zamba2-7b": "zamba2_7b",
}

ARCH_IDS: List[str] = list(_ARCHS)


def _module(arch: str):
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"{__name__}.{_ARCHS[arch]}")


def get_config(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cfg.validate()
    return cfg


def get_smoke(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).SMOKE
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cfg.validate()
    return cfg


__all__ = ["ARCH_IDS", "get_config", "get_smoke"]
