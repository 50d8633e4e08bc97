"""Architecture registry of the port: one module per architecture.

``get_config(arch)`` returns the exact published config; ``get_smoke(arch)``
returns a reduced same-family config for CPU tests.  The port runs the
dense family only so far, so the registry lists ``smollm-135m`` alone;
the reference's other architectures wait for their model families
(ROADMAP A.8) and raise ``KeyError`` saying so.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import List

from ..models.config import ModelConfig

_ARCHS = {
    "smollm-135m": "smollm_135m",
}

#: the reference's other architectures, not ported yet (ROADMAP A.8)
_WAITING = ("phi3.5-moe-42b-a6.6b", "granite-moe-3b-a800m", "mamba2-780m",
            "whisper-small", "internlm2-20b", "granite-34b", "starcoder2-7b",
            "llama-3.2-vision-11b", "zamba2-7b")

ARCH_IDS: List[str] = list(_ARCHS)


def _module(arch: str):
    if arch not in _ARCHS:
        why = ("its model family is not ported yet (ROADMAP A.8)"
               if arch in _WAITING else "unknown arch")
        raise KeyError(f"{arch!r}: {why}; ported: {ARCH_IDS}")
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
