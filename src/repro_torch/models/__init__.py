"""repro_torch.models — the dense language-model family in torch: config,
parameter tables and initialization, layers, the forward pass and the KV
caches (ports of ``repro.models``)."""

from .config import ModelConfig
from .model import (cache_logical_axes, forward, init_caches, init_params,
                    model_defs)
from .params import params_from_jax

__all__ = ["ModelConfig", "cache_logical_axes", "forward", "init_caches",
           "init_params", "model_defs", "params_from_jax"]
