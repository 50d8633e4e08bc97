"""repro_torch.models — the dense and ssm (Mamba-2) language-model
families in torch: config, parameter tables and initialization, layers,
the forward pass, the training loss and the caches (ports of
``repro.models``)."""

from .config import ModelConfig
from .model import (cache_logical_axes, forward, init_caches, init_params,
                    loss_fn, model_defs)
from .params import params_from_jax, state_from_jax

__all__ = ["ModelConfig", "cache_logical_axes", "forward", "init_caches",
           "init_params", "loss_fn", "model_defs", "params_from_jax",
           "state_from_jax"]
