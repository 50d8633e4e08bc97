"""repro_torch.models — the dense and ssm (Mamba-2) language-model
families in torch: config, parameter tables and initialization, layers,
the forward pass, the training loss and the caches (ports of
``repro.models``)."""

from .config import ALL_SHAPES, ModelConfig, ShapeConfig, shapes_for
from .model import (cache_logical_axes, forward, init_caches, init_params,
                    loss_fn, model_defs)
from .params import abstract_params, params_from_jax, state_from_jax

__all__ = ["ALL_SHAPES", "ModelConfig", "ShapeConfig", "abstract_params",
           "cache_logical_axes", "forward", "init_caches", "init_params",
           "loss_fn", "model_defs", "params_from_jax", "shapes_for",
           "state_from_jax"]
