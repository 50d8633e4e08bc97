"""repro_torch.training — the train step, AdamW, checkpoints and the
fault-tolerant training loop on one device (ports of ``repro.training``;
the mesh half waits for ROADMAP A.11, ``compression.py`` and
``straggler.py`` for A.9 and A.11)."""

from .optimizer import OptimizerConfig, adamw_update, init_opt_state, \
    lr_schedule, global_norm
from .trainer import (TrainConfig, Trainer, make_train_step, init_state,
                      abstract_state)
from . import checkpoint

__all__ = ["OptimizerConfig", "TrainConfig", "Trainer", "abstract_state",
           "adamw_update", "checkpoint", "global_norm", "init_opt_state",
           "init_state", "lr_schedule", "make_train_step"]
