"""repro_torch.training — the train step, AdamW, checkpoints, the
fault-tolerant training loop on one device or a mesh, error-feedback
gradient compression and the straggler monitor (ports of
``repro.training``)."""

from .optimizer import OptimizerConfig, adamw_update, init_opt_state, \
    lr_schedule, global_norm
from .trainer import (TrainConfig, Trainer, make_train_step, init_state,
                      abstract_state, batch_pspec, state_shardings)
from .compression import (compress, compress_grads, decompress,
                          decompress_grads, init_feedback)
from .straggler import StragglerConfig, StragglerMonitor, plan_elastic_mesh
from . import checkpoint, compression, straggler

__all__ = ["OptimizerConfig", "StragglerConfig", "StragglerMonitor",
           "TrainConfig", "Trainer", "abstract_state", "adamw_update",
           "batch_pspec",
           "checkpoint", "compress", "compress_grads", "compression",
           "decompress", "decompress_grads", "global_norm", "init_feedback",
           "init_opt_state", "init_state", "lr_schedule", "make_train_step",
           "plan_elastic_mesh", "state_shardings", "straggler"]
