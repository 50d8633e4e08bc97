"""Train step + training loop with fault tolerance, on one device.

The port of ``repro.training.trainer``.  The step: the loss and its
gradients through the port's model (``torch.autograd.grad`` of
:func:`repro_torch.models.loss_fn`), microbatched accumulation in
``grad_dtype`` (bfloat16 accumulation is the gradient-compression
trick), and AdamW (:mod:`.optimizer`, in place).  PyTorch runs eagerly,
so there is no jit; the state's tensors are updated in place, as the
reference donates its state to the jitted step.

Fault tolerance: the loop checkpoints every ``ckpt_every`` steps (atomic
rename), :meth:`Trainer.init` restores the latest checkpoint of
``ckpt_dir``, and an injectable failure hook exercises the restart path
in tests.

The mesh half of the reference (``state_shardings``, ``batch_pspec``
and ``Trainer(mesh=...)``) waits for the distribution port (ROADMAP
A.11); passing a mesh raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..models import ModelConfig, init_params, loss_fn, model_defs
from ..models.model import torch_dtype
from ..runtime import DeviceNotFoundError
from . import checkpoint as ckpt
from .optimizer import OptimizerConfig, adamw_update, init_opt_state
from .tree import leaves_with_paths, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_microbatches: int = 1
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    log_every: int = 10
    opt: OptimizerConfig = OptimizerConfig()


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns step(state, batch) -> (state, metrics).  ``batch`` holds
    ``tokens`` and ``targets`` (B, S) integer tensors on the state's
    device; the state's parameters and moments are updated in place."""
    ocfg = tcfg.opt
    nmb = tcfg.num_microbatches

    def grads_of(params, batch):
        leaves = leaves_with_paths(params)
        for _, p in leaves:
            p.requires_grad_(True)
        loss, metrics = loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, [p for _, p in leaves])
        grads = unflatten(params, {path: g for (path, _), g
                                   in zip(leaves, grads)})
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def step(state, batch):
        params = state["params"]
        if nmb == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            # microbatch accumulation: the leading batch dim in nmb
            # slices, the gradients summed in grad_dtype
            gdt = torch_dtype(ocfg.grad_dtype)
            n = next(iter(batch.values())).shape[0] // nmb
            acc = {path: torch.zeros(p.shape, dtype=gdt, device=p.device)
                   for path, p in leaves_with_paths(params)}
            dev = next(iter(acc.values())).device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            aux = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(nmb):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                mloss, mmetrics, grads = grads_of(params, mb)
                for path, g in leaves_with_paths(grads):
                    acc[path] = acc[path] + g.to(gdt)
                loss = loss + mloss
                aux = aux + mmetrics["aux"]
            grads = unflatten(params, {k: (a / nmb).to(torch.float32)
                                       for k, a in acc.items()})
            loss = loss / nmb
            metrics = {"ce": loss, "aux": aux / nmb,
                       "ppl": torch.exp(torch.clamp(loss, max=20.0))}

        new_params, new_opt, opt_metrics = adamw_update(
            ocfg, params, grads, state["opt"], state["step"])
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    return step


def init_state(cfg: ModelConfig, seed: int = 0,
               device: Union[str, torch.device] = "cpu"):
    """Parameters from ``seed`` (:func:`repro_torch.models.init_params`),
    zero moments and step 0, on ``device``."""
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device=device)
    return {"params": params, "opt": init_opt_state(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_state(cfg: ModelConfig):
    """The state's structure, dtypes and shapes, on the ``meta`` device
    (the template a checkpoint is restored into)."""
    dt = torch_dtype(cfg.param_dtype)

    def tree():
        return tree_map(lambda d: torch.empty(d.shape, dtype=dt,
                                              device="meta"),
                        model_defs(cfg))
    return {"params": tree(), "opt": {"m": tree(), "v": tree()},
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def default_device() -> torch.device:
    """The first CUDA device; :class:`DeviceNotFoundError` without one."""
    if not torch.cuda.is_available():
        raise DeviceNotFoundError(
            "no CUDA device: the trainer runs on the card unless a device "
            "is given (device='cpu' for tests)")
    return torch.device("cuda", 0)


class Trainer:
    """Orchestrates the step + checkpoint/restore + failure recovery on
    one device: the first CUDA device unless ``device`` names another."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                 device: Union[str, torch.device, None] = None):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...): sharded training waits for the "
                "distribution port (ROADMAP A.11)")
        self.cfg, self.tcfg = cfg, tcfg
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.step_fn = make_train_step(cfg, tcfg)
        self.state = None
        #: host seconds of each step of the last :meth:`run`, the device
        #: synchronized at both ends
        self.step_seconds: List[float] = []

    def init(self, seed: int = 0) -> int:
        restored = None
        if self.tcfg.ckpt_dir:
            restored = ckpt.restore_latest(self.tcfg.ckpt_dir,
                                           abstract_state(self.cfg),
                                           device=self.device)
        self.state = restored if restored is not None \
            else init_state(self.cfg, seed, self.device)
        return int(self.state["step"])

    def _batch(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device,
                                                     torch.int64)
                for k, v in batch.items()}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, data_iter, num_steps: int,
            failure_hook: Optional[Callable[[int], None]] = None):
        """Train for num_steps batches.  ``failure_hook(step)`` may raise
        to simulate a node failure; the caller restarts via ``init()``."""
        assert self.state is not None, "call init() first"
        history = []
        self.step_seconds = []
        for _ in range(num_steps):
            batch = self._batch(next(data_iter))
            step_no = int(self.state["step"])
            if failure_hook is not None:
                failure_hook(step_no)
            self._sync()
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            self._sync()
            self.step_seconds.append(time.perf_counter() - t0)
            if self.tcfg.ckpt_dir and \
                    (step_no + 1) % self.tcfg.ckpt_every == 0:
                ckpt.save(self.tcfg.ckpt_dir, self.state,
                          keep=self.tcfg.keep_ckpts)
            if (step_no + 1) % self.tcfg.log_every == 0 or not history:
                history.append({k: float(v) for k, v in metrics.items()})
        return history


__all__ = ["TrainConfig", "Trainer", "abstract_state", "init_state",
           "make_train_step"]
