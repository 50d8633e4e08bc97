"""Train step + training loop with fault tolerance, on one device or a
mesh.

The port of ``repro.training.trainer``.  The step: the loss and its
gradients through the port's model (``torch.autograd.grad`` of
:func:`repro_torch.models.loss_fn`), microbatched accumulation in
``grad_dtype`` (bfloat16 accumulation is the gradient-compression
trick), and AdamW (:mod:`.optimizer`, in place).  PyTorch runs eagerly,
so there is no jit; the state's tensors are updated in place, as the
reference donates its state to the jitted step.

On a mesh (``Trainer(cfg, tcfg, mesh=..., rules=...)``, a
``torch.distributed`` :class:`DeviceMesh` with ``data`` and ``model``
dims and perhaps ``pod``) the state's tensors are DTensors placed by the
sharding rules (:func:`state_shardings`), each batch is split by
:func:`batch_pspec`, the model constrains its activations by the same
rules and runs its kernels on the local shards.  The gradients reduce as
DTensor's propagation gives them (each redistributed to its parameter's
placements), or, where the mesh has a ``pod`` dim, a gradient still a
partial sum over (pod, data) through
:func:`repro_torch.distributed.collectives.hierarchical_psum`.  AdamW
then runs on the local shards, with the global gradient norm.

Fault tolerance: the loop checkpoints every ``ckpt_every`` steps (atomic
rename), :meth:`Trainer.init` restores the latest checkpoint of
``ckpt_dir``, and an injectable failure hook exercises the restart path
in tests.  Checkpoints hold full tensors whatever the mesh (rank 0
writes them), so one written on a mesh restores on one device and the
other way round.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                      distribute_tensor)

from ..distributed.collectives import hierarchical_psum
from ..distributed.sharding import (ShardingRules, implicit_replication,
                                    logical_to_sharding, rules_for_model)
from ..models import ModelConfig, init_params, loss_fn, model_defs
from ..models.model import torch_dtype
from ..models.params import abstract_params, param_placements
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


def batch_pspec(cfg: ModelConfig, rules: ShardingRules
                ) -> Dict[str, Tuple]:
    """The mesh axes of each batch entry's dims (the reference's
    ``PartitionSpec``s): the batch dim on the rules' ``batch`` axes."""
    out = {"tokens": rules.spec("batch", None),
           "targets": rules.spec("batch", None)}
    if cfg.family == "vlm":
        out["img_embeds"] = rules.spec("batch", None, None)
    if cfg.family == "encdec":
        out["frames"] = rules.spec("batch", None, None)
    return out


def batch_placements(cfg: ModelConfig, mesh, rules: ShardingRules):
    """Each batch entry's DTensor placements on ``mesh``."""
    return {k: logical_to_sharding(mesh, rules, ("batch",)
                                   + (None,) * (len(v) - 1))
            for k, v in batch_pspec(cfg, rules).items()}


def state_shardings(cfg: ModelConfig, mesh, rules: ShardingRules):
    """The state's DTensor placements: each parameter's by its logical
    axes, the AdamW moments as their parameters, the step replicated."""
    pl = param_placements(model_defs(cfg), mesh, rules)
    return {"params": pl, "opt": {"m": pl, "v": pl},
            "step": [Replicate()] * mesh.ndim}


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _full(t):
    t = t.detach()
    return t.full_tensor() if isinstance(t, DTensor) else t


def _reduce_grads(grads, params, mesh):
    """Each gradient on its parameter's placements.  A gradient still a
    partial sum over both 'pod' and 'data' is summed there through
    :func:`hierarchical_psum` first; DTensor's redistribution reduces
    the rest."""
    names = mesh.mesh_dim_names
    hier = [names.index(a) for a in ("pod", "data") if a in names] \
        if "pod" in names else []

    def one(g, p):
        if hier and all(isinstance(g.placements[i], Partial) for i in hier):
            pl = [Replicate() if i in hier else q
                  for i, q in enumerate(g.placements)]
            g = DTensor.from_local(hierarchical_psum(g.to_local(), mesh),
                                   mesh, pl, run_check=False,
                                   shape=g.shape, stride=g.stride())
        return g.redistribute(mesh, p.placements)
    return tree_map(one, grads, params)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    rules: Optional[ShardingRules] = None):
    """Returns step(state, batch) -> (state, metrics).  ``batch`` holds
    ``tokens`` and ``targets`` (B, S) integer tensors on the state's
    device; the state's parameters and moments are updated in place.
    With ``rules`` the state and batch may be DTensors on a mesh
    (:class:`Trainer` places them); the model constrains its
    activations by the rules."""
    ocfg = tcfg.opt
    nmb = tcfg.num_microbatches

    def grads_of(params, batch):
        leaves = leaves_with_paths(params)
        for _, p in leaves:
            p.requires_grad_(True)
        loss, metrics = loss_fn(params, batch, cfg, rules=rules)
        grads = torch.autograd.grad(loss, [p for _, p in leaves])
        grads = unflatten(params, {path: g for (path, _), g
                                   in zip(leaves, grads)})
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def step(state, batch):
        params = state["params"]
        sharded = isinstance(next(iter(batch.values())), DTensor)
        with implicit_replication() if sharded else contextlib.nullcontext():
            loss, metrics, grads = accumulate(params, batch)
        if sharded:
            mesh = next(iter(batch.values())).device_mesh
            grads = _reduce_grads(grads, params, mesh)
            # AdamW on the local shards, with the norm of the whole
            # gradient
            gnorm = torch.sqrt(torch.sum(torch.stack([
                _full(torch.sum(torch.square(g.to(torch.float32))))
                for _, g in leaves_with_paths(grads)])))
            with torch.no_grad():
                local = [tree_map(_local, t)
                         for t in (params, grads, state["opt"])]
            _, _, opt_metrics = adamw_update(ocfg, *local, state["step"],
                                             gnorm=gnorm)
            metrics = {k: _full(v) for k, v in metrics.items()}
            loss = _full(loss)
        else:
            _, _, opt_metrics = adamw_update(
                ocfg, params, grads, state["opt"], state["step"])
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return {"params": params, "opt": state["opt"],
                "step": state["step"] + 1}, metrics

    def accumulate(params, batch):
        if nmb == 1:
            return grads_of(params, batch)
        # microbatch accumulation: the leading batch dim in nmb slices
        # (of each rank's shard, on a mesh), the gradients summed in
        # grad_dtype
        gdt = torch_dtype(ocfg.grad_dtype)
        acc = {path: torch.zeros_like(p, dtype=gdt)
               for path, p in leaves_with_paths(params)}
        dev = _local(next(iter(acc.values()))).device
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(nmb):
            mb = {k: _microbatch(v, i, nmb) for k, v in batch.items()}
            mloss, mmetrics, grads = grads_of(params, mb)
            for path, g in leaves_with_paths(grads):
                acc[path] = acc[path] + g.to(gdt)
            loss = loss + mloss
            aux = aux + mmetrics["aux"]
        grads = unflatten(params, {k: (a / nmb).to(torch.float32)
                                   for k, a in acc.items()})
        loss = loss / nmb
        return loss, {"ce": loss, "aux": aux / nmb,
                      "ppl": torch.exp(torch.clamp(loss, max=20.0))}, grads

    return step


def _microbatch(v, i: int, nmb: int):
    """Slice i of nmb of ``v``'s batch dim: of its local shard for a
    DTensor (each rank's share of every microbatch is its own)."""
    if isinstance(v, DTensor):
        loc = v.to_local()
        n = loc.shape[0] // nmb
        return DTensor.from_local(loc[i * n:(i + 1) * n], v.device_mesh,
                                  v.placements, run_check=False)
    n = v.shape[0] // nmb
    return v[i * n:(i + 1) * n]


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
    def tree():
        return abstract_params(model_defs(cfg), torch_dtype(cfg.param_dtype))
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
    one device, the first CUDA device unless ``device`` names another, or
    on ``mesh`` (a :class:`DeviceMesh` with ``data`` and ``model`` dims,
    perhaps ``pod``), its state placed by ``rules`` (by default
    :data:`~repro_torch.distributed.sharding.BASELINE_RULES` pruned to
    the mesh and adapted to the model).  On a mesh every rank of the
    mesh's process group runs the same calls with the same data."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                 device: Union[str, torch.device, None] = None,
                 rules: Optional[ShardingRules] = None):
        self.cfg, self.tcfg, self.mesh = cfg, tcfg, mesh
        if mesh is not None:
            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"Trainer: mesh must be a torch.distributed "
                                f"DeviceMesh, got {type(mesh).__name__}")
            mdev = torch.device("cuda", torch.cuda.current_device()) \
                if mesh.device_type == "cuda" else torch.device("cpu")
            if device is not None and torch.device(device).type != mdev.type:
                raise ValueError(f"Trainer: device {device} is not the "
                                 f"mesh's {mesh.device_type}")
            self.device = mdev
            self.rules = rules if rules is not None \
                else rules_for_model(cfg, mesh)
        else:
            self.device = torch.device(device) if device is not None \
                else default_device()
            self.rules = rules
        self.step_fn = make_train_step(cfg, tcfg, self.rules)
        self.state = None
        #: host seconds of each step of the last :meth:`run`, the device
        #: synchronized at both ends
        self.step_seconds: List[float] = []

    def _place(self, state):
        """A state of full tensors on this rank's device, placed on the
        mesh by the rules (as it is, without a mesh)."""
        if self.mesh is None:
            return state
        sh = state_shardings(self.cfg, self.mesh, self.rules)
        return {"params": tree_map(self._distribute, state["params"],
                                   sh["params"]),
                "opt": tree_map(self._distribute, state["opt"], sh["opt"]),
                "step": state["step"]}

    def _distribute(self, t, placements):
        # every rank holds the same full tensor: each keeps its shard
        return distribute_tensor(t.to(self.device), self.mesh, placements,
                                 src_data_rank=None)

    def init(self, seed: int = 0) -> int:
        restored = None
        if self.tcfg.ckpt_dir:
            restored = ckpt.restore_latest(self.tcfg.ckpt_dir,
                                           abstract_state(self.cfg),
                                           device=self.device)
        self.state = self._place(restored if restored is not None
                                 else init_state(self.cfg, seed, self.device))
        return int(self.state["step"])

    def full_state(self):
        """The state as full tensors (on a mesh a collective: every rank
        calls it)."""
        return tree_map(_full, self.state)

    def _save(self) -> None:
        state = self.full_state()
        if self.mesh is None or dist.get_rank() == 0:
            ckpt.save(self.tcfg.ckpt_dir, state, keep=self.tcfg.keep_ckpts)
        if self.mesh is not None:
            dist.barrier()

    def _batch(self, batch) -> Dict[str, torch.Tensor]:
        """The batch on the device: token ids as int64, the auxiliary
        embeddings (``img_embeds``, ``frames``) in their float dtype; on
        a mesh, split by :func:`batch_pspec`."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v))
            out[k] = t.to(self.device, torch.int64 if not
                          t.is_floating_point() else t.dtype)
        if self.mesh is not None:
            pl = batch_placements(self.cfg, self.mesh, self.rules)
            out = {k: self._distribute(v, pl[k]) for k, v in out.items()}
        return out

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
                self._save()
            if (step_no + 1) % self.tcfg.log_every == 0 or not history:
                history.append({k: float(v) for k, v in metrics.items()})
        return history


__all__ = ["TrainConfig", "Trainer", "abstract_state", "batch_placements",
           "batch_pspec", "init_state", "make_train_step", "state_shardings"]
