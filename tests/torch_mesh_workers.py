"""Worker processes of the port's mesh tests: four gloo ranks on the CPU.

``tests/test_torch_collectives.py`` and
``tests/test_torch_trainer_mesh.py`` start the workers here through
:func:`spawn` (``torch.multiprocessing``, the ``spawn`` start method),
one process group each, rendezvous through a file under the test's
``tmp_path`` so parallel test workers never collide on a port.  Each
rank writes what it found to ``<tmp_path>/rank<r>.npz`` for the test to
check.  This module imports no JAX: the workers run the port only.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


def spawn(fn, tmp_path, timeout: float = 180.0) -> None:
    """Run ``fn(rank, tmp_path)`` on :data:`WORLD` spawned ranks; raise
    if one fails or they have not all joined within ``timeout`` seconds
    (the stragglers are killed)."""
    ctx = mp.start_processes(fn, args=(str(tmp_path),),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{WORLD} ranks did not join within "
                               f"{timeout} s")


def _init(rank: int, tmp_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=rank, world_size=WORLD)


def _save(tmp_path: str, rank: int, **arrays) -> None:
    np.savez(os.path.join(tmp_path, f"rank{rank}.npz"), **arrays)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def collectives_worker(rank: int, tmp_path: str) -> None:
    """hierarchical_psum on (pod 2, data 2, model 1) and on (data 4,
    model 1), and hierarchical_grad_reduce, on integer-valued float32
    values that differ by rank."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.collectives import (
        hierarchical_grad_reduce, hierarchical_psum)

    _init(rank, tmp_path)
    try:
        pod = init_device_mesh("cpu", (2, 2, 1),
                               mesh_dim_names=("pod", "data", "model"))
        flat = init_device_mesh("cpu", (4, 1),
                                mesh_dim_names=("data", "model"))
        gen = torch.Generator().manual_seed(rank)
        tree = {"w": torch.randint(-50, 50, (7, 5), generator=gen)
                .to(torch.float32),
                "b": {"odd": torch.randint(-9, 9, (13,), generator=gen)
                      .to(torch.float32)}}
        want = {k: v.clone() for k, v in
                {"w": tree["w"], "odd": tree["b"]["odd"]}.items()}
        for k in want:
            dist.all_reduce(want[k])
        got = hierarchical_psum(tree, pod)
        got_flat = hierarchical_psum(tree, flat)
        reduced = hierarchical_grad_reduce(
            lambda params, batch: {"g": params["x"] * batch}, pod)(
                {"x": torch.arange(6, dtype=torch.float32)},
                torch.tensor(float(rank + 1)))
        # the trainer's reduction: a gradient that is a partial sum over
        # (pod, data) beside a replicated parameter, and one already
        # placed as its (data-cut) parameter
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        from repro_torch.training.trainer import _reduce_grads
        part = DTensor.from_local(tree["w"], pod,
                                  [Partial(), Partial(), Replicate()])
        rep = DTensor.from_local(torch.zeros(7, 5), pod, [Replicate()] * 3)
        cut = DTensor.from_local(tree["w"][:, :2], pod,
                                 [Replicate(), Shard(1), Replicate()],
                                 run_check=False, shape=(7, 4),
                                 stride=(4, 1))
        trainer_grads = _reduce_grads({"p": part, "c": cut},
                                      {"p": rep, "c": cut}, pod)
        _save(tmp_path, rank, mine_w=tree["w"].numpy(),
              want_w=want["w"].numpy(), want_odd=want["odd"].numpy(),
              pod_w=got["w"].numpy(), pod_odd=got["b"]["odd"].numpy(),
              flat_w=got_flat["w"].numpy(),
              flat_odd=got_flat["b"]["odd"].numpy(),
              grad=reduced["g"].numpy(),
              trainer_p=trainer_grads["p"].to_local().numpy(),
              trainer_p_placements=str(trainer_grads["p"].placements),
              trainer_c=trainer_grads["c"].full_tensor().numpy())
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the trainer on a 2 x 2 mesh
# ---------------------------------------------------------------------------

STEPS = 3
BATCH, SEQ = 4, 16
#: the optimizer of ``tests/test_torch_training.py``'s trainer comparison
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def smoke_cfg():
    """smollm-135m's smoke config in float32, kernels on (their plain
    versions on the CPU), as the training tests run it."""
    from repro_torch import configs
    return dataclasses.replace(configs.get_smoke("smollm-135m"),
                               dtype="float32")


def train_cfg(ckpt_dir=None):
    from repro_torch.training import OptimizerConfig, TrainConfig
    return TrainConfig(log_every=1, ckpt_dir=ckpt_dir, ckpt_every=STEPS,
                       opt=OptimizerConfig(**OPT))


def _planted_heads_replicated(ops):
    """``ops.kernel_placements`` with the attention kernel's query heads
    declared replicated: the rules cut them on ``model``."""
    from torch.distributed.tensor import Replicate, Shard

    real = ops.kernel_placements

    def planted(kernel, mesh, rules):
        pl = real(kernel, mesh, rules)
        if kernel == "attention":
            pl[0] = [Replicate() if isinstance(p, Shard) and p.dim == 1
                     else p for p in pl[0]]
        return pl
    return planted


def trainer_worker(rank: int, tmp_path: str) -> None:
    """Trainer(mesh=2x2) for STEPS steps from seed 0 on the synthetic
    stream: its losses and full parameters, a checkpoint written at the
    last step, then one step with the planted placement fault."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.data import data_iterator
    from repro_torch.distributed.sharding import rules_for_model
    from repro_torch.kernels import ops
    from repro_torch.training import Trainer

    _init(rank, tmp_path)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        cfg = smoke_cfg()
        rules = rules_for_model(cfg, mesh)
        tr = Trainer(cfg, train_cfg(os.path.join(tmp_path, "ckpt")),
                     mesh=mesh, rules=rules)
        tr.init(0)
        it = data_iterator(cfg, BATCH, SEQ, seed=0)
        hist = tr.run(it, STEPS)
        it.close()
        full = tr.full_state()
        leaves = {"p" + path.replace("/", "."): t.numpy() for path, t in
                  _leaves(full["params"])}

        real_placements = ops.kernel_placements
        ops.kernel_placements = _planted_heads_replicated(ops)
        fault = ""
        planted_loss = np.nan
        bad = Trainer(cfg, train_cfg(), mesh=mesh, rules=rules)
        bad.init(0)
        it = data_iterator(cfg, BATCH, SEQ, seed=0)
        try:
            planted_loss = bad.run(it, 1)[0]["loss"]
        except (ValueError, RuntimeError) as e:
            fault = f"{type(e).__name__}: ...{str(e)[-400:]}"
        it.close()
        ops.kernel_placements = real_placements
        family = {f"losses_{arch}": np.array(family_losses(arch, mesh))
                  for arch in FAMILIES}
        _save(tmp_path, rank, losses=np.array([h["loss"] for h in hist]),
              heads=str(rules.heads), planted_loss=planted_loss,
              fault=fault, **leaves, **family)
    finally:
        dist.destroy_process_group()


#: the other families' paths on the mesh (the MoE's grouping, expert FFN
#: and combine; Mamba-2's conv, scan and gated norm), and smollm in two
#: microbatches (each rank's share of each)
FAMILIES = ("granite-moe-3b-a800m", "mamba2-780m", "smollm-135m/2")
FAMILY_STEPS = 2


def family_losses(arch, mesh=None):
    """FAMILY_STEPS steps of ``arch``'s smoke config in float32 from
    seed 0 (``arch/n``: in n microbatches), on ``mesh`` (its rules
    adapted) or on the CPU."""
    from repro_torch import configs
    from repro_torch.data import data_iterator
    from repro_torch.distributed.sharding import rules_for_model
    from repro_torch.training import Trainer

    arch, _, nmb = arch.partition("/")
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
    kw = dict(mesh=mesh, rules=rules_for_model(cfg, mesh)) if mesh \
        else dict(device="cpu")
    tcfg = dataclasses.replace(train_cfg(), num_microbatches=int(nmb or 1))
    tr = Trainer(cfg, tcfg, **kw)
    tr.init(0)
    it = data_iterator(cfg, BATCH, SEQ, seed=0)
    hist = tr.run(it, FAMILY_STEPS)
    it.close()
    return [h["loss"] for h in hist]


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _leaves(tree[k], f"{path}/{k}")]
    return [(path, tree)]
