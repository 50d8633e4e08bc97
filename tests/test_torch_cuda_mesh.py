"""``Trainer(mesh=...)`` on the card (marker ``cuda``): chip_smoke's
phase 23 (b) at smollm-135m's smoke config (with heads of 64, a size
the flash kernel is built for).

A (1, 1) ("data", "model") mesh of a one-rank NCCL group
(``make_host_mesh``), the rules ``BASELINE_RULES`` pruned and adapted to
the model, against the one-device ``Trainer`` from the same seed on the
same stream, kernels on: each step's loss within ``1e-5`` relative (on
one device the shards are the whole tensors and the losses have come out
bit for bit equal), and ``rmsnorm`` and ``flash_attention`` launched on
the mesh path.  Skips without a CUDA device and ``nvcc``.

  PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_mesh.py
"""

import dataclasses

import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core.errors import BuildError
from repro_torch.core.nvcc import build_parallel, find_nvcc
from repro_torch.data import data_iterator
from repro_torch.distributed.sharding import rules_for_model
from repro_torch.kernels import KERNELS
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.training import OptimizerConfig, TrainConfig, Trainer

pytestmark = pytest.mark.cuda

LOSS_REL_TOL = 1e-5
STEPS = 3


@pytest.fixture(scope="module")
def mesh():
    """A (1, 1) mesh on the card over a one-rank NCCL group (destroyed
    after the module), the model kernels built; skips without a card or
    nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        find_nvcc()
    except BuildError:
        pytest.skip("needs nvcc")
    build_parallel(k.nvcc_job() for k in KERNELS)
    m = make_host_mesh()
    yield m
    dist.destroy_process_group()


def _run(cfg, tcfg, **kw):
    for k in KERNELS:
        k.launches = 0
    tr = Trainer(cfg, tcfg, **kw)
    tr.init(0)
    it = data_iterator(cfg, 4, 256, seed=0)
    hist = tr.run(it, STEPS)
    it.close()
    return [h["loss"] for h in hist], {k.name: k.launches for k in KERNELS}


def test_mesh_trainer_on_the_card(mesh):
    # heads of 64: the flash kernel is built for 64, 112 and 128
    cfg = dataclasses.replace(configs.get_smoke("smollm-135m"),
                              head_dim=64, remat="block")
    tcfg = TrainConfig(log_every=1, opt=OptimizerConfig(
        lr=3e-4, warmup_steps=STEPS, total_steps=STEPS))
    one, _ = _run(cfg, tcfg)
    sharded, launches = _run(cfg, tcfg, mesh=mesh,
                             rules=rules_for_model(cfg, mesh))
    assert mesh.device_type == "cuda"
    for a, b in zip(sharded, one):
        assert abs(a - b) <= LOSS_REL_TOL * abs(b), (sharded, one)
    assert launches["rmsnorm"] > 0 and launches["flash_attention"] > 0, \
        launches
