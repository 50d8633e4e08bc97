"""Serving with sharding rules (``ServingEngine``, ``TorchExecutor`` and
``ServingMesh`` take ``rules`` as the reference's do) on the CPU.

smollm-135m's smoke config, weights from seed 0, 4 requests on 2 slots:
the engine with ``DECODE_RULES`` and no mesh, and the engine whose
parameters and KV caches are DTensors on a one-rank gloo (1, 1) mesh
placed by them, must give the plain engine's streams token for token
(greedy decode; on one device every placement is the whole tensor).  A
mesh of several devices is refused: caches cut over devices wait for
ROADMAP A.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.distributed.sharding import DECODE_RULES, rules_for_model
from repro_torch.launch.mesh import fake_mesh, make_host_mesh
from repro_torch.models import init_params
from repro_torch.runtime import Context, Platform
from repro_torch.serving import Request, ServingEngine, ServingMesh
from repro_torch.serving.executor import TorchExecutor

PROMPTS = (5, 9, 17, 3)
BUDGETS = (6, 4, 5, 7)


@pytest.fixture(scope="module")
def model():
    cfg = configs.get_smoke("smollm-135m")
    return cfg, init_params(cfg, torch.Generator().manual_seed(0))


def _serve(cfg, params, **kw):
    rng = np.random.default_rng(0)
    eng = ServingEngine(cfg, params, batch_slots=2, max_seq=64,
                        context=Context(platform=Platform(torch_device="cpu")),
                        **kw)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, n), max_new_tokens=m)
            for n, m in zip(PROMPTS, BUDGETS)]
    eng.generate(reqs)
    assert all(r.done for r in reqs), [r.error for r in reqs]
    return eng, [list(r.out_tokens) for r in reqs]


def test_rules_without_a_mesh_change_nothing(model):
    cfg, params = model
    _, plain = _serve(cfg, params)
    eng, ruled = _serve(cfg, params, rules=DECODE_RULES)
    assert eng.rules is DECODE_RULES and eng._exec.rules is DECODE_RULES
    assert ruled == plain


def test_engine_on_a_one_device_mesh(model):
    cfg, params = model
    _, plain = _serve(cfg, params)
    if dist.is_initialized():
        dist.destroy_process_group()
    try:
        mesh = make_host_mesh(device="cpu")
        eng, streams = _serve(cfg, params, mesh=mesh,
                              rules=rules_for_model(cfg, mesh, DECODE_RULES))
        ex = eng._exec
        assert ex.mesh is mesh and ex.rules.cache_seq == "model"
        assert type(ex.params["embed"]).__name__ == "DTensor"
        # the executor's default rules, when given none: DECODE_RULES
        assert TorchExecutor(cfg, params, 2, 64, mesh=mesh).rules == \
            rules_for_model(cfg, mesh, DECODE_RULES)
    finally:
        dist.destroy_process_group()
    assert streams == plain


def test_a_mesh_of_several_devices_is_refused(model):
    cfg, params = model
    if dist.is_initialized():
        dist.destroy_process_group()
    try:
        mesh = fake_mesh((2, 2), ("data", "model"))
        with pytest.raises(NotImplementedError, match="ROADMAP A"):
            TorchExecutor(cfg, params, 2, 64, mesh=mesh)
    finally:
        dist.destroy_process_group()


def test_serving_mesh_hands_rules_to_its_replicas(model):
    cfg, params = model
    plat = Platform(torch_device="cpu")
    m = ServingMesh(cfg, params, n_replicas=2, batch_slots=2, max_seq=32,
                    platform=plat, rules=[DECODE_RULES, None])
    assert [r.engine.rules for r in m.replicas] == [DECODE_RULES, None]
    with pytest.raises(Exception, match="3 sharding rules for 2"):
        ServingMesh(cfg, params, n_replicas=2, batch_slots=2, max_seq=32,
                    platform=plat, rules=[DECODE_RULES] * 3)
