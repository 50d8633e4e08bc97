"""``Trainer(mesh=...)`` of the port on a 2 x 2 ("data", "model") mesh of
four gloo ranks on the CPU, against the port's one-device trainer and
the reference's trainer on its host mesh.

smollm-135m's smoke config in float32 (4 query heads over 2 KV heads:
the rules cut the query heads on ``model`` and keep the KV heads whole,
so the attention kernel's local_map picks each local head's KV head),
three steps from seed 0 on the synthetic stream.  The four ranks run in
processes of their own (``tests/torch_mesh_workers.py``), one spawn for
the whole file.  Tolerances are ``tests/test_torch_training.py``'s: each
step's loss within ``rtol=1e-4``, every parameter after the steps within
``2.5 * lr`` (Adam moves an entry whose gradient is rounding noise by up
to ±lr on either side).  The checkpoint the mesh wrote restores on one
device bit for bit.  A planted fault, the attention kernel's query
heads declared replicated while the rules cut them, must raise or move
the loss.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import training as jtraining  # noqa: E402
from repro.data import data_iterator as jdata_iterator  # noqa: E402
from repro.distributed.sharding import (BASELINE_RULES,  # noqa: E402
                                        adapt_rules_for, prune_to_mesh)
from repro.launch.mesh import make_host_mesh  # noqa: E402

import torch_mesh_workers as W  # noqa: E402
from repro_torch.data import data_iterator  # noqa: E402
from repro_torch.training import Trainer, checkpoint  # noqa: E402
from repro_torch.training.trainer import abstract_state  # noqa: E402

ARCH = "smollm-135m"
LOSS_RTOL = 1e-4
PARAM_ATOL = 2.5 * W.OPT["lr"]


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _leaves(tree[k], f"{path}/{k}")]
    return [(path, tree)]


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The four ranks' results (their npz files), spawned once."""
    tmp = tmp_path_factory.mktemp("trainer_mesh")
    W.spawn(W.trainer_worker, tmp)
    return tmp, [dict(np.load(tmp / f"rank{r}.npz"))
                 for r in range(W.WORLD)]


@pytest.fixture(scope="module")
def one_device():
    """The port's one-device trainer from the same seed and stream."""
    tr = Trainer(W.smoke_cfg(), W.train_cfg(), device="cpu")
    tr.init(0)
    it = data_iterator(tr.cfg, W.BATCH, W.SEQ, seed=0)
    hist = tr.run(it, W.STEPS)
    it.close()
    return tr, [h["loss"] for h in hist]


def _mesh_params(rank_out):
    return {k[1:].replace(".", "/"): v for k, v in rank_out.items()
            if k.startswith("p.")}


def test_the_rules_cut_the_heads_on_model(mesh_run):
    _, ranks = mesh_run
    assert all(str(r["heads"]) == "model" for r in ranks)


def test_mesh_trainer_matches_the_one_device_trainer(mesh_run, one_device):
    _, ranks = mesh_run
    tr, losses = one_device
    for r in ranks:        # every rank saw the same (global) losses
        np.testing.assert_allclose(r["losses"], losses, rtol=LOSS_RTOL)
    want = dict(_leaves(tr.state["params"]))
    got = _mesh_params(ranks[0])
    assert set(got) == set(want)
    for path, p in want.items():
        d = np.abs(got[path] - p.detach().numpy()).max()
        assert d < PARAM_ATOL, (path, d)
    for r in ranks[1:]:    # and the same full parameters
        for path, p in _mesh_params(r).items():
            np.testing.assert_array_equal(p, got[path], err_msg=path)


def test_mesh_trainer_matches_the_reference_trainer(mesh_run, one_device):
    """The reference's Trainer with the rules of its host mesh, started
    from the port's seed-0 state, on the same stream.  It runs without
    the mesh, as ``repro.launch.train`` runs it: given the host mesh,
    its jitted step fails in this JAX at the embedding gather
    (``ShardingTypeError``, ROADMAP §C.19)."""
    _, ranks = mesh_run
    tr0 = Trainer(W.smoke_cfg(), W.train_cfg(), device="cpu")
    tr0.init(0)
    jcfg = jconfigs.get_smoke(ARCH, dtype="float32")
    mesh = make_host_mesh()
    rules = adapt_rules_for(prune_to_mesh(BASELINE_RULES, mesh), mesh,
                            n_kv=jcfg.n_kv, n_heads=jcfg.n_heads,
                            vocab=jcfg.padded_vocab)
    jt = jtraining.Trainer(jcfg, rules, jtraining.TrainConfig(
        log_every=1, opt=jtraining.OptimizerConfig(**W.OPT)), mesh=None)

    def to_jax(tree):
        if isinstance(tree, dict):
            return {k: to_jax(v) for k, v in tree.items()}
        return jnp.asarray(tree.detach().numpy())
    jt.state = to_jax(tr0.state)
    jhist = jt.run(jdata_iterator(jcfg, W.BATCH, W.SEQ, seed=0), W.STEPS)
    np.testing.assert_allclose(ranks[0]["losses"],
                               [h["loss"] for h in jhist], rtol=LOSS_RTOL)
    got = _mesh_params(ranks[0])
    for path, p in _leaves(jax.tree.map(np.asarray, jt.state["params"])):
        d = np.abs(got[path] - p).max()
        assert d < PARAM_ATOL, (path, d)


@pytest.mark.parametrize("arch", W.FAMILIES)
def test_other_families_on_the_mesh(mesh_run, arch):
    """The moe and ssm families' smoke configs, and smollm's in two
    microbatches, two steps on the 2 x 2 mesh against the one-device
    trainer."""
    _, ranks = mesh_run
    want = W.family_losses(arch)
    for r in ranks:
        np.testing.assert_allclose(r[f"losses_{arch}"], want,
                                   rtol=LOSS_RTOL)


def test_a_mesh_checkpoint_restores_on_one_device(mesh_run):
    tmp, ranks = mesh_run
    ck = str(tmp / "ckpt")
    assert checkpoint.latest_step(ck) == W.STEPS
    back = checkpoint.restore_latest(ck, abstract_state(W.smoke_cfg()))
    assert int(back["step"]) == W.STEPS
    got = _mesh_params(ranks[0])
    for path, p in _leaves(back["params"]):
        np.testing.assert_array_equal(p.numpy(), got[path], err_msg=path)
    tr = Trainer(W.smoke_cfg(), W.train_cfg(ck), device="cpu")
    assert tr.init(0) == W.STEPS
    for (path, a), (_, b) in zip(_leaves(tr.state), _leaves(back)):
        assert torch.equal(a, b), path


def test_heads_declared_replicated_fail(mesh_run, one_device):
    """The planted fault: the attention kernel's local_map told its query
    heads are whole while the rules cut them on ``model``."""
    _, ranks = mesh_run
    _, losses = one_device
    for r in ranks:
        fault = str(r["fault"])
        if not fault:
            assert not np.isclose(float(r["planted_loss"]), losses[0],
                                  rtol=LOSS_RTOL)
        else:
            assert "placements" in fault, fault


def test_train_entry_point_on_a_one_rank_mesh():
    """``launch/train.py --mesh 1x1 --device cpu``: a one-rank gloo group
    started by ``make_host_mesh``; each mesh dim of size 1 replicates, so
    the losses are the one-device entry point's bit for bit."""
    import dataclasses

    from repro_torch.launch import train as tlaunch

    try:
        run = tlaunch.main([
            "--arch", ARCH, "--smoke", "--device", "cpu", "--mesh", "1x1",
            "--steps", str(W.STEPS), "--batch", str(W.BATCH),
            "--seq", str(W.SEQ), "--lr", str(W.OPT["lr"]),
            "--log-every", "1"])
        tr = run["trainer"]
        assert tr.mesh is not None and tr.mesh.size() == 1
        assert dataclasses.asdict(tr.rules)["heads"] == "model"
    finally:
        torch.distributed.destroy_process_group()
    ref = tlaunch.main([
        "--arch", ARCH, "--smoke", "--device", "cpu",
        "--steps", str(W.STEPS), "--batch", str(W.BATCH),
        "--seq", str(W.SEQ), "--lr", str(W.OPT["lr"]), "--log-every", "1"])
    assert [h["loss"] for h in run["history"]] == \
        [h["loss"] for h in ref["history"]]


def test_host_mesh_and_measure_hw_need_a_card_unless_told(monkeypatch):
    from repro_torch.launch.mesh import make_host_mesh, measure_hw
    from repro_torch.runtime import DeviceNotFoundError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceNotFoundError):
        make_host_mesh()
    with pytest.raises(DeviceNotFoundError):
        measure_hw()
