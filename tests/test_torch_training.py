"""The port's training path (``repro_torch.training``, ``models.loss_fn``,
``data``, ``launch.train``) on the CPU, held against the reference.

The reference's parameters and train state come across as numpy arrays
(``params_from_jax``, ``state_from_jax``), the batches are the synthetic
stream's, and both packages run the same step.  The model is smollm-135m
at its smoke config in float32, where the two frameworks differ in
summation order and the last ulp of ``exp``/``sin``/``cos`` only.
Tolerances, and why:

* the loss within ``rtol=1e-5``, and every gradient leaf within
  ``rtol=1e-4, atol=1e-6`` of the largest entry of that leaf: a leaf's
  gradient sums over every token of the batch in another order on each
  side, and entries near zero carry that rounding at the leaf's scale.
* the optimizer's float32 arithmetic within ``rtol=1e-6``: the same
  operations in the same order, with ``pow`` and ``cos`` allowed an ulp.
* parameters after trainer steps within ``2.5 * lr``, absolute: Adam's
  first update is lr · m̂ / (√v̂ + eps), about ±lr for any nonzero
  gradient, so an entry whose gradient is rounding noise on both sides
  can move by up to 2 · lr in opposite directions (the reference's own
  microbatch test uses the same bound); every other entry agrees far
  more closely, which the loss histories show.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import data_iterator as jdata_iterator  # noqa: E402
from repro.data import synth_batch as jsynth_batch  # noqa: E402
from repro.distributed.sharding import BASELINE_RULES  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402
from repro import training as jtraining  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import data_iterator, synth_batch  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import (forward, loss_fn, params_from_jax,  # noqa: E402
                                state_from_jax)
from repro_torch.runtime import DeviceNotFoundError  # noqa: E402
from repro_torch.training import (OptimizerConfig, TrainConfig,  # noqa: E402
                                  Trainer, adamw_update, checkpoint,
                                  global_norm, init_opt_state, init_state,
                                  lr_schedule, make_train_step)
from repro_torch.training.trainer import abstract_state  # noqa: E402

ARCH = "smollm-135m"
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-6
OPT_RTOL = 1e-6


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _leaves(tree[k], f"{path}/{k}")]
    return [(path, tree)]


def _cfgs(**over):
    """The reference's and the port's smoke configs in float32;
    ``use_kernels`` goes to the port only (the reference trains with
    ``use_pallas=False``)."""
    kernels = over.pop("use_kernels", True)
    jcfg = jconfigs.get_smoke(ARCH, dtype="float32", **over)
    tcfg = tconfigs.get_smoke(ARCH, dtype="float32", use_kernels=kernels,
                              **over)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jparams(seed=0):
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, jinit_params(jcfg, jax.random.PRNGKey(seed)))


@functools.lru_cache(maxsize=None)
def _jvalue_and_grad(remat, streaming):
    """The reference's jitted ``value_and_grad(loss_fn)``, one per
    (remat, streaming) — shared by the kernel settings."""
    jcfg, _ = _cfgs(remat=remat, use_streaming_ce=streaming, ce_chunk=128)
    return jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(p, b, jcfg, BASELINE_RULES), has_aux=True))


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the model: loss, gradients, the no-cache forward's kernel branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernels,remat,streaming", [
    (True, "none", False), (True, "block", False), (True, "dots", False),
    (True, "block", True), (False, "block", False), (False, "none", True),
])
def test_loss_and_gradients_match_reference(kernels, remat, streaming):
    """``loss_fn``'s value, metrics and every gradient leaf against
    ``jax.value_and_grad`` of the reference's ``loss_fn``
    (``use_pallas=False``).  With kernels the attention is the flash
    kernel's plain version under ``FlashAttention``'s blocked backward
    and the norms are the rmsnorm ``autograd.Function``.  Each setting
    of each switch is covered, every remat mode with the kernels (the
    path the card trains on), the streaming CE with and without them."""
    _, tcfg = _cfgs(use_kernels=kernels, remat=remat,
                    use_streaming_ce=streaming, ce_chunk=128)
    jp = _jparams()
    batch = synth_batch(tcfg, 2, 12, step=3, seed=1)
    (jloss, jm), jg = _jvalue_and_grad(remat, streaming)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})

    tp = params_from_jax(jp, tcfg)
    leaves = _leaves(tp)
    for _, p in leaves:
        p.requires_grad_(True)
    loss, metrics = loss_fn(tp, _torch_batch(batch), tcfg)
    grads = torch.autograd.grad(loss, [p for _, p in leaves])

    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    for k in ("ce", "aux", "ppl"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    jleaves = dict(_leaves(jax.tree.map(np.asarray, jg)))
    assert set(jleaves) == {path for path, _ in leaves}
    for (path, _), g in zip(leaves, grads):
        want = np.asarray(jleaves[path], np.float32)
        scale = float(np.abs(want).max())
        assert scale > 0, path
        np.testing.assert_allclose(_np(g), want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * scale, err_msg=path)


def _c2_layout_fault(real):
    """``ops.attention`` as the unrepaired call site used it: q/k/v in
    the model's (B, S, H, D) layout handed to the kernel as if they were
    (B, H, S, D), and its output read back as (B, S, H, D)."""
    def faulty(q, k, v, **kw):
        return real(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    **kw).transpose(1, 2)
    return faulty


def test_reference_layout_on_the_kernel_branch_fails_the_check(monkeypatch):
    """A planted fault (ROADMAP §C.2): the no-cache forward with the
    reference's (B, S, H, D) layout handed to the flash kernel must fail
    the comparison with the reference's ``use_pallas=False`` forward that
    the repaired layout passes (``tests/test_torch_models.py``).  The
    reference's own ``use_pallas=True`` forward carries the fault and
    fails it too, which is why the port is not held to it."""
    jcfg, tcfg = _cfgs()
    jp = _jparams()
    tp = params_from_jax(jp, tcfg)
    toks = np.random.default_rng(2).integers(0, 512, (2, 12)).astype(np.int32)
    want = _np(jforward(jp, jnp.asarray(toks), jcfg, BASELINE_RULES,
                        mode="train")[0])
    with torch.no_grad():
        good = _np(forward(tp, torch.from_numpy(toks).long(), tcfg)[0])
        monkeypatch.setattr(tops, "attention", _c2_layout_fault(tops.attention))
        bad = _np(forward(tp, torch.from_numpy(toks).long(), tcfg)[0])
    np.testing.assert_allclose(good, want, rtol=1e-5, atol=1e-5)
    assert not np.allclose(bad, want, rtol=1e-5, atol=1e-5)
    assert np.abs(bad - want).max() > 1e-2
    pallas = _np(jforward(jp, jnp.asarray(toks),
                          dataclasses.replace(jcfg, use_pallas=True),
                          BASELINE_RULES, mode="train")[0])
    assert np.abs(pallas - want).max() > 1e-2


# ---------------------------------------------------------------------------
# data, optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 123456)])
def test_synth_batch_is_bit_equal_to_reference(seed, step):
    jcfg, tcfg = _cfgs()
    want = jsynth_batch(jcfg, 4, 33, step, seed)
    got = synth_batch(tcfg, 4, 33, step, seed)
    assert set(got) == set(want) == {"tokens", "targets"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_data_iterator_resumes_the_stream():
    _, tcfg = _cfgs()
    it = data_iterator(tcfg, 2, 8, start_step=5, seed=1)
    first = next(it)
    it.close()
    np.testing.assert_array_equal(first["tokens"],
                                  synth_batch(tcfg, 2, 8, 5, 1)["tokens"])


def test_lr_schedule_matches_reference():
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    jc, tc = jtraining.OptimizerConfig(**kw), OptimizerConfig(**kw)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(
            float(lr_schedule(tc, torch.tensor(step, dtype=torch.int32))),
            float(jtraining.lr_schedule(jc, jnp.int32(step))),
            rtol=OPT_RTOL, err_msg=str(step))


def _opt_inputs(seed, nan=False):
    rng = np.random.default_rng(seed)
    shapes = {"a": {"w": (6, 5), "b": (5,)}, "emb": (7, 3, 2), "s": ()}
    mk = lambda f: {"a": {k: f(s) for k, s in shapes["a"].items()},  # noqa
                    "emb": f(shapes["emb"]), "s": f(shapes["s"])}
    params = mk(lambda s: rng.standard_normal(s).astype(np.float32))
    grads = mk(lambda s: (rng.standard_normal(s) * 3).astype(np.float32))
    m = mk(lambda s: (rng.standard_normal(s) * 0.1).astype(np.float32))
    v = mk(lambda s: rng.uniform(0, 0.5, s).astype(np.float32))
    if nan:
        grads["a"]["b"][2] = np.nan
    return params, grads, {"m": m, "v": v}


def _tt(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("nan", [False, True])
def test_adamw_update_matches_reference(nan):
    """Clipping (the gradient norm is above ``grad_clip``), bias
    correction at step 3, weight decay on the tensors of two or more
    dims only; with a NaN in one gradient the whole update is skipped and
    the state is returned unchanged."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=1.0,
              weight_decay=0.1)
    params, grads, opt = _opt_inputs(4, nan)
    jp, jo, jm = jtraining.adamw_update(
        jtraining.OptimizerConfig(**kw), jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, opt),
        jnp.int32(3))
    tp, to = _tt(params), _tt(opt)
    tp2, to2, tm = adamw_update(OptimizerConfig(**kw), tp, _tt(grads), to,
                                torch.tensor(3, dtype=torch.int32))
    assert tp2 is tp and to2 is to, "the update is in place"
    for (path, a), (_, b) in zip(_leaves(tp), _leaves(jax.tree.map(
            np.asarray, jp))):
        np.testing.assert_allclose(_np(a), b, rtol=OPT_RTOL, atol=1e-7,
                                   err_msg=path)
    for which in ("m", "v"):
        for (path, a), (_, b) in zip(_leaves(to[which]), _leaves(
                jax.tree.map(np.asarray, jo[which]))):
            np.testing.assert_allclose(_np(a), b, rtol=OPT_RTOL, atol=1e-7,
                                       err_msg=f"{which}{path}")
    for k in ("lr", "nonfinite"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=OPT_RTOL)
    if nan:
        assert float(tm["nonfinite"]) == 1.0
        for (path, a), (_, b) in zip(_leaves(tp), _leaves(params)):
            np.testing.assert_array_equal(_np(a), b, err_msg=path)
    else:
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=OPT_RTOL)


def test_global_norm_and_init_opt_state_match_reference():
    params, grads, _ = _opt_inputs(5)
    np.testing.assert_allclose(
        float(global_norm(_tt(grads))),
        float(jtraining.global_norm(jax.tree.map(jnp.asarray, grads))),
        rtol=OPT_RTOL)
    opt = init_opt_state(_tt(params))
    assert set(opt) == {"m", "v"}
    for (_, z), (_, p) in zip(_leaves(opt["v"]), _leaves(params)):
        assert z.shape == p.shape and not z.any()


# ---------------------------------------------------------------------------
# the train step and the trainer
# ---------------------------------------------------------------------------

def _state(tcfg, seed=0):
    return state_from_jax(
        jax.tree.map(np.asarray, jtraining.init_state(
            _cfgs()[0], jax.random.PRNGKey(seed))),
        tcfg)


def test_microbatch_equivalence():
    """Two microbatches accumulated in float32 against one batch, from the
    same state."""
    _, tcfg = _cfgs()
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    batch = _torch_batch(synth_batch(tcfg, 4, 16, step=0))
    s1, s2 = _state(tcfg), _state(tcfg)
    s1, m1 = make_train_step(tcfg, TrainConfig(num_microbatches=1,
                                               opt=opt))(s1, batch)
    s2, m2 = make_train_step(tcfg, TrainConfig(num_microbatches=2,
                                               opt=opt))(s2, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]),
                                              rel=LOSS_RTOL)
    assert int(s1["step"]) == int(s2["step"]) == 1
    for (path, a), (_, b) in zip(_leaves(s1["params"]),
                                 _leaves(s2["params"])):
        assert float((a - b).abs().max()) < 2.5 * 1e-3, path


def test_three_trainer_steps_match_reference():
    """The port's ``Trainer`` and the reference's, from the same state on
    the same stream: the loss of each step and the parameters after
    three steps."""
    jcfg, tcfg = _cfgs()
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jt = jtraining.Trainer(jcfg, BASELINE_RULES, jtraining.TrainConfig(
        log_every=1, opt=jtraining.OptimizerConfig(**opt)))
    jt.init(0)
    state = jax.tree.map(np.asarray, jt.state)
    tt = Trainer(tcfg, TrainConfig(log_every=1, opt=OptimizerConfig(**opt)),
                 device="cpu")
    tt.state = state_from_jax(state, tcfg)
    jhist = jt.run(jdata_iterator(jcfg, 4, 16, seed=2), 3)
    thist = tt.run(data_iterator(tcfg, 4, 16, seed=2), 3)
    assert len(thist) == len(jhist) == 3
    for a, b in zip(thist, jhist):
        for k in ("loss", "ce", "ppl", "grad_norm", "lr"):
            assert a[k] == pytest.approx(b[k], rel=GRAD_RTOL), k
    assert int(tt.state["step"]) == 3
    jparams = dict(_leaves(jax.tree.map(np.asarray, jt.state["params"])))
    for path, p in _leaves(tt.state["params"]):
        d = np.abs(_np(p) - jparams[path]).max()
        assert d < 2.5 * opt["lr"], (path, d)


def test_checkpoint_round_trip_keeps_bfloat16_bits(tmp_path):
    _, tcfg = _cfgs()
    state = init_state(tcfg, 0)
    state["step"] = torch.tensor(7, dtype=torch.int32)
    odd = torch.tensor([1.0, -2.5, 3.1415926, 1e-30, float("inf")],
                       dtype=torch.bfloat16)
    state["extra"] = {"bf16": odd}
    path = str(tmp_path / "ck")
    checkpoint.save(path, state)
    assert checkpoint.latest_step(path) == 7
    template = abstract_state(tcfg)
    template["extra"] = {"bf16": torch.empty(5, dtype=torch.bfloat16,
                                             device="meta")}
    back = checkpoint.restore_latest(path, template)
    assert int(back["step"]) == 7 and back["step"].dtype == torch.int32
    assert back["extra"]["bf16"].dtype == torch.bfloat16
    assert torch.equal(back["extra"]["bf16"].view(torch.int16),
                       odd.view(torch.int16))
    for (path_, a), (_, b) in zip(_leaves(state), _leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), path_
    leaves, manifest = checkpoint.restore(path, 7)
    assert manifest["dtypes"][manifest["paths"].index("/extra/bf16")] \
        == "bfloat16"


def test_checkpoint_gc_keeps_latest(tmp_path):
    _, tcfg = _cfgs()
    state = init_state(tcfg, 0)
    path = str(tmp_path / "ck")
    for s in (1, 2, 3, 4):
        state["step"] = torch.tensor(s, dtype=torch.int32)
        checkpoint.save(path, state, keep=2)
    steps = sorted(d for d in os.listdir(path) if d.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]
    assert not [d for d in os.listdir(path) if d.startswith(".tmp")]


def test_failure_injection_and_restart_end_on_the_same_parameters(tmp_path):
    """A simulated node failure at step 5; a fresh Trainer restores the
    checkpoint of step 4 and trains on to step 8, and ends on the
    parameters of a run that never failed, bit for bit."""
    _, tcfg = _cfgs()

    def tc(path):
        return TrainConfig(ckpt_dir=path, ckpt_every=2, log_every=100,
                           opt=OptimizerConfig(lr=1e-3, warmup_steps=0,
                                               total_steps=50))

    class Boom(RuntimeError):
        pass

    def failure(step):
        if step == 5:
            raise Boom("node lost")

    path = str(tmp_path / "ck")
    tr = Trainer(tcfg, tc(path), device="cpu")
    assert tr.init(0) == 0
    with pytest.raises(Boom):
        tr.run(data_iterator(tcfg, 2, 8), 8, failure_hook=failure)
    tr2 = Trainer(tcfg, tc(path), device="cpu")
    resumed = tr2.init(0)
    assert resumed == 4
    tr2.run(data_iterator(tcfg, 2, 8, start_step=resumed), 8 - resumed)

    ref = Trainer(tcfg, tc(str(tmp_path / "ref")), device="cpu")
    ref.init(0)
    ref.run(data_iterator(tcfg, 2, 8), 8)
    assert int(tr2.state["step"]) == int(ref.state["step"]) == 8
    for (p, a), (_, b) in zip(_leaves(tr2.state), _leaves(ref.state)):
        assert torch.equal(a, b), p


def test_trainer_takes_no_mesh_yet():
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="A.11"):
        Trainer(tcfg, TrainConfig(), mesh=object(), device="cpu")


def test_train_entry_point_lowers_the_loss_on_cpu():
    run = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--steps", "30", "--batch", "8", "--seq", "32",
                        "--lr", "3e-3", "--log-every", "1"])
    losses = [h["loss"] for h in run["history"]]
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < losses[0] - 1.0, losses
    assert len(run["step_seconds"]) == 30 and run["tokens_per_s"] > 0
    assert run["device"] == "cpu"


def test_train_entry_point_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceNotFoundError):
        tlaunch.main(["--arch", ARCH, "--smoke", "--steps", "1"])
