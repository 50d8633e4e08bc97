"""Training the ssm, hybrid, moe, vlm and encdec families in the port,
held against the reference on the CPU.

The reference's smoke configs of mamba2-780m, zamba2-7b,
granite-moe-3b-a800m, llama-3.2-vision-11b and whisper-small in float32;
parameters from the reference's ``init_params`` through
``params_from_jax`` (the vlm's cross-attention gates, zeros at init,
drawn from N(0, 1) on both sides so that the image reaches the loss);
batches from the synthetic stream, the image or frame embeddings
included.  ``loss_fn``'s value, metrics and every gradient leaf are
compared with ``jax.value_and_grad`` of the reference's ``loss_fn``
(``use_pallas=False``, the reference's training path), with the port's
kernels on and off and per-block remat on and off.  With kernels, the
port's SSD scan is ``SSDScan`` (the kernel's plain version forward, the
gradient of ``ref.ssd_scan``), attention is ``FlashAttention`` and the
norms are ``RMSNorm``.

Tolerances are ``tests/test_torch_training.py``'s: the loss within
``rtol=1e-5``, every gradient leaf within ``rtol=1e-4`` and ``1e-6`` of
the leaf's largest entry (the two frameworks sum over the batch's
tokens in other orders); parameters after trainer steps within
``2.5 * lr``.  The families with the Mamba-2 scan (ssm, hybrid) take
``1.3e-6`` of the leaf's largest entry, just above their largest
reading: their gradients pass through exp of a cumulative sum of
dt · A, and float32 rounding there puts two leaves past 1e-6 of the
leaf's size between the two frameworks, both with the kernels off and
with remat on or off: mamba2's dt bias at 16 tokens (1.044e-6) and
zamba2's shared attention query (1.202e-6).  Every other leaf of every
case reads at most 1e-6; the planted fault (a backward given dt one
step off) reads 0.22 to 1.70 on mamba2's mixer leaves.
``tools/grad_atol_readings.py`` prints these readings; two runs, one of
them on one thread, gave the same.  mamba2 runs at a whole and a ragged length (16 and 12
tokens at chunk 8: the port's kernel branch takes the ragged chunk as
dt = 0 in the scan and in its backward).  granite-moe runs at 16
tokens, its MoE group, so that no group is padded (ROADMAP C.16).
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import training as jtraining  # noqa: E402
from repro.data import data_iterator as jdata_iterator  # noqa: E402
from repro.distributed.sharding import BASELINE_RULES  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import data_iterator, synth_batch  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import loss_fn, params_from_jax  # noqa: E402
from repro_torch.models import state_from_jax  # noqa: E402
from repro_torch.training import (OptimizerConfig, TrainConfig,  # noqa: E402
                                  Trainer)
from test_torch_ssd_grad import dt_shifted  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-6
#: the ssm and hybrid families' atol, relative to the leaf's largest
#: entry: just above their largest reading, 1.202e-6 (module docstring)
GRAD_ATOL_REL_SCAN = 1.3e-6



def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _leaves(tree[k], f"{path}/{k}")]
    return [(path, tree)]


def _cfgs(arch, **over):
    """The reference's and the port's smoke configs in float32;
    ``use_kernels`` goes to the port only."""
    kernels = over.pop("use_kernels", True)
    jcfg = jconfigs.get_smoke(arch, dtype="float32", **over)
    tcfg = tconfigs.get_smoke(arch, dtype="float32", use_kernels=kernels,
                              **over)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jparams(arch, seed=0):
    """The reference's parameters as numpy, a vlm's gates drawn from
    N(0, 1)."""
    jcfg, _ = _cfgs(arch)
    jp = jax.tree.map(np.asarray, jinit_params(jcfg, jax.random.PRNGKey(seed)))
    if jcfg.family == "vlm":
        jp["cross"]["gate"] = np.random.default_rng(seed + 99) \
            .standard_normal(jp["cross"]["gate"].shape).astype(np.float32)
    return jp


@functools.lru_cache(maxsize=None)
def _jvalue_and_grad(arch, remat):
    """The reference's jitted ``value_and_grad(loss_fn)``, shared by the
    kernel settings."""
    jcfg, _ = _cfgs(arch, remat=remat)
    return jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(p, b, jcfg, BASELINE_RULES), has_aux=True))


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) if np.asarray(v).dtype.kind
            == "f" else torch.from_numpy(np.asarray(v)).long()
            for k, v in batch.items()}


def _loss_and_grads(tp, batch, tcfg):
    leaves = _leaves(tp)
    for _, p in leaves:
        p.requires_grad_(True)
    loss, metrics = loss_fn(tp, _torch_batch(batch), tcfg)
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    return loss, metrics, [path for path, _ in leaves], grads


def atol_readings(paths, grads, jg):
    """Per leaf, the least atol, as a fraction of the leaf's largest
    entry, that ``_assert_grads_close``'s check passes at ``GRAD_RTOL``
    (``tools/grad_atol_readings.py`` prints them)."""
    jleaves = dict(_leaves(jax.tree.map(np.asarray, jg)))
    out = {}
    for path, g in zip(paths, grads):
        want = np.asarray(jleaves[path], np.float32)
        excess = np.abs(_np(g) - want) - GRAD_RTOL * np.abs(want)
        out[path] = float(max(excess.max(), 0.0) / np.abs(want).max())
    return out


def _assert_grads_close(paths, grads, jg, family):
    jleaves = dict(_leaves(jax.tree.map(np.asarray, jg)))
    assert set(jleaves) == set(paths)
    atol_rel = GRAD_ATOL_REL_SCAN if family in ("ssm", "hybrid") \
        else GRAD_ATOL_REL
    for path, g in zip(paths, grads):
        want = np.asarray(jleaves[path], np.float32)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(_np(g), want, rtol=GRAD_RTOL,
                                   atol=atol_rel * scale, err_msg=path)


def both_gradients(arch, seq, remat, kernels):
    """The port's config, the reference's ((loss, metrics), gradients)
    and the port's (loss, metrics, leaf paths, gradients) on one batch."""
    _, tcfg = _cfgs(arch, use_kernels=kernels, remat=remat)
    jp = _jparams(arch)
    batch = synth_batch(tcfg, 2, seq, step=3, seed=1)
    jout, jg = _jvalue_and_grad(arch, remat)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return tcfg, jout, jg, _loss_and_grads(params_from_jax(jp, tcfg), batch,
                                           tcfg)


def gradient_case(arch, seq, remat, kernels):
    """``loss_fn``'s value, metrics (ce, the MoE aux loss, ppl) and every
    gradient leaf against ``jax.value_and_grad`` of the reference's
    ``loss_fn``: the hybrid's shared block summed over its applications,
    the MoE router through its top-k weights and the aux loss, the vlm's
    gates, whisper's non-causal encoder.  The hybrid, moe and
    cross-attending families run it from
    ``tests/test_torch_training_families_attn.py`` and
    ``tests/test_torch_training_families_xattn.py``, so that a run that
    hands out whole files spreads them over its workers."""
    tcfg, (jloss, jm), jg, (loss, metrics, paths, grads) = both_gradients(
        arch, seq, remat, kernels)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    for k in ("ce", "aux", "ppl"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert (float(metrics["aux"].detach()) > 0) == (tcfg.family == "moe")
    _assert_grads_close(paths, grads, jg, tcfg.family)


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("seq", [16, 12])
def test_ssm_loss_and_gradients_match_reference(seq, remat, kernels):
    """mamba2 at a whole and a ragged length (12 tokens at chunk 8)."""
    gradient_case("mamba2-780m", seq, remat, kernels)


def test_dt_shifted_backward_fails_the_gradient_check(monkeypatch):
    """A planted fault: ``SSDScan``'s backward recomputes with dt shifted
    by one step.  The forward is untouched, so the loss still agrees;
    the gradients must fail the check that the right backward passes."""
    arch, seq = "mamba2-780m", 16
    _, tcfg = _cfgs(arch, remat="none")
    jp = _jparams(arch)
    batch = synth_batch(tcfg, 2, seq, step=3, seed=1)
    (jloss, _), jg = _jvalue_and_grad(arch, "none")(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    monkeypatch.setattr(tssd, "ssd_scan_reference",
                        dt_shifted(tssd.ssd_scan_reference))
    loss, _, paths, grads = _loss_and_grads(params_from_jax(jp, tcfg), batch,
                                            tcfg)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    with pytest.raises(AssertionError):
        _assert_grads_close(paths, grads, jg, tcfg.family)


def test_three_trainer_steps_match_reference():
    """The port's ``Trainer`` and the reference's on mamba2, from the
    same state on the same stream: the loss of each step and the
    parameters after three steps."""
    jcfg, tcfg = _cfgs("mamba2-780m")
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


def test_train_entry_point_lowers_mamba2_loss_on_cpu():
    run = tlaunch.main(["--arch", "mamba2-780m", "--smoke", "--device",
                        "cpu", "--steps", "30", "--batch", "8", "--seq",
                        "32", "--lr", "3e-3", "--log-every", "1"])
    losses = [h["loss"] for h in run["history"]]
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < losses[0] - 1.0, losses
    assert run["device"] == "cpu"


def test_train_entry_point_takes_only_known_architectures():
    with pytest.raises(SystemExit):
        tlaunch.parse_args(["--arch", "mamba2"])
    assert tlaunch.parse_args(["--arch", "whisper-small"]).arch \
        == "whisper-small"
