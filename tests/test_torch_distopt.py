"""The port's gradient compression and straggler monitor
(``repro_torch.training.compression``, ``repro_torch.training.straggler``)
held against ``repro.training`` on the CPU, as ``tests/test_distopt.py``
holds the reference.

The same seeded numpy inputs go through both packages.  Compression is
compared bit for bit: both divide by the same float32 scale and round
half to even (``jnp.round``, ``torch.round``), so the int8 payloads, the
scales and the error-feedback residuals must be equal, step after step.
The monitor and the planner are integer and comparison logic: their
flags and plans must be equal.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.training import compression as jcomp  # noqa: E402
from repro.training import straggler as jstrag  # noqa: E402

from repro_torch import training  # noqa: E402
from repro_torch.training import compression as tcomp  # noqa: E402
from repro_torch.training import straggler as tstrag  # noqa: E402


def _equal(got, want, what):
    """Same dtype, shape and bytes."""
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (what, g.dtype, w.dtype)
    assert g.tobytes() == w.tobytes(), (what, g, w)


@pytest.mark.parametrize("case", ["normal", "ties", "zeros", "huge"])
def test_compress_is_bitwise_equal_to_reference(case):
    """Payload and scale of one tensor; ``ties`` puts values on exact
    halves of the scale (round half to even), ``zeros`` takes the scale
    of 1 for an all-zero gradient."""
    rng = np.random.default_rng(3)
    g = {"normal": rng.normal(size=(64, 33)),
         "ties": np.array([127.0, -63.5, 0.5, 1.5, 2.5, -0.5, -1.5, 3.5]),
         "zeros": np.zeros(17),
         "huge": rng.normal(size=(257,)) * 1e30}[case].astype(np.float32)
    jq, js = jcomp.compress(jnp.asarray(g))
    tq, ts = tcomp.compress(torch.from_numpy(g))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    _equal(tq, jq, "payload")
    _equal(ts, js, "scale")
    _equal(tcomp.decompress(tq, ts), jcomp.decompress(jq, js), "decompress")


def test_compress_grads_with_error_feedback_is_bitwise_equal_over_steps():
    """Eight steps of error feedback over a nested tree: each step's
    quantized tree, its decompression and the new feedback equal the
    reference's, bit for bit."""
    rng = np.random.default_rng(4)
    shapes = {"a": {"w": (12, 7), "b": (7,)}, "emb": (5, 3, 2), "s": ()}

    def draw(scale):
        return {"a": {k: (rng.normal(size=s) * scale).astype(np.float32)
                      for k, s in shapes["a"].items()},
                "emb": (rng.normal(size=shapes["emb"]) * scale)
                .astype(np.float32),
                "s": np.float32(rng.normal() * scale)}

    jfb = jcomp.init_feedback(jax.tree.map(jnp.asarray, draw(1.0)))
    tfb = tcomp.init_feedback(jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)), draw(1.0)))
    for step in range(8):
        g = draw(10.0 ** (step % 3 - 2))
        jq, jfb = jcomp.compress_grads(jax.tree.map(jnp.asarray, g), jfb)
        tq, tfb = tcomp.compress_grads(jax.tree.map(
            lambda a: torch.from_numpy(np.array(a)), g), tfb)
        jpairs = jax.tree.leaves(jq, is_leaf=lambda x: isinstance(x, tuple))
        tpairs = [tq["a"]["b"], tq["a"]["w"], tq["emb"], tq["s"]]
        assert len(jpairs) == len(tpairs) == 4
        for (jqq, jss), (tqq, tss) in zip(jpairs, tpairs):
            _equal(tqq, jqq, f"step {step} payload")
            _equal(tss, jss, f"step {step} scale")
        for (path, t), j in zip(training.tree.leaves_with_paths(tfb),
                                jax.tree.leaves(jfb)):
            _equal(t, j, f"step {step} feedback {path}")
        for (path, t), j in zip(
                training.tree.leaves_with_paths(tcomp.decompress_grads(tq)),
                jax.tree.leaves(jcomp.decompress_grads(jq))):
            _equal(t, j, f"step {step} decompressed {path}")


def test_error_feedback_reduces_bias():
    """``tests/test_distopt.py``'s property on the port: with feedback the
    accumulated reconstruction tracks the accumulated gradient."""
    rng = np.random.default_rng(1)
    true_sum = np.zeros(64, np.float32)
    recon_sum = np.zeros(64, np.float32)
    fb = {"w": torch.zeros(64)}
    for _ in range(50):
        g = torch.from_numpy((rng.normal(size=64) * 0.01).astype(np.float32))
        true_sum += g.numpy()
        qtree, fb = tcomp.compress_grads({"w": g}, fb)
        recon_sum += tcomp.decompress_grads(qtree)["w"].numpy()
    assert np.abs(true_sum - recon_sum).max() < 0.01
    q, _ = tcomp.compress(torch.ones(1024))
    assert q.element_size() * 4 == torch.ones(1024).element_size()


def _host_sequences(seed):
    """Per-step step times of five hosts: a persistent straggler, a
    one-off blip, one that turns slow halfway, and two steady ones."""
    rng = np.random.default_rng(seed)
    steps = []
    for step in range(30):
        t = {h: float(1.0 + 0.05 * rng.standard_normal())
             for h in ("h0", "h1", "blip", "late", "slow")}
        t["slow"] *= 2.5
        if step == 7:
            t["blip"] *= 3.0
        if step >= 15:
            t["late"] *= 1.8
        steps.append(t)
    return steps


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("window,factor,persist",
                         [(20, 1.5, 5), (10, 1.5, 3), (5, 2.0, 2)])
def test_straggler_monitor_flags_equal_reference(seed, window, factor,
                                                 persist):
    """The flags of every ``check`` over the same recorded sequences,
    with a host forgotten midway and recorded again."""
    jm = jstrag.StragglerMonitor(jstrag.StragglerConfig(window, factor,
                                                        persist))
    tm = tstrag.StragglerMonitor(tstrag.StragglerConfig(window, factor,
                                                        persist))
    flagged = []
    for step, times in enumerate(_host_sequences(seed)):
        for host, s in times.items():
            jm.record(host, s)
            tm.record(host, s)
        if step == 20:
            jm.forget("slow")
            tm.forget("slow")
        got, want = tm.check(), jm.check()
        assert got == want, (step, got, want)
        flagged.append(got)
    assert any("slow" in f for f in flagged)
    assert not any("blip" in f for f in flagged)


def test_plan_elastic_mesh_equals_reference():
    for model_axis, per_pod in ((16, 256), (8, 64), (4, 16), (1, 8)):
        for chips in list(range(0, 600, 7)) + [15, 16, 255, 256, 511, 512]:
            assert tstrag.plan_elastic_mesh(chips, model_axis, per_pod) == \
                jstrag.plan_elastic_mesh(chips, model_axis, per_pod), \
                (chips, model_axis, per_pod)
    assert training.plan_elastic_mesh(511) == (1, 16, 16)
