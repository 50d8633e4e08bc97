"""The port's host objects (Platform / Device / Context / Program /
Kernel) held against the reference's (``repro.runtime`` / ``repro.core``).

The quickstart path (paper Fig. 1 dot product, ``examples/quickstart.py``)
runs through both packages on the same numpy inputs and against the
fiber oracle at the quickstart's own tolerance (``rtol=1e-5,
atol=2e-6``); argument validation raises the same typed errors with the
same status codes.
"""

import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.core import KernelBuilder as JKB  # noqa: E402
from repro.core import ReproError as JReproError  # noqa: E402
from repro.runtime import Context as JContext  # noqa: E402

from repro_torch.core import (BuildError, InvalidArgError,  # noqa: E402
                              KernelBuilder as TKB, ReproError)
from repro_torch.core.cases import CASES, build_dot_product, builder  # noqa: E402
from repro_torch.core.interp import run_ndrange  # noqa: E402
from repro_torch.runtime import Context, Platform  # noqa: E402

N, LSZ = 256, 64


@pytest.fixture(scope="module")
def ctx():
    return Context(platform=Platform(torch_device="cpu"))


@pytest.fixture(scope="module")
def jctx():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return JContext()


def _dot_inputs():
    rng = np.random.default_rng(0)
    return {"a": rng.standard_normal(N * 4).astype(np.float32),
            "b": rng.standard_normal(N * 4).astype(np.float32),
            "c": np.zeros(N, np.float32)}


@pytest.mark.parametrize("target", ["vector", "loop"])
def test_quickstart_path_matches_reference_and_oracle(ctx, jctx, target):
    bufs = _dot_inputs()
    fiber = run_ndrange(build_dot_product(TKB), (N,), (LSZ,),
                        {k: v.copy() for k, v in bufs.items()})
    prog = ctx.create_program(builder(build_dot_product, TKB)).build()
    assert prog.kernel_names() == ["dot_product"]
    kern = prog.create_kernel("dot_product")
    kern.set_args(**bufs)
    out = ctx.launch(kern, (N,), (LSZ,), target=target)
    assert isinstance(out["c"], torch.Tensor)
    got = out["c"].numpy()
    np.testing.assert_allclose(got, fiber["c"], rtol=1e-5, atol=2e-6)
    jprog = jctx.create_program(builder(build_dot_product, JKB)).build()
    jk = jprog.create_kernel("dot_product")
    jk.set_args(**{k: v.copy() for k, v in bufs.items()})
    ref = jctx.launch(jk, (N,), (LSZ,), target=target)
    np.testing.assert_allclose(got, ref["c"], rtol=1e-5, atol=2e-6)
    binary = kern.bind(ctx.devices[0], (LSZ,), target=target)
    jbinary = jk.bind(jctx.devices[0], (LSZ,), target=target)
    assert binary.num_regions == jbinary.num_regions
    assert binary.context_stats == jbinary.context_stats


def test_launch_copies_inputs_and_accepts_tensors(ctx):
    bufs = _dot_inputs()
    keep = {k: v.copy() for k, v in bufs.items()}
    kern = ctx.create_program(builder(build_dot_product, TKB)).create_kernel()
    kern.set_args(**bufs)
    out_np = ctx.launch(kern, (N,), (LSZ,))
    for k in bufs:
        assert bufs[k].tobytes() == keep[k].tobytes()
    tens = {k: torch.tensor(v) for k, v in bufs.items()}
    kern.set_args(**tens)
    out_t = ctx.launch(kern, (N,), (LSZ,))
    assert out_t["c"].numpy().tobytes() == out_np["c"].numpy().tobytes()
    assert tens["c"].abs().sum().item() == 0.0       # caller's tensor kept
    assert out_t["c"].device == ctx.devices[0].torch_device


def _bad_args():
    return [
        ("wrong-dtype", lambda k: k.set_arg("x", np.zeros(8, np.int32))),
        ("scalar-for-buffer", lambda k: k.set_arg("x", 3.0)),
        ("buffer-for-scalar", lambda k: k.set_arg("n",
                                                  np.zeros(2, np.int32))),
        ("fractional-int", lambda k: k.set_arg("n", 2.5)),
        ("unknown-name", lambda k: k.set_arg("nope", 1)),
        ("index-out-of-range", lambda k: k.set_arg(5, 1)),
        ("bool-scalar", lambda k: k.set_arg("n", True)),
    ]


BAD = _bad_args()


@pytest.mark.parametrize("label,bad", BAD, ids=[b[0] for b in BAD])
def test_set_arg_errors_match_reference(ctx, jctx, label, bad):
    build = CASES["bloop"][0]
    t_kern = ctx.create_program(builder(build, TKB)).create_kernel()
    j_kern = jctx.create_program(builder(build, JKB)).create_kernel()
    with pytest.raises(JReproError) as je:
        bad(j_kern)
    with pytest.raises(ReproError) as te:
        bad(t_kern)
    assert type(te.value).__name__ == type(je.value).__name__
    assert te.value.code == je.value.code


def test_tensor_arguments_are_validated(ctx):
    kern = ctx.create_program(builder(CASES["bloop"][0],
                                      TKB)).create_kernel()
    kern.set_arg("x", torch.zeros(8))
    with pytest.raises(InvalidArgError, match="expects dtype float32"):
        kern.set_arg("x", torch.zeros(8, dtype=torch.float64))
    with pytest.raises(InvalidArgError, match="not supported"):
        kern.set_arg("x", torch.zeros(8, dtype=torch.bfloat16))
    kern.set_arg("n", torch.tensor(3))
    assert kern.launch_args()[1] == {"n": torch.tensor(3)}


def test_local_arg_and_unset_args(ctx):
    kern = ctx.create_program(builder(CASES["uncond"][0],
                                      TKB)).create_kernel()
    with pytest.raises(InvalidArgError, match="LOCAL array"):
        kern.set_arg("tmp", np.zeros(8, np.float32))
    assert kern.arg_info() == [("x", "buffer", "float32")]
    with pytest.raises(InvalidArgError, match="unset arguments"):
        ctx.launch(kern, (8,), (8,))


def test_program_level_errors(ctx):
    vec = builder(CASES["vecadd"][0], TKB)
    with pytest.raises(InvalidArgError, match="at least one"):
        ctx.create_program()
    with pytest.raises(InvalidArgError, match="duplicate kernel name"):
        ctx.create_program(vec, vec)
    prog = ctx.create_program(vec, builder(CASES["uncond"][0], TKB))
    with pytest.raises(InvalidArgError, match="explicit name"):
        prog.create_kernel()
    assert sorted(prog.create_kernels()) == ["uncond", "vecadd"]
    with pytest.raises(InvalidArgError, match="no kernel"):
        prog.create_kernel("nope").bind(ctx.devices[0], (8,))
    with pytest.raises(InvalidArgError, match="unknown target"):
        prog.binary_for("vecadd", (8,), device=ctx.devices[0],
                        target="pallas")
    with pytest.raises(InvalidArgError, match="multiple of the local"):
        k = prog.create_kernel("vecadd")
        k.set_args(A=np.ones(12, np.float32), B=np.ones(12, np.float32),
                   C=np.zeros(12, np.float32))
        ctx.launch(k, (12,), (8,))


def test_build_log_and_verifier_failure(ctx, monkeypatch):
    """A middle-end verifier failure surfaces as BuildError with the
    verifier report in the build log, as in the reference."""
    from repro_torch.core import program as program_mod
    from repro_torch.core.passes import VerifierError

    prog = ctx.create_program(builder(CASES["reduce"][0], TKB)).build()
    assert "middle-end ok" in prog.build_log()

    def broken_build_plan(*a, **k):
        raise VerifierError("tail_duplicate",
                            "block 'b3' unreachable after replication")
    monkeypatch.setattr(program_mod, "build_plan", broken_build_plan)
    bad = ctx.create_program(builder(CASES["bloop"][0], TKB))
    with pytest.raises(BuildError) as e:
        bad.build()
    assert e.value.code == -11 and e.value.build_log == bad.build_log()
    assert "tail_duplicate" in bad.build_log()
    assert e.value.__cause__.code == -45


def test_plan_built_once_across_devices():
    """N devices specializing one kernel share one region-formation run
    through the context's plan tier."""
    c = Context(platform=Platform(torch_device="cpu"))
    kern = c.create_program(builder(CASES["reduce"][0], TKB)).create_kernel()
    kern.set_args(inp=np.arange(16, dtype=np.float32),
                  out=np.zeros(2, np.float32))
    outs = [c.launch(kern, (16,), (8,), device=d)["out"] for d in c.devices]
    assert outs[0].numpy().tobytes() == outs[1].numpy().tobytes()
    assert c.cache_stats()["context"]["plan_builds"] == 1
    assert len(c.devices) == 2


def test_device_outside_context_is_refused():
    plat = Platform(torch_device="cpu")
    c = Context(devices=plat.get_devices("vector"), platform=plat)
    kern = c.create_program(builder(CASES["vecadd"][0], TKB)).create_kernel()
    kern.set_args(A=np.ones(16, np.float32), B=np.ones(16, np.float32),
                  C=np.zeros(16, np.float32))
    with pytest.raises(InvalidArgError, match="not part of this context"):
        c.launch(kern, (16,), (8,), device=plat.get_devices("basic")[0])


def test_device_info_and_targets():
    plat = Platform(torch_device="cpu")
    vec, basic = plat.get_devices("vector")[0], plat.get_devices("basic")[0]
    assert vec.torch_device == basic.torch_device == torch.device("cpu")
    assert vec.query("max_work_group_size") == 1024
    assert plat.get_devices("cuda") == []
    assert set(plat.cache_stats()) == {vec.info.name, basic.info.name}
