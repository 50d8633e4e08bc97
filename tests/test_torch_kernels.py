"""The port's model kernels and vml on the CPU, held against the reference.

The same inputs, made with numpy from a seed, go through ``repro``'s
function and its ``repro_torch`` counterpart.  On CPU tensors the kernel
wrappers run their plain versions, which compute what the Pallas kernels
compute; the reference's Pallas kernels run in interpret mode, as
``tests/test_kernels.py`` runs them.  Tolerances, and why:

* vml: bitwise.  The reference's XLA CPU backend flushes denormal inputs
  and results to zero, so the torch side runs with
  ``torch.set_flush_denormal(True)`` for the comparison; no operation is
  contracted into an FMA on either side, so no ulp of slack is needed.
* rmsnorm: float32 within ``1e-6`` (the mean of squares sums in another
  order), bfloat16 within one bfloat16 ulp (``rtol=2**-7``).
* decode attention: ``tests/test_kernels.py``'s (float32 ``1e-5``,
  bfloat16 ``3e-2``), and exact zeros for a row with no valid key (the
  Pallas kernel's behaviour, which the port's kernel keeps).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import vml as jvml  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch import vml as tvml  # noqa: E402
from repro_torch.core.errors import InvalidArgError  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain  # noqa: E402

BF16_ULP = 2.0 ** -7


def _np(x) -> np.ndarray:
    """A reference array or a torch tensor as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture
def flush_denormals():
    assert torch.set_flush_denormal(True), "this CPU cannot flush denormals"
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def _vml_grid() -> np.ndarray:
    rng = np.random.default_rng(42)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                        1e-39, -1e-39, 1.1754942e-38, 1.17549435e-38,
                        88.72, 88.7, -87.3, -87.2, 200.0, -200.0, 1.0, -1.0,
                        0.5, 3.4028235e38, -3.4028235e38], np.float32)
    return np.concatenate([
        special,
        (rng.standard_normal(20_000) * 20).astype(np.float32),
        np.exp(rng.uniform(-85, 85, 20_000)).astype(np.float32),
        -np.exp(rng.uniform(-85, 85, 5_000)).astype(np.float32)])


@pytest.mark.parametrize("name", ["fabs", "rsqrt", "exp", "sigmoid", "silu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vml_subset_bitwise(flush_denormals, name, dtype):
    x = _vml_grid()
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = _np(getattr(jvml, name)(jx))
    got = _np(getattr(tvml, name)(tx))
    same = (want.view(np.int32) == got.view(np.int32)) | \
        (np.isnan(want) & np.isnan(got))
    assert same.all(), (name, dtype, x[~same][:5], want[~same][:5],
                        got[~same][:5])
    assert getattr(tvml, name)(tx).dtype == tx.dtype


RMS_SHAPES = [(8, 256), (16, 512), (4, 1024), (8, 576), (3, 576)]


@pytest.mark.parametrize("rows,d", RMS_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas_kernel(rows, d, dtype, wdtype):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(rows, d)) * 2).astype(np.float32)
    w = rng.normal(size=(d,)).astype(np.float32)
    want = jops.rmsnorm(jnp.asarray(x).astype(dtype),
                        jnp.asarray(w).astype(wdtype), use_pallas=True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, wdtype))
    got = rmsnorm_plain(tx, tw)
    assert got.dtype == tx.dtype
    # on CPU tensors the wrapper is the plain version
    assert torch.equal(rmsnorm(tx, tw), got)
    assert torch.equal(tops.rmsnorm(tx, tw, use_kernels=True), got)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_ULP,
                                   atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_ref_matches_reference_ref(dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 576)).astype(np.float32)
    w = rng.normal(size=(576,)).astype(np.float32)
    want = jref.rmsnorm(jnp.asarray(x).astype(dtype), jnp.asarray(w))
    got = tops.rmsnorm(torch.from_numpy(x).to(getattr(torch, dtype)),
                       torch.from_numpy(w), use_kernels=False)
    tol = 1e-6 if dtype == "float32" else BF16_ULP
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=0)


DECODE_SHAPES = [
    (1, 4, 4, 64, 256),
    (2, 8, 2, 64, 512),
    (4, 8, 1, 128, 256),
    (3, 9, 3, 64, 256),       # the serving path's GQA group of 3
]


def _decode_inputs(B, H, KV, D, S, dtype, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kc = rng.normal(size=(B, KV, S, D)).astype(np.float32)
    vc = rng.normal(size=(B, KV, S, D)).astype(np.float32)
    lengths = rng.integers(1, S, (B,)).astype(np.int32)
    j = [jnp.asarray(a).astype(dtype) for a in (q, kc, vc)]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, kc, vc)]
    return j, t, lengths


@pytest.mark.parametrize("B,H,KV,D,S", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_pallas_kernel(B, H, KV, D, S, dtype):
    (jq, jk, jv), (tq, tk, tv), lengths = _decode_inputs(B, H, KV, D, S,
                                                         dtype)
    lengths[0] = 0                  # a row with no valid key
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(lengths),
                                 use_pallas=True)
    tl = torch.from_numpy(lengths)
    got = decode_attention_plain(tq, tk, tv, tl)
    assert got.dtype == tq.dtype and got.shape == (B, H, D)
    assert torch.equal(decode_attention(tq, tk, tv, tl), got)
    assert torch.equal(tops.decode_attention(tq, tk, tv, tl,
                                             use_kernels=True), got)
    assert torch.all(got[0] == 0), "a row with no valid key returns zeros"
    assert np.all(_np(want)[0] == 0)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,H,KV,D,S", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_ref_matches_reference_ref(B, H, KV, D, S, dtype):
    """``use_kernels=False`` against ``repro.kernels.ref`` (lengths >= 1:
    the two refs agree with each other on empty rows, not with the
    kernels)."""
    (jq, jk, jv), (tq, tk, tv), lengths = _decode_inputs(B, H, KV, D, S,
                                                         dtype, seed=4)
    want = jref.decode_attention(jq, jk, jv, jnp.asarray(lengths))
    got = tops.decode_attention(tq, tk, tv, torch.from_numpy(lengths),
                                use_kernels=False)
    assert got.dtype == tv.dtype
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_decode_attention_mixed_dtypes_as_the_model_calls_it():
    """In a float32 model the queries are float32 and the cache bfloat16;
    the kernel's output keeps the queries' dtype."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 4, 16)).astype(np.float32)
    kc = rng.normal(size=(2, 2, 256, 16)).astype(np.float32)
    vc = rng.normal(size=(2, 2, 256, 16)).astype(np.float32)
    lengths = np.array([7, 256], np.int32)
    want = jops.decode_attention(
        jnp.asarray(q), jnp.asarray(kc).astype(jnp.bfloat16),
        jnp.asarray(vc).astype(jnp.bfloat16), jnp.asarray(lengths),
        use_pallas=True)
    got = decode_attention(torch.from_numpy(q),
                           torch.from_numpy(kc).to(torch.bfloat16),
                           torch.from_numpy(vc).to(torch.bfloat16),
                           torch.from_numpy(lengths))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_reference_ref(causal):
    rng = np.random.default_rng(6)
    q = rng.normal(size=(2, 4, 64, 32)).astype(np.float32)
    k = rng.normal(size=(2, 2, 64, 32)).astype(np.float32)
    v = rng.normal(size=(2, 2, 64, 32)).astype(np.float32)
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal)
    got = tops.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


#: every function of the reference that reaches ``pl.pallas_call`` (the
#: TPU kernels, PERF.md's table) -> its port: a kernel of
#: ``repro_torch.kernels.KERNELS`` (by name) or the ``cuda`` target
TPU_KERNELS = {
    "core/targets/pallas_target.py:PallasWGProgram.run_ndrange": "cuda",
    "kernels/rmsnorm.py:rmsnorm": "rmsnorm",
    "kernels/decode_attention.py:decode_attention": "decode_attention",
    "kernels/flash_attention.py:flash_attention": "flash_attention",
    "kernels/ssd_scan.py:ssd_scan": "ssd_scan",
}


def test_unported_kernels_raise_naming_the_roadmap():
    """No TPU kernel is left unported: each function of the reference
    that reaches ``pl.pallas_call`` has its hand-written counterpart, a
    model kernel with a CUDA source or the ``cuda`` work-group target,
    and the kernel switch runs it (the SSD scan's parity tests are in
    test_torch_ssd.py, flash attention's in test_torch_flash.py)."""
    import pathlib
    from repro_torch.core.targets.vector import WGProgram
    from repro_torch.core.targets import cuda_target
    from repro_torch.kernels import KERNELS
    src = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro"
    found = set()
    for f in sorted(src.rglob("*.py")):
        text = f.read_text()
        if "pl.pallas_call(" in text:
            rel = f.relative_to(src).as_posix()
            found.update(k for k in TPU_KERNELS if k.startswith(rel + ":"))
            assert any(k.startswith(rel + ":") for k in TPU_KERNELS), rel
    assert found == set(TPU_KERNELS)
    ported = {k.name: k for k in KERNELS}
    for tpu, port in TPU_KERNELS.items():
        if port == "cuda":
            assert issubclass(cuda_target.CudaWGProgram, WGProgram), tpu
        else:
            assert ported[port].source_path.exists(), (tpu, port)
    x = torch.zeros(1, 1, 4, 8)
    o = tops.attention(x, x, x, use_kernels=True)
    assert o.shape == (1, 1, 4, 8)
    y, state = tops.ssd_scan(torch.zeros(1, 8, 4, 8), torch.zeros(1, 8, 4),
                             torch.zeros(4), torch.zeros(1, 8, 1, 16),
                             torch.zeros(1, 8, 1, 16), chunk=8,
                             use_kernels=True)
    assert y.shape == (1, 8, 4, 8) and state.shape == (1, 4, 8, 16)


def test_kernels_without_a_backward_refuse_inputs_that_require_grad():
    """decode attention and the SSD scan have no backward: an input that
    requires grad is refused while grad mode is on, naming the ROADMAP
    item, instead of a result with no ``grad_fn``; without grad mode they
    run."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    q = torch.zeros(2, 4, 16, requires_grad=True)
    kc = torch.zeros(2, 2, 32, 16)
    lens = torch.tensor([3, 32], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP §B.2"):
        decode_attention(q, kc, kc, lens)
    args = (torch.zeros(1, 8, 4, 8, requires_grad=True), torch.zeros(1, 8, 4),
            torch.zeros(4), torch.zeros(1, 8, 1, 16), torch.zeros(1, 8, 1, 16))
    with pytest.raises(NotImplementedError, match="ROADMAP A.13"):
        ssd_scan(*args, chunk=8)
    with torch.no_grad():
        assert decode_attention(q, kc, kc, lens).shape == (2, 4, 16)
        assert ssd_scan(*args, chunk=8)[0].shape == (1, 8, 4, 8)


def test_wrappers_refuse_tensors_that_are_neither_cpu_nor_cuda():
    """The plain version is taken only for CPU tensors: anything else is
    refused, never computed on the side."""
    x = torch.zeros(8, 576, device="meta")
    w = torch.zeros(576, device="meta")
    with pytest.raises(InvalidArgError, match="CUDA"):
        rmsnorm(x, w)
    q = torch.zeros(2, 4, 16, device="meta")
    kc = torch.zeros(2, 2, 32, 16, device="meta")
    lens = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(InvalidArgError, match="CUDA"):
        decode_attention(q, kc, kc, lens)
