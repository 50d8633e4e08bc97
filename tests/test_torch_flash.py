"""The port's flash attention on the CPU, held against the reference.

The same inputs, made with numpy from a seed, go through ``repro``'s
function and its ``repro_torch`` counterpart: the plain version of the
flash kernel (what the wrapper runs on CPU tensors) against the Pallas
kernel in interpret mode and against ``repro.models.flash``'s blocked
attention; the gradients of :class:`FlashAttention` (the kernel's
forward with the blocked backward) against ``jax.grad`` through the
reference's ``blocked_attention`` custom VJP; and the gradients of the
rmsnorm ``autograd.Function`` against ``jax.grad`` of
``repro.kernels.ref.rmsnorm``.  Tolerances, and why:

* float32 outputs within ``rtol=1e-5, atol=2e-6``: both sides compute
  the f32 scores, the online softmax and the products in f32 and differ
  in summation order and ``exp`` only (the largest difference seen is
  7e-7 at |o| <= 3).
* bfloat16 outputs within one bfloat16 ulp (``rtol=2**-7``) with
  ``atol=1e-6``: both sides read the same bfloat16 values, compute in
  f32 and round once.
* float32 gradients within ``rtol=1e-4, atol=1e-5``: the backward's
  products sum over up to Sq * D terms in another order on each side,
  and dk, dv of a GQA head sum a group's heads in another order.
* A row with no valid key (causal, Sq > Sk) is zeros in the port, where
  the Pallas kernel returns zeros only when its whole q block has no
  valid key and otherwise the mean of V over the blocks it computed
  (ROADMAP §C.3); rows with a valid key are compared everywhere, and
  every row where the Pallas blocks line up with the masked rows.
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.models.flash import blocked_attention as jblocked  # noqa: E402

from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: E402
from repro_torch.models.flash import FlashAttention  # noqa: E402

BF16_ULP = 2.0 ** -7
F32_TOL = dict(rtol=1e-5, atol=2e-6)
BF16_TOL = dict(rtol=BF16_ULP, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _qkv(seed, B, H, Hkv, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32))


def _valid_rows(Sq, Sk, causal):
    """Rows that see at least one key."""
    return np.arange(Sq) + (Sk - Sq) >= 0 if causal else np.ones(Sq, bool)


GRID = [(group, causal, Sq, Sk, "float32") for group in (1, 2, 3)
        for causal in (True, False) for Sq, Sk in ((32, 32), (16, 48),
                                                   (48, 16))]
GRID += [(3, causal, Sq, Sk, "bfloat16") for causal in (True, False)
         for Sq, Sk in ((32, 32), (16, 48), (48, 16))]


@pytest.mark.parametrize("group,causal,Sq,Sk,dtype", GRID)
def test_plain_matches_pallas_kernel(group, causal, Sq, Sk, dtype):
    """Every GQA group size, causal or not, Sq = Sk, Sq < Sk and Sq > Sk
    in float32; the same lengths in bfloat16 at the largest group."""
    Hkv, D = 2, 16
    q, k, v = _qkv(group * 100 + Sq, 2, Hkv * group, Hkv, Sq, Sk, D)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    want = jflash(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                  jnp.asarray(v, jdt), causal=causal, interpret=True)
    got, lse = flash_attention(torch.from_numpy(q).to(tdt),
                               torch.from_numpy(k).to(tdt),
                               torch.from_numpy(v).to(tdt), causal=causal)
    assert got.dtype == tdt and lse.dtype == torch.float32
    assert lse.shape == (2, Hkv * group, Sq)
    ok = _valid_rows(Sq, Sk, causal)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got)[:, :, ok], _np(want)[:, :, ok],
                               **tol)
    # rows with no valid key: zeros, and lse = m + log(1) = -1e30
    assert np.all(_np(got)[:, :, ~ok] == 0.0)
    assert np.all(_np(lse)[:, :, ~ok] == np.float32(-1e30))


def test_zero_rows_match_pallas_where_its_blocks_line_up():
    """With block_q = 16 the Pallas kernel's first two q blocks hold only
    rows with no valid key and are skipped whole, so it returns zeros
    there too and every row compares; with its default block (48 here)
    it returns the mean of V over the block it computed (ROADMAP §C.3)."""
    q, k, v = _qkv(7, 1, 4, 2, 48, 16, 16)
    got, _ = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True)
    aligned = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, block_q=16, interpret=True)
    np.testing.assert_allclose(_np(got), _np(aligned), **F32_TOL)
    default = _np(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, interpret=True))
    assert np.abs(default[:, :, :32]).max() > 0.1


def test_plain_takes_any_head_size_and_scale():
    q, k, v = _qkv(8, 1, 2, 1, 32, 32, 24)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True, sm_scale=0.3, interpret=True)
    got, _ = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), True, 0.3)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


@pytest.mark.parametrize("S,H,KV,bq,bk", [(37, 4, 2, 16, 8), (24, 6, 2, 8, 32),
                                           (11, 3, 3, 512, 1024)])
def test_plain_matches_blocked_attention_at_ragged_lengths(S, H, KV, bq, bk):
    """The reference's blocked attention pads S to whole blocks; the
    flash kernel's plain version takes S as it is.  Layouts: (B, S, H, D)
    for the reference, (B, H, S, D) for the kernel."""
    rng = np.random.default_rng(S)
    D = 16
    q = rng.standard_normal((2, S, H, D)).astype(np.float32)
    k = rng.standard_normal((2, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((2, S, KV, D)).astype(np.float32)
    want = jblocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=True, block_q=bq, block_k=bk)
    t = lambda a: torch.from_numpy(a).transpose(1, 2).contiguous()  # noqa
    got, _ = flash_attention_plain(t(q), t(k), t(v), causal=True)
    np.testing.assert_allclose(_np(got.transpose(1, 2)), _np(want),
                               **F32_TOL)


@pytest.mark.parametrize("S,H,KV,bq,bk", [(40, 6, 2, 16, 32), (32, 2, 2, 8, 8),
                                           (13, 3, 1, 512, 1024)])
def test_gradients_match_blocked_attention_vjp(S, H, KV, bq, bk):
    """``FlashAttention``'s (dq, dk, dv) against ``jax.grad`` through the
    reference's ``blocked_attention`` custom VJP, for the same cotangent;
    the port scales q inside (``sm_scale``), the reference before."""
    rng = np.random.default_rng(S + H)
    D = 16
    q = rng.standard_normal((2, S, H, D)).astype(np.float32)
    k = rng.standard_normal((2, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((2, S, KV, D)).astype(np.float32)
    w = rng.standard_normal((2, S, H, D)).astype(np.float32)

    def jloss(q, k, v):
        o = jblocked(q, k, v, causal=True, block_q=bq, block_k=bk)
        return jnp.sum(o * w)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))

    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2).contiguous()
                  .requires_grad_(True) for a in (q, k, v))
    o = FlashAttention.apply(tq, tk, tv, True, None, bq, bk)
    torch.sum(o * torch.from_numpy(w).transpose(1, 2)).backward()
    for name, t, j in zip("qkv", (tq, tk, tv), jg):
        np.testing.assert_allclose(_np(t.grad.transpose(1, 2)), _np(j),
                                   err_msg=f"d{name}", **GRAD_TOL)


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal",
                         [(1, 2, 1, 5, 7, 3, True), (2, 3, 3, 6, 6, 4, False),
                          (1, 4, 2, 7, 3, 2, True)])
def test_flash_backward_passes_gradcheck(B, H, Hkv, Sq, Sk, D, causal):
    """The backward against finite differences of the forward, in
    float64 (both sides compute in float64 for a float64 q), with blocks
    smaller than the sequences so the block loops and their ragged ends
    are exercised; Sq != Sk aligns the causal mask to the key tail."""
    g = torch.Generator().manual_seed(B * 100 + Sq)
    args = [torch.randn(shape, dtype=torch.float64, generator=g,
                        requires_grad=True)
            for shape in ((B, H, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))]
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashAttention.apply(q, k, v, causal, 0.7, 2, 3),
        args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_gradients_match_reference(dtype):
    """The rmsnorm ``autograd.Function`` (the kernel's plain version on
    CPU tensors, the analytic backward) against ``jax.grad`` of the
    reference's plain rmsnorm.  float32 within ``GRAD_TOL``; bfloat16
    inputs within two bfloat16 ulps, each side rounding dx and dw once
    from f32 values that differ in their last bits."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 5, 32)) * 2).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    c = rng.standard_normal((3, 5, 32)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def jloss(x, w):
        return jnp.sum(jref.rmsnorm(x, w).astype(jnp.float32) * c)
    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x, jdt),
                                               jnp.asarray(w, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    tw = torch.from_numpy(w).to(tdt).requires_grad_(True)
    y = rmsnorm(tx, tw)
    assert y.grad_fn is not None
    torch.sum(y.float() * torch.from_numpy(c)).backward()
    tol = GRAD_TOL if dtype == "float32" else dict(rtol=2 * BF16_ULP,
                                                   atol=1e-3)
    np.testing.assert_allclose(_np(tx.grad), _np(jdx), err_msg="dx", **tol)
    np.testing.assert_allclose(_np(tw.grad), _np(jdw), err_msg="dw", **tol)


def test_flash_wrapper_refuses_inputs_that_require_grad():
    """The bare wrapper records no gradient: it refuses rather than cut
    the chain, and points at ``FlashAttention``."""
    q = torch.zeros(1, 2, 4, 8, requires_grad=True)
    k = torch.zeros(1, 1, 4, 8)
    with pytest.raises(NotImplementedError, match="FlashAttention"):
        flash_attention(q, k, k)
    with torch.no_grad():
        o, _ = flash_attention(q, k, k)
    assert o.shape == (1, 2, 4, 8)
    assert math.isfinite(float(o.sum()))
