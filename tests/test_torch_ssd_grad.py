"""The gradient of the port's SSD scan (``repro_torch.kernels.ssd_scan``
``SSDScan``) held against ``jax.grad`` of the reference's
``repro.kernels.ref.ssd_scan`` on the CPU.

The same seeded numpy inputs (``tests/test_torch_ssd.py``'s) go through
both.  The loss is a seeded weighting of y, of the final state, or of
both (ROADMAP C.4: the state's gradient is checked too, since serving
carries the state and a scan's backward may drop it).  Where s is not a
multiple of the chunk, the reference's inputs are padded to whole chunks
with zeros (dt = 0 on the padded steps, which leaves the state as it
was), as the models pad them, and the padded steps' y is dropped.  The
port's scan takes any length itself: its forward is the kernel's plain
version here (CPU tensors), its backward the gradient of the port's
``ref.ssd_scan`` on the same padding.

Tolerances: float32 gradients within ``rtol=1e-4`` and ``1e-6`` of the
largest entry of each (``tests/test_torch_training.py``'s: each sums over
chunks and positions in another order on each side).  bfloat16 inputs:
both sides differentiate the reference's scan in bfloat16 (its ``C Bᵀ``
and the gradients' products are bfloat16 where both operands are) and
round in other places, so ``rtol=3e-2`` and ``2e-2`` of the largest entry
(``tests/test_kernels.py``'s bfloat16 tolerance, at the gradients'
size); the reference runs op by op (``jax.disable_jit``), as the port
does.  A backward that recomputes with dt one step off must fail the
float32 limit.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402

from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from test_torch_ssd import _both, _inputs, _np  # noqa: E402

TOL = {"float32": (1e-4, 1e-6), "bfloat16": (3e-2, 2e-2)}

# b, s, h, p, g, n, chunk: whole chunks, a ragged s, groups, one chunk
# shorter than the chunk size
CASES = [(2, 16, 4, 8, 1, 16, 8), (2, 13, 4, 8, 2, 16, 8),
         (1, 24, 6, 16, 3, 8, 8), (2, 5, 2, 8, 1, 16, 8)]


def _weights(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            rng.standard_normal((b, h, p, n)).astype(np.float32))


def _jax_grads(arrays, wy, ws, chunk, through):
    """``jax.grad`` of the weighted y and/or state of the reference's
    scan, its inputs padded to whole chunks with zeros."""
    s = arrays[0].shape[1]
    L = min(chunk, s)
    pad = (-s) % L

    def f(x, dt, A, B, C):
        def padded(t):
            return jnp.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))
        y, st = jref.ssd_scan(padded(x), padded(dt), A, padded(B),
                              padded(C), chunk=L, return_state=True)
        out = 0.0
        if "y" in through:
            out = out + jnp.sum(y[:, :s].astype(jnp.float32) * wy)
        if "state" in through:
            out = out + jnp.sum(st * ws)
        return out
    return jax.grad(f, argnums=(0, 1, 2, 3, 4))(*arrays)


def _torch_grads(arrays, wy, ws, chunk, through):
    ts = [t.clone().requires_grad_(True) for t in arrays]
    y, st = tssd.ssd_scan(*ts, chunk=chunk)
    assert y.grad_fn is not None and st.grad_fn is not None
    out = 0.0
    if "y" in through:
        out = out + torch.sum(y.to(torch.float32) * torch.from_numpy(wy))
    if "state" in through:
        out = out + torch.sum(st * torch.from_numpy(ws))
    return torch.autograd.grad(out, ts)


def _assert_close(got, want, dtype):
    rtol, atol_rel = TOL[dtype]
    for name, g, w in zip("x dt A B C".split(), got, want):
        assert g.dtype == (torch.float32 if name == "A"
                           else getattr(torch, dtype)), name
        w = _np(w)
        np.testing.assert_allclose(_np(g), w, rtol=rtol,
                                   atol=atol_rel * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("through", ["y", "state", "y+state"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CASES)
def test_gradients_match_reference(b, s, h, p, g, n, chunk, dtype, through):
    (jx, jdt, jA, jB, jC), targs = _both(
        _inputs(b, s, h, p, g, n, seed=100 + s + g), dtype)
    wy, ws = _weights(b, s, h, p, n, seed=200 + s)
    if dtype == "bfloat16":
        with jax.disable_jit():
            want = _jax_grads((jx, jdt, jA, jB, jC), wy, ws, chunk, through)
    else:
        want = _jax_grads((jx, jdt, jA, jB, jC), wy, ws, chunk, through)
    got = _torch_grads(targs, wy, ws, chunk, through)
    _assert_close(got, want, dtype)


def dt_shifted(real):
    """``ssd_scan_reference`` given dt shifted by one step (step t takes
    step t + 1's dt, the last repeated): a backward recomputing from the
    wrong steps.  The forward is untouched."""
    def shifted(x, dt, A, B, C, chunk=64):
        return real(x, torch.cat([dt[:, 1:], dt[:, -1:]], 1), A, B, C, chunk)
    return shifted


@pytest.mark.parametrize("through", ["y", "state"])
def test_dt_shifted_backward_fails_the_limit(monkeypatch, through):
    b, s, h, p, g, n, chunk = CASES[1]
    (jx, jdt, jA, jB, jC), targs = _both(
        _inputs(b, s, h, p, g, n, seed=100 + s + g), "float32")
    wy, ws = _weights(b, s, h, p, n, seed=200 + s)
    want = _jax_grads((jx, jdt, jA, jB, jC), wy, ws, chunk, through)
    monkeypatch.setattr(tssd, "ssd_scan_reference",
                        dt_shifted(tssd.ssd_scan_reference))
    got = _torch_grads(targs, wy, ws, chunk, through)
    with pytest.raises(AssertionError):
        _assert_close(got, want, "float32")


def test_no_grad_records_nothing_and_unused_inputs_get_no_gradient():
    """Without grad mode the scan's outputs have no ``grad_fn``; with
    only x requiring grad, only x gets a gradient, and a y that nothing
    reads back leaves the state's path out of the backward."""
    x, dt, A, B, C = [torch.from_numpy(a)
                      for a in _inputs(1, 16, 4, 8, 1, 16, seed=5)]
    with torch.no_grad():
        y, st = tssd.ssd_scan(x, dt, A, B, C, chunk=8)
    assert y.grad_fn is None and st.grad_fn is None
    xr = x.clone().requires_grad_(True)
    y, _ = tssd.ssd_scan(xr, dt, A, B, C, chunk=8)
    (gx,) = torch.autograd.grad(y.sum(), [xr])
    ry, _ = tssd.ssd_scan_reference(xr, dt, A, B, C, chunk=8)
    (rx,) = torch.autograd.grad(ry.sum(), [xr])
    assert torch.equal(gx, rx)
