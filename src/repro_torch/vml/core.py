"""Vecmathlib (paper §5): vectorized elemental functions on torch tensors.

The torch port of the part of ``repro.vml.core`` the serving path calls:
``fabs`` (bit manipulation), ``rsqrt`` (a magic-constant guess and
Newton steps, which the rmsnorm kernel also computes in CUDA C),
``exp`` (range reduction and a polynomial), and ``sigmoid``/``silu``
(the MLP activation).  Each keeps the reference's operation order, so on
the same float32 inputs it gives the same bits.  The bit tricks use
``Tensor.view(torch.int32)``.

All routines compute in float32 (upcasting half/bfloat16 inputs) and
return the input dtype; float64 inputs fall back to torch's own
functions, as the reference falls back to jnp's.
"""

from __future__ import annotations

import torch

from . import poly
from .poly import horner

_F32 = torch.float32
_I32 = torch.int32


def _prep(x):
    x = torch.as_tensor(x)
    orig = x.dtype
    if x.dtype not in (torch.float32, torch.float64):
        x = x.to(_F32)
    return x, orig


def _fin(y, orig):
    return y.to(orig) if y.dtype != orig else y


# ---------------------------------------------------------------------------
# bit-manipulation primitives (§5.1)
# ---------------------------------------------------------------------------

def fabs(x):
    """Clear the sign bit."""
    x, orig = _prep(x)
    if x.dtype == _F32:
        return _fin((x.view(_I32) & 0x7FFFFFFF).view(_F32), orig)
    return _fin(torch.abs(x), orig)


def _ldexp_f32(x, k):
    """x * 2^k via exponent-field addition (k int32, result float32)."""
    # split into two steps to stay in the normal range
    k1 = torch.div(k, 2, rounding_mode="floor")
    k2 = k - k1
    f1 = ((k1 + 127) << 23).view(_F32)
    f2 = ((k2 + 127) << 23).view(_F32)
    return x * f1 * f2


# ---------------------------------------------------------------------------
# Newton iteration (§5.1)
# ---------------------------------------------------------------------------

def rsqrt(x):
    x, orig = _prep(x)
    if x.dtype != _F32:
        return _fin(1.0 / torch.sqrt(x), orig)
    bits = x.view(_I32)
    y = (0x5F3759DF - (bits >> 1)).view(_F32)  # magic initial guess
    for _ in range(3):
        y = y * (1.5 - 0.5 * x * y * y)
    inf = torch.full_like(x, float("inf"))
    nan = torch.full_like(x, float("nan"))
    y = torch.where(x > 0, y, torch.where(x == 0, inf, nan))
    y = torch.where(torch.isinf(x) & (x > 0), torch.zeros_like(x), y)
    return _fin(y, orig)


# ---------------------------------------------------------------------------
# range reduction + polynomial (§5.1)
# ---------------------------------------------------------------------------

def exp(x):
    x, orig = _prep(x)
    if x.dtype != _F32:
        return _fin(torch.exp(x), orig)
    xc = torch.clamp(x, -87.3, 88.72)
    k = torch.round(xc * poly.INV_LN2)
    ki = k.to(_I32)
    # Cody–Waite: r = x - k*ln2 computed in two pieces for accuracy
    r = xc - k * poly.LN2_HI
    r = r - k * poly.LN2_LO
    p = horner(r, poly.EXP_COEFFS)
    er = 1.0 + r + r * r * p
    y = _ldexp_f32(er, ki)
    # saturate outside the clamp range (incl. +/-inf inputs)
    y = torch.where(x >= 88.72, torch.full_like(y, float("inf")), y)
    y = torch.where(x <= -87.3, torch.zeros_like(y), y)
    y = torch.where(torch.isnan(x), torch.full_like(y, float("nan")), y)
    return _fin(y, orig)


def sigmoid(x):
    x, orig = _prep(x)
    e = exp(-fabs(x).to(x.dtype))
    pos = 1.0 / (1.0 + e)
    y = torch.where(x >= 0, pos, 1.0 - pos)
    return _fin(y, orig)


def silu(x):
    x, orig = _prep(x)
    return _fin(x * sigmoid(x), orig)


__all__ = ["exp", "fabs", "rsqrt", "sigmoid", "silu"]
