"""Vecmathlib (paper §5): vectorized elemental functions on torch tensors.

The torch port of ``repro.vml.core``: bit manipulation (``fabs``,
``copysign``, ``signbit``, exponent surgery), Newton iteration
(``sqrt``, ``rsqrt``, ``reciprocal``), range reduction and a polynomial
(``exp``, ``log``, ``sin``/``cos``, ``tanh``, ``erf``), and the
activations built on them (``sigmoid``, ``silu``, ``gelu_tanh``).  Each
keeps the reference's operation order, so on the same float32 inputs it
gives the same bits.  The bit tricks use ``Tensor.view(torch.int32)``;
integer division and remainder are floor division and floor modulo and
float-to-int32 conversion saturates, as jnp's are.
``csrc/vml.cuh`` computes the same functions per work-item in CUDA C for
the ``cuda`` target's ``use_vml=True`` kernels.

All routines compute in float32 (upcasting half/bfloat16 inputs) and
return the input dtype; float64 inputs fall back to torch's own
functions, as the reference falls back to jnp's.
"""

from __future__ import annotations

import numpy as np
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
    if y.dtype == orig:
        return y
    if not orig.is_floating_point and orig != torch.bool:
        return _to_int(y, orig)
    return y.to(orig)


def _to_int(x, dt=_I32):
    """``x.astype(dt)`` with XLA's rules: out-of-range values saturate
    and NaN gives 0 (torch leaves both undefined)."""
    info = torch.iinfo(dt)
    hi = x >= float(info.max) + 1.0
    lo = x < float(info.min)
    r = torch.where(hi | lo | torch.isnan(x), torch.zeros_like(x), x).to(dt)
    r = torch.where(hi, torch.full_like(r, info.max), r)
    return torch.where(lo, torch.full_like(r, info.min), r)


def _full(x, v):
    return torch.full_like(x, v)


# ---------------------------------------------------------------------------
# bit-manipulation primitives (§5.1)
# ---------------------------------------------------------------------------

def _clear_sign(x):
    return (x.view(_I32) & 0x7FFFFFFF).view(_F32)


class _FabsF32(torch.autograd.Function):
    """Clearing the sign bit, with the gradient sign(x) · g.  The bit
    operations go through an int32 view, which autograd does not follow:
    without this the gradient through ``fabs`` is silently 0 (the
    reference gives ``_fabs_f32`` an explicit JVP for the same reason)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _clear_sign(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x < 0, -g, g)


def fabs(x):
    """Clear the sign bit."""
    x, orig = _prep(x)
    if x.dtype != _F32:
        return _fin(torch.abs(x), orig)
    if torch.is_grad_enabled() and x.requires_grad:
        return _fin(_FabsF32.apply(x), orig)
    return _fin(_clear_sign(x), orig)


_SIGN = -(1 << 31)     # 0x80000000 as an int32


def _copysign_bits(x, s):
    return ((x.view(_I32) & 0x7FFFFFFF) | (s.view(_I32) & _SIGN)).view(_F32)


class _CopysignF32(torch.autograd.Function):
    """Copying the sign bit, with the gradient ±g in x (negated where the
    signs of x and s differ) and none in s: the reference's
    ``_copysign_f32`` JVP."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.save_for_backward(x, s)
        return _copysign_bits(x, s)

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        flip = (x < 0) != (s < 0)
        gx = torch.where(flip, -g, g)
        if gx.shape != x.shape:
            gx = gx.sum_to_size(x.shape)
        return gx, None


def copysign(x, s):
    x, orig = _prep(x)
    s = torch.as_tensor(s, device=x.device).to(x.dtype)
    if x.dtype != _F32:
        return _fin(torch.copysign(x, s), orig)
    if torch.is_grad_enabled() and x.requires_grad:
        return _fin(_CopysignF32.apply(x, s), orig)
    return _fin(_copysign_bits(x, s), orig)


def signbit(x):
    x, _ = _prep(x)
    if x.dtype == _F32:
        return (x.view(_I32) >> 31) != 0
    return torch.signbit(x)


def _ldexp_f32(x, k):
    """x * 2^k via exponent-field addition (k int32, result float32)."""
    # split into two steps to stay in the normal range
    k1 = torch.div(k, 2, rounding_mode="floor")
    k2 = k - k1
    f1 = ((k1 + 127) << 23).view(_F32)
    f2 = ((k2 + 127) << 23).view(_F32)
    return x * f1 * f2


def _frexp_f32(x):
    """Return (mantissa in [sqrt(2)/2, sqrt(2)), exponent) for positive x."""
    bits = x.view(_I32)
    e = ((bits >> 23) & 0xFF) - 127
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(_F32)  # in [1, 2)
    # shift mantissa to [sqrt(2)/2, sqrt(2)) for symmetric log reduction
    big = m > 1.4142135623730951
    m = torch.where(big, m * 0.5, m)
    e = e + big.to(_I32)
    return m, e


# ---------------------------------------------------------------------------
# Newton iteration (§5.1)
# ---------------------------------------------------------------------------

def sqrt(x):
    x, orig = _prep(x)
    if x.dtype != _F32:
        return _fin(torch.sqrt(x), orig)
    # initial guess: halve the exponent with an integer shift
    r = ((x.view(_I32) >> 1) + 0x1FC00000).view(_F32)
    # Newton: r <- (r + x/r) / 2 ; three iterations double the digits each
    for _ in range(3):
        r = 0.5 * (r + x / r)
    r = torch.where(x > 0, r, torch.where(x == 0, _full(x, 0.0),
                                          _full(x, float("nan"))))
    r = torch.where(torch.isinf(x) & (x > 0), _full(x, float("inf")), r)
    return _fin(r, orig)


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


def reciprocal(x):
    """1/x via Newton on f(y)=1/y - x: y <- y*(2 - x*y)."""
    x, orig = _prep(x)
    if x.dtype != _F32:
        return _fin(1.0 / x, orig)
    y = (0x7EF311C3 - x.view(_I32)).view(_F32)
    for _ in range(3):
        y = y * (2.0 - x * y)
    one = torch.where(x == 0, _full(x, 1.0), x)
    y = torch.where(x == 0, float("inf") * torch.sign(1.0 / one), y)
    y = torch.where(torch.isinf(x), torch.zeros_like(x), y)
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


def log(x):
    x, orig = _prep(x)
    if x.dtype != _F32:
        return _fin(torch.log(x), orig)
    m, e = _frexp_f32(torch.clamp(x, min=1e-45))
    f = m - 1.0
    s = f / (2.0 + f)
    z = s * s
    r = 2.0 * s * horner(z, poly.LOG_COEFFS)
    y = r + e.to(_F32) * float(np.float32(poly.LN2))
    y = torch.where(x > 0, y, torch.where(x == 0, _full(x, -float("inf")),
                                          _full(x, float("nan"))))
    y = torch.where(torch.isinf(x) & (x > 0), _full(x, float("inf")), y)
    return _fin(y, orig)


def _sincos_reduce(x):
    """Reduce to r in [-pi/4, pi/4] and quadrant q (mod 4)."""
    q = torch.round(x * poly.INV_PI_2)
    qi = _to_int(q)
    r = x - q * poly.PIO2_HI
    r = r - q * poly.PIO2_MID
    r = r - q * poly.PIO2_LO
    return r, qi


def _sin_core(r):
    z = r * r
    return r + r * z * horner(z, poly.SIN_COEFFS)


def _cos_core(r):
    z = r * r
    return 1.0 - 0.5 * z + z * z * horner(z, poly.COS_COEFFS)


def _sign(pred, like):
    return torch.where(pred, _full(like, -1.0), _full(like, 1.0))


def sin(x):
    x, orig = _prep(x)
    if x.dtype != _F32:
        return _fin(torch.sin(x), orig)
    r, q = _sincos_reduce(x)
    # floor modulo, as jnp's % on int32 (a truncating % picks the wrong
    # quadrant for x < -pi/4)
    sc = torch.where(torch.remainder(q, 2) == 0, _sin_core(r), _cos_core(r))
    return _fin(_sign(torch.remainder(q, 4) >= 2, x) * sc, orig)


def cos(x):
    x, orig = _prep(x)
    if x.dtype != _F32:
        return _fin(torch.cos(x), orig)
    r, q = _sincos_reduce(x)
    sc = torch.where(torch.remainder(q, 2) == 0, _cos_core(r), _sin_core(r))
    return _fin(_sign(torch.remainder(q + 1, 4) >= 2, x) * sc, orig)


def tanh(x):
    x, orig = _prep(x)
    if x.dtype != _F32:
        return _fin(torch.tanh(x), orig)
    # tanh(x) = 1 - 2/(e^{2x}+1), clamped: |x|>9 saturates in f32
    xa = torch.clamp(x, -9.0, 9.0)
    e2 = exp(2.0 * xa)
    return _fin((e2 - 1.0) / (e2 + 1.0), orig)


def erf(x):
    x, orig = _prep(x)
    if x.dtype != _F32:
        return _fin(torch.special.erf(x), orig)
    a = fabs(x)
    t = 1.0 / (1.0 + poly.ERF_P * a)
    y = 1.0 - horner(t, poly.ERF_A) * t * exp(-a * a)
    return _fin(copysign(y, x), orig)


def sigmoid(x):
    x, orig = _prep(x)
    e = exp(-fabs(x).to(x.dtype))
    pos = 1.0 / (1.0 + e)
    y = torch.where(x >= 0, pos, 1.0 - pos)
    return _fin(y, orig)


def gelu_tanh(x):
    """GELU with the tanh approximation — the LM-stack consumer of vml."""
    x, orig = _prep(x)
    c = float(np.float32(0.7978845608028654))  # sqrt(2/pi)
    y = 0.5 * x * (1.0 + tanh(c * (x + 0.044715 * x * x * x)))
    return _fin(y, orig)


def silu(x):
    x, orig = _prep(x)
    return _fin(x * sigmoid(x), orig)


__all__ = ["exp", "log", "sin", "cos", "tanh", "erf", "sqrt", "rsqrt",
           "fabs", "copysign", "signbit", "reciprocal", "sigmoid",
           "gelu_tanh", "silu"]
