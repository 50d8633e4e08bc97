"""RMSNorm with Vecmathlib's rsqrt: the hand-written CUDA kernel and its
plain PyTorch version.

Replaces ``src/repro/kernels/rmsnorm.py`` (``rmsnorm`` →
``_rmsnorm_kernel``, a Pallas TPU kernel).  :func:`rmsnorm` launches
``csrc/rmsnorm.cu`` for CUDA tensors and calls :func:`rmsnorm_plain` for
CPU tensors; :func:`rmsnorm_plain` computes what the Pallas kernel
computes (``use_vml=True``, its default): the mean of squares in f32, the
Newton rsqrt of :func:`repro_torch.vml.rsqrt`, the scaled row cast back to
x's dtype.

:func:`rmsnorm` is a ``torch.autograd.Function``: its forward is the
kernel (or the plain version), its backward the analytic RMSNorm
gradient in torch ops.  A wrapper that launched through ``ctypes`` and
returned a fresh tensor would have no ``grad_fn``: a training forward on
the card would give the norm weights no gradient and cut the chain at
every block, without an error.
"""

from __future__ import annotations

import ctypes

import torch

from .. import vml
from ..core.errors import InvalidArgError
from ._cuda import DTYPE_CODES, CudaKernel, check_cuda_tensor

KERNEL = CudaKernel(
    "rmsnorm", "rmsnorm.cu", "rmsnorm_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p])


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d); w: (d,).  What the Pallas kernel computes, in torch."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    r = vml.rsqrt(var + eps)
    return (xf * r * w.to(torch.float32)[None, :]).to(x.dtype)


def _rmsnorm_forward(x: torch.Tensor, w: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """The kernel for CUDA tensors (checked for device, dtype, shape and
    contiguity first; anything else raises), :func:`rmsnorm_plain` for
    CPU tensors."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return rmsnorm_plain(x, w, eps)
    if x.device.type != "cuda":
        raise InvalidArgError(f"rmsnorm: x is on {x.device}; the kernel "
                              f"runs on CUDA tensors, the plain version on "
                              f"CPU tensors")
    d = x.shape[-1]
    check_cuda_tensor("rmsnorm x", x, x.device, DTYPE_CODES)
    check_cuda_tensor("rmsnorm w", w, x.device, DTYPE_CODES, (d,))
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    KERNEL.launch(x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                  rows, d, eps, DTYPE_CODES[x.dtype], DTYPE_CODES[w.dtype])
    return out


class RMSNorm(torch.autograd.Function):
    """y = x * rsqrt(mean(x²) + eps) * w with a gradient.

    forward: :func:`_rmsnorm_forward`.  backward, in f32 with r =
    rsqrt(mean(x²) + eps) and g the incoming gradient:
    dw = Σ_rows g · x · r, and dx = r · (g·w − x · r² · mean(g·w·x)),
    each cast to its input's dtype."""

    @staticmethod
    def forward(ctx, x, w, eps: float = 1e-6):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rmsnorm_forward(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        f32 = torch.float32
        xf, gf = x.to(f32), g.to(f32)
        r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + ctx.eps)
        gw = gf * w.to(f32)
        dx = r * (gw - xf * (r * r)
                  * torch.mean(gw * xf, dim=-1, keepdim=True))
        dw = (gf * xf * r).reshape(-1, x.shape[-1]).sum(dim=0)
        return dx.to(x.dtype), dw.to(w.dtype), None


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d) in float32 or bfloat16; w: (d,) in float32 or bfloat16.

    CUDA tensors go to the kernel (checked for device, dtype, shape and
    contiguity first; anything else raises); CPU tensors go to
    :func:`rmsnorm_plain`.  Differentiable in x and w (:class:`RMSNorm`);
    a call that records no gradient skips the ``autograd.Function``,
    whose ``apply`` costs more host time than this launch-bound kernel
    takes on the card."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return RMSNorm.apply(x, w, eps)
    return _rmsnorm_forward(x, w, eps)


__all__ = ["KERNEL", "RMSNorm", "rmsnorm", "rmsnorm_plain"]
