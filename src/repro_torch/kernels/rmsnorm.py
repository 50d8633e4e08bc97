"""RMSNorm with Vecmathlib's rsqrt: the hand-written CUDA kernel and its
plain PyTorch version.

Replaces ``src/repro/kernels/rmsnorm.py`` (``rmsnorm`` →
``_rmsnorm_kernel``, a Pallas TPU kernel).  :func:`rmsnorm` launches
``csrc/rmsnorm.cu`` for CUDA tensors and calls :func:`rmsnorm_plain` for
CPU tensors; :func:`rmsnorm_plain` computes what the Pallas kernel
computes (``use_vml=True``, its default): the mean of squares in f32, the
Newton rsqrt of :func:`repro_torch.vml.rsqrt`, the scaled row cast back to
x's dtype.
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


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d) in float32 or bfloat16; w: (d,) in float32 or bfloat16.

    CUDA tensors go to the kernel (checked for device, dtype, shape and
    contiguity first; anything else raises); CPU tensors go to
    :func:`rmsnorm_plain`."""
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


__all__ = ["KERNEL", "rmsnorm", "rmsnorm_plain"]
