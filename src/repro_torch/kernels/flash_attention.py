"""Causal GQA flash attention forward: the hand-written CUDA kernel and its
plain PyTorch version.

Replaces ``src/repro/kernels/flash_attention.py`` (``flash_attention`` →
``_fa_kernel``, a Pallas TPU kernel).  :func:`flash_attention` launches
``csrc/flash_attention.cu`` for CUDA tensors and calls
:func:`flash_attention_plain` for CPU tensors.  Both return the output
and the row log-sum-exp ``lse`` (float32), the residual the blocked
backward (:mod:`repro_torch.models.flash`) reads.  Both compute what the
Pallas kernel computes: f32 scores of q against k scaled by
``sm_scale``, the causal mask aligned to the key tail, the online
softmax in f32 over key tiles, and zeros for a row with no valid key.
For bfloat16 inputs the kernel runs both products on tensor cores, and
the plain version follows its arithmetic: ``sm_scale`` applied to the
f32 scores after the product, and P multiplied by V as two bfloat16
parts, ``hi = bf16(p)`` and ``lo = bf16(p - hi)`` (:func:`_p_operand`),
so that each p keeps about 16 significant bits.  For float32 inputs both
are the f32 function of the Pallas kernel, q scaled before the product.
One difference, where the Pallas kernel's output is an artifact of its
blocking: there a masked score still adds ``exp(NEG_INF - NEG_INF) = 1``
to a row that has seen no valid key yet, so a row with no valid key
returns zeros only when its whole q block is masked and otherwise the
mean of V over the blocks computed.  Here a masked score adds nothing,
so every such row returns zeros (ROADMAP §C.3); every other row is the
same function.

The gradient is :class:`repro_torch.models.flash.FlashAttention`, whose
forward calls :func:`flash_attention` and whose backward is the blocked
backward of ``models/flash.py``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..core.errors import InvalidArgError
from ._cuda import (DTYPE_CODES, CudaKernel, check_cuda_tensor, is_fake,
                    refuse_grad)

NEG_INF = -1e30
BLOCK_K = 64                 # the CUDA kernel's key tile
HEAD_DIMS = (64, 112, 128)   # the head sizes the kernel is instantiated for
#: query rows per CUDA block, by (dtype, head size): the tensor-core
#: path's 4 warps hold 32 rows each at D = 64 and 16 at D = 112 and 128
BLOCK_Q = {(torch.bfloat16, 64): 128, (torch.bfloat16, 112): 64,
           (torch.bfloat16, 128): 64, (torch.float32, 64): 64,
           (torch.float32, 112): 64, (torch.float32, 128): 64}

KERNEL = CudaKernel(
    "flash_attention", "flash_attention.cu", "flash_attention_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _scale(D: int, sm_scale: Optional[float]) -> float:
    return float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(D)


def _p_operand(p: torch.Tensor) -> torch.Tensor:
    """The probabilities as the tensor-core path multiplies them by V:
    ``hi + lo`` with ``hi = bf16(p)`` and ``lo = bf16(p - hi)``, in f32
    (the sum is exact)."""
    hi = p.to(torch.bfloat16).to(p.dtype)
    return hi + (p - hi).to(torch.bfloat16).to(p.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          sm_scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D) -> (o (B, H, Sq, D) in q's
    dtype, lse (B, H, Sq) float32).

    ``_fa_kernel`` op by op, for every q row at once, over
    :data:`BLOCK_K`-key tiles: q upcast and scaled, f32 scores, masked
    scores set to ``NEG_INF`` and given p = 0, the running max,
    normalizer and accumulator in f32; ``l == 0`` is taken as 1, and
    ``lse = m + log(l)``.  A bfloat16 q follows the tensor-core kernel:
    the scores are scaled after the product, and P enters the product
    with V as :func:`_p_operand`.  A tile wholly masked for a row leaves
    its m, l and acc bit for bit as they were (p = 0, alpha = 1), so the
    kernel's skipping of such tiles computes the same function.  A
    float64 q (which the kernel does not take) is computed, and its lse
    returned, in float64, for gradient checks."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    dev = q.device
    f32 = torch.promote_types(q.dtype, torch.float32)
    mma = q.dtype == torch.bfloat16      # the tensor-core path's arithmetic
    scale = _scale(D, sm_scale)
    qf = q.to(f32) if mma else q.to(f32) * scale
    kf = k.to(f32).repeat_interleave(G, dim=1) if G > 1 else k.to(f32)
    vf = v.to(f32).repeat_interleave(G, dim=1) if G > 1 else v.to(f32)
    rows = torch.arange(Sq, device=dev)[:, None] + (Sk - Sq)
    m = torch.full((B, H, Sq), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=f32, device=dev)
    acc = torch.zeros((B, H, Sq, D), dtype=f32, device=dev)
    for k0 in range(0, Sk, BLOCK_K):
        kb, vb = kf[:, :, k0:k0 + BLOCK_K], vf[:, :, k0:k0 + BLOCK_K]
        cols = k0 + torch.arange(kb.shape[2], device=dev)[None, :]
        ok = (cols <= rows) if causal else torch.ones_like(cols <= rows)
        s = torch.matmul(qf, kb.transpose(-1, -2))
        if mma:
            s = s * scale
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(
            _p_operand(p) if mma else p, vb)
        m = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).to(q.dtype), m + torch.log(l_safe)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D), all float32 or all
    bfloat16, Sq and Sk >= 1 -> (o in q's dtype, lse float32 (B, H, Sq)).

    CUDA tensors go to the kernel (checked for device, dtype, shape,
    head size and contiguity first; anything else raises); CPU tensors go
    to :func:`flash_attention_plain`.  It records no gradient and refuses
    an input that requires grad while grad mode is on: the gradient is
    :class:`repro_torch.models.flash.FlashAttention`'s."""
    refuse_grad("flash_attention", (q, k, v),
                "call repro_torch.models.flash.FlashAttention, whose "
                "backward is the blocked backward of models/flash.py")
    if is_fake(q, k, v):
        return torch.empty_like(q), torch.empty(
            q.shape[:3], dtype=torch.float32, device=q.device)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_plain(q, k, v, causal, sm_scale)
    if q.device.type != "cuda":
        raise InvalidArgError(f"flash_attention: q is on {q.device}; the "
                              f"kernel runs on CUDA tensors, the plain "
                              f"version on CPU tensors")
    if q.dim() != 4 or k.dim() != 4:
        raise InvalidArgError(f"flash_attention: q must be (B, H, Sq, D) "
                              f"and k, v (B, Hkv, Sk, D); got "
                              f"{tuple(q.shape)}, {tuple(k.shape)}")
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if Hkv == 0 or H % Hkv or D not in HEAD_DIMS or Sq < 1 or Sk < 1:
        raise InvalidArgError(
            f"flash_attention: H={H}, Hkv={Hkv}, D={D}, Sq={Sq}, Sk={Sk}; "
            f"the kernel needs H % Hkv == 0, D in {HEAD_DIMS} and Sq, "
            f"Sk >= 1")
    dev = q.device
    check_cuda_tensor("flash_attention q", q, dev, DTYPE_CODES)
    check_cuda_tensor("flash_attention k", k, dev, (q.dtype,),
                      (B, Hkv, Sk, D))
    check_cuda_tensor("flash_attention v", v, dev, (q.dtype,),
                      (B, Hkv, Sk, D))
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    if B == 0 or H == 0:
        return o, lse
    if q.dtype == torch.bfloat16:
        # the tensor-core path copies 16 bytes at a time; a view that
        # starts elsewhere is copied first
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    KERNEL.launch(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), lse.data_ptr(), B, H, Hkv, Sq, Sk, D,
                  _scale(D, sm_scale), int(bool(causal)),
                  DTYPE_CODES[q.dtype])
    return o, lse


__all__ = ["BLOCK_K", "BLOCK_Q", "HEAD_DIMS", "KERNEL", "flash_attention",
           "flash_attention_plain"]
