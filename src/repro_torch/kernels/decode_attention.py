"""Single-token decode attention over a KV cache: the hand-written CUDA
kernel and its plain PyTorch version.

Replaces ``src/repro/kernels/decode_attention.py`` (``decode_attention`` →
``_dec_kernel``, a Pallas TPU kernel).  :func:`decode_attention` launches
``csrc/decode_attention.cu`` for CUDA tensors and calls
:func:`decode_attention_plain` for CPU tensors.  Both compute what the
Pallas kernel computes, including its behaviour on a row with no valid
key: zeros (ROADMAP §C, "Rows with no valid key"), where
:func:`repro_torch.kernels.ref.decode_attention` returns the mean of V.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..core.errors import InvalidArgError
from ._cuda import DTYPE_CODES, CudaKernel, check_cuda_tensor

NEG_INF = -1e30
BLOCK_K = 256                # the Pallas kernel's default key block
MAX_HEAD_DIM = 256           # the kernel keeps D / 32 dims per lane
MAX_GROUP = 32               # one warp per query head of a KV group

KERNEL = CudaKernel(
    "decode_attention", "decode_attention.cu", "decode_attention_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, D); caches: (B, Hkv, S, D); lengths: (B,) -> (B, H, D).

    The Pallas kernel's online softmax over :data:`BLOCK_K`-key blocks,
    scores scaled by 1/sqrt(D), in f32, written for all rows at once: a
    block at or past a row's length leaves that row's state untouched
    (the kernel's ``pl.when``), and a row whose normalizer stays 0
    returns zeros."""
    B, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    bk = min(BLOCK_K, S)
    scale = 1.0 / math.sqrt(D)
    lens = lengths.to(device=q.device, dtype=torch.int64)
    qf = q.to(torch.float32).reshape(B, Hkv, G, D) * scale
    m = torch.full((B, Hkv, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, S, bk):
        kb = k_cache[:, :, k0:k0 + bk].to(torch.float32)
        vb = v_cache[:, :, k0:k0 + bk].to(torch.float32)
        s = torch.matmul(qf, kb.transpose(-1, -2))              # (B,Hkv,G,bk)
        cols = k0 + torch.arange(kb.shape[2], device=q.device)
        s = torch.where(cols[None, None, None, :] < lens[:, None, None, None],
                        s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l_new = alpha * l + p.sum(dim=-1)
        acc_new = acc * alpha[..., None] + torch.matmul(p, vb)
        active = (k0 < lens)[:, None, None]
        m = torch.where(active, m_new, m)
        l = torch.where(active, l_new, l)
        acc = torch.where(active[..., None], acc_new, acc)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l[..., None]).to(q.dtype).reshape(B, H, D)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, D) and caches (B, Hkv, S, D) in float32 or bfloat16 (a
    bfloat16 q takes a bfloat16 cache); lengths: (B,) int32 -> (B, H, D)
    in q's dtype.

    CUDA tensors go to the kernel (checked for device, dtype, shape and
    contiguity first; anything else raises); CPU tensors go to
    :func:`decode_attention_plain`."""
    tensors = (q, k_cache, v_cache, lengths)
    if all(t.device.type == "cpu" for t in tensors):
        return decode_attention_plain(q, k_cache, v_cache, lengths)
    if q.device.type != "cuda":
        raise InvalidArgError(f"decode_attention: q is on {q.device}; the "
                              f"kernel runs on CUDA tensors, the plain "
                              f"version on CPU tensors")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise InvalidArgError(f"decode_attention: q must be (B, H, D) and "
                              f"the caches (B, Hkv, S, D); got "
                              f"{tuple(q.shape)}, {tuple(k_cache.shape)}")
    B, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    if Hkv == 0 or H % Hkv or H // Hkv > MAX_GROUP or D > MAX_HEAD_DIM:
        raise InvalidArgError(
            f"decode_attention: H={H}, Hkv={Hkv}, D={D}; the kernel needs "
            f"H % Hkv == 0, H / Hkv <= {MAX_GROUP} and D <= {MAX_HEAD_DIM}")
    dev = q.device
    check_cuda_tensor("decode_attention q", q, dev, DTYPE_CODES)
    # a bfloat16 q comes with the bfloat16 cache the model always keeps;
    # the kernel is not built for a bfloat16 q over a float32 cache
    cache_dtypes = (torch.bfloat16,) if q.dtype == torch.bfloat16 \
        else DTYPE_CODES
    check_cuda_tensor("decode_attention k_cache", k_cache, dev, cache_dtypes,
                      (B, Hkv, S, D))
    check_cuda_tensor("decode_attention v_cache", v_cache, dev,
                      (k_cache.dtype,), (B, Hkv, S, D))
    check_cuda_tensor("decode_attention lengths", lengths, dev,
                      (torch.int32,), (B,))
    out = torch.empty((B, H, D), dtype=q.dtype, device=dev)
    if B == 0 or H == 0 or D == 0:
        return out
    KERNEL.launch(dev, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(), B, H, Hkv, S, D,
                  1.0 / math.sqrt(D), DTYPE_CODES[q.dtype],
                  DTYPE_CODES[k_cache.dtype])
    return out


__all__ = ["KERNEL", "decode_attention", "decode_attention_plain"]
