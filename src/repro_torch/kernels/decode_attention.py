"""Single-token decode attention over a KV cache: the hand-written CUDA
kernel and its plain PyTorch version.

Replaces ``src/repro/kernels/decode_attention.py`` (``decode_attention`` →
``_dec_kernel``, a Pallas TPU kernel).  :func:`decode_attention` launches
``csrc/decode_attention.cu`` for CUDA tensors and calls
:func:`decode_attention_plain` for CPU tensors.  Both compute what the
Pallas kernel computes, including its behaviour on a row with no valid
key: zeros (ROADMAP §C, "Rows with no valid key"), where
:func:`repro_torch.kernels.ref.decode_attention` returns the mean of V.
Both cut the cache into the splits of :func:`split_plan`, take each
split's softmax state (m, l, acc) in f32, and combine the splits'
states (flash-decoding).
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..core.errors import InvalidArgError
from ._cuda import (DTYPE_CODES, CudaKernel, check_cuda_tensor, is_fake,
                    refuse_grad)

NEG_INF = -1e30
TILE = 64                    # the CUDA kernel's key tile
TARGET_BLOCKS = 2 * 132      # two blocks for each SM of an H100
MAX_HEAD_DIM = 256           # a block's 128 threads hold the G * D outputs,
MAX_GROUP = 32               # 32 pairs of dims each at most

KERNEL = CudaKernel(
    "decode_attention", "decode_attention.cu", "decode_attention_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def split_plan(B: int, Hkv: int, S: int) -> Tuple[int, int]:
    """(n_split, keys_per_split) for a cache of capacity S: whole
    :data:`TILE`-key tiles per split, the splits covering S once, and as
    many splits as give the kernel's grid (B * Hkv, n_split) at least
    :data:`TARGET_BLOCKS` blocks where S has that many tiles.  It reads
    shapes only, never the lengths: the wrapper does not synchronise."""
    tiles = max(1, -(-S // TILE))
    want = -(-TARGET_BLOCKS // max(1, B * Hkv))
    per_split = max(1, tiles // want)
    return -(-tiles // per_split), per_split * TILE


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, D); caches: (B, Hkv, S, D); lengths: (B,) -> (B, H, D).

    The kernel's function in f32, every split at once: scores scaled by
    1/sqrt(D), keys at or past a row's length masked; per split of
    :func:`split_plan`, m = the max score (``NEG_INF`` for a split with
    no valid key), l = the sum of p = exp(s - m) over its valid keys and
    acc = p . V; then M = max m, L = sum e^(m - M) l and the output
    sum e^(m - M) acc / L, with L = 0 taken as 1, so a row with no valid
    key returns zeros."""
    B, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    n_split, kps = split_plan(B, Hkv, S)
    dev = q.device
    lens = lengths.to(device=dev, dtype=torch.int64).clamp(max=S)
    pad = (0, 0, 0, n_split * kps - S)
    kf = F.pad(k_cache.to(torch.float32), pad).reshape(B, Hkv, n_split, kps,
                                                       D)
    vf = F.pad(v_cache.to(torch.float32), pad).reshape(B, Hkv, n_split, kps,
                                                       D)
    qf = q.to(torch.float32).reshape(B, Hkv, 1, G, D) * (1.0 / math.sqrt(D))
    s = torch.matmul(qf, kf.transpose(-1, -2))          # (B,Hkv,n,G,kps)
    keys = torch.arange(n_split * kps, device=dev).reshape(n_split, 1, kps)
    ok = keys < lens[:, None, None, None, None]         # (B,1,n,1,kps)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                  # (B,Hkv,n,G)
    p = torch.where(ok, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.matmul(p, vf)                           # (B,Hkv,n,G,D)
    M = m.amax(dim=2, keepdim=True)
    w = torch.exp(m - M)
    L = (w * l).sum(dim=2)
    o = (w[..., None] * acc).sum(dim=2)
    L = torch.where(L == 0.0, torch.ones_like(L), L)
    return (o / L[..., None]).to(q.dtype).reshape(B, H, D)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, D) and caches (B, Hkv, S, D) in float32 or bfloat16 (a
    bfloat16 q takes a bfloat16 cache); lengths: (B,) int32 -> (B, H, D)
    in q's dtype.

    CUDA tensors go to the kernel (checked for device, dtype, shape and
    contiguity first; anything else raises); CPU tensors go to
    :func:`decode_attention_plain`.  It has no backward and refuses an
    input that requires grad while grad mode is on."""
    tensors = (q, k_cache, v_cache, lengths)
    refuse_grad("decode_attention", tensors,
                "no training path runs decode attention; a backward waits "
                "for one (ROADMAP §B.2)")
    if is_fake(*tensors):
        return torch.empty_like(q)
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
    n_split, kps = split_plan(B, Hkv, S)
    part = torch.empty((B, H, n_split, D + 2), dtype=torch.float32,
                       device=dev)
    KERNEL.launch(dev, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(), part.data_ptr(), B, H,
                  Hkv, S, D, 1.0 / math.sqrt(D), n_split, kps,
                  DTYPE_CODES[q.dtype], DTYPE_CODES[k_cache.dtype])
    return out


__all__ = ["KERNEL", "TILE", "decode_attention", "decode_attention_plain",
           "split_plan"]
