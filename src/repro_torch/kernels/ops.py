"""Dispatch wrappers: hand-written CUDA kernel vs plain torch reference.

The model stack calls these; ``use_kernels`` selects the kernels of this
package (:mod:`.rmsnorm`, :mod:`.decode_attention`, :mod:`.ssd_scan`,
:mod:`.flash_attention`), whose wrappers launch the CUDA kernel for CUDA
tensors and run its plain version for CPU tensors.  ``use_kernels=False``
selects :mod:`.ref`.  Attention with kernels goes through
:class:`repro_torch.models.flash.FlashAttention`, the flash kernel's
forward with the blocked backward of ``models/flash.py``.
"""

from __future__ import annotations

from . import decode_attention as _dec
from . import ref
from . import rmsnorm as _rms
from . import ssd_scan as _ssd


def attention(q, k, v, causal: bool = True, use_kernels: bool = False,
              block_q: int = 512, block_k: int = 1024):
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D).  With kernels, the
    backward runs in ``(block_q, block_k)`` blocks; the reference ignores
    the block sizes."""
    if use_kernels:
        # imported here: repro_torch.models imports this package
        from ..models.flash import FlashAttention
        return FlashAttention.apply(q, k, v, causal, None, block_q, block_k)
    return ref.attention(q, k, v, causal=causal)


def decode_attention(q, k_cache, v_cache, lengths, use_kernels: bool = False):
    if use_kernels:
        return _dec.decode_attention(q, k_cache, v_cache, lengths)
    return ref.decode_attention(q, k_cache, v_cache, lengths)


def rmsnorm(x, w, eps: float = 1e-6, use_kernels: bool = False):
    if use_kernels:
        return _rms.rmsnorm(x, w, eps=eps)
    return ref.rmsnorm(x, w, eps=eps)


def ssd_scan(x, dt, A, B, C, chunk: int = 64, use_kernels: bool = False):
    """Returns (y, final_state) either way."""
    if use_kernels:
        return _ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)
    return ref.ssd_scan(x, dt, A, B, C, chunk=chunk, return_state=True)


__all__ = ["attention", "decode_attention", "rmsnorm", "ssd_scan"]
