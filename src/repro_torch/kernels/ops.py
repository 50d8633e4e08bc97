"""Dispatch wrappers: hand-written CUDA kernel vs plain torch reference.

The model stack calls these; ``use_kernels`` selects the kernels of this
package (:mod:`.rmsnorm`, :mod:`.decode_attention`, :mod:`.ssd_scan`),
whose wrappers launch the CUDA kernel for CUDA tensors and run its plain
version for CPU tensors.  ``use_kernels=False`` selects :mod:`.ref`.  The
Pallas flash attention of the reference has no port yet (ROADMAP §B.4),
so asking for it raises.
"""

from __future__ import annotations

from . import decode_attention as _dec
from . import ref
from . import rmsnorm as _rms
from . import ssd_scan as _ssd


def attention(q, k, v, causal: bool = True, use_kernels: bool = False):
    if use_kernels:
        raise NotImplementedError(
            "flash_attention has no CUDA kernel yet (ROADMAP §B.4); the "
            "model's attention without a KV cache waits for it")
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
