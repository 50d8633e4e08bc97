"""Plain torch references for the model kernels: the ``use_kernels=False``
path of :mod:`repro_torch.kernels.ops`.

The torch port of the part of ``repro.kernels.ref`` the serving path
calls.  Each keeps the reference's dtypes: a product of two bfloat16
operands gives bfloat16, and the decode scores are taken in the cache's
dtype before the f32 softmax.
"""

from __future__ import annotations

import math

import torch


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two, as jnp.einsum does."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, Hkv, S, D) -> (B, Hkv*n_rep, S, D) for GQA."""
    if n_rep == 1:
        return k
    b, h, s, d = k.shape
    return k[:, :, None].expand(b, h, n_rep, s, d).reshape(b, h * n_rep, s, d)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """Full attention.  q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D)."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(D)
    k = repeat_kv(k, H // Hkv)
    v = repeat_kv(v, H // Hkv)
    # preferred_element_type=f32: products of the operands, summed in f32
    s = torch.matmul(q.to(torch.float32),
                     k.to(torch.float32).transpose(-1, -2)) * scale
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        ki = torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(ki <= qi, s,
                        torch.full_like(s, torch.finfo(torch.float32).min))
    p = torch.softmax(s, dim=-1)
    return matmul(p.to(v.dtype), v)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """One-token attention against a KV cache.

    q: (B, H, D); caches: (B, Hkv, S, D); lengths: (B,) valid prefix sizes.
    The output has the cache's dtype, as the reference's einsum over the
    probabilities cast to it does.
    """
    B, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    scale = 1.0 / math.sqrt(D)
    rep = H // Hkv
    qg = q.reshape(B, Hkv, rep, D)
    s = matmul(qg, k_cache.transpose(-1, -2)).to(torch.float32) * scale
    mask = torch.arange(S, device=q.device)[None, None, None, :] \
        < lengths.to(q.device)[:, None, None, None]
    s = torch.where(mask, s,
                    torch.full_like(s, torch.finfo(torch.float32).min))
    p = torch.softmax(s, dim=-1)
    o = matmul(p.to(v_cache.dtype), v_cache)
    return o.reshape(B, H, D)


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(torch.float32)).to(dt)


__all__ = ["attention", "decode_attention", "matmul", "repeat_kv",
           "rmsnorm"]
