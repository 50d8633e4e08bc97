"""Model layers of the dense family, in torch.

The port of the part of ``repro.models.layers`` that a dense model runs:
``norm`` (RMSNorm), ``activation`` (silu), ``rope``, ``attention`` (with
and without a KV cache), the gated ``mlp`` and ``attn_block``.  The math
and the dtypes follow the reference (its einsums become matmuls in the
promoted dtype); the sharding annotations (``constrain``) are dropped, since
the port runs on one card.  Kernels are swapped in at the
:mod:`repro_torch.kernels.ops` dispatch layer.  MoE, Mamba-2, cross- and
encoder-decoder blocks wait for their families (ROADMAP A.8).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import vml
from ..kernels import ops
from ..kernels.ref import matmul
from .config import ModelConfig
from .flash import blocked_attention

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def norm(x, p: Params, cfg: ModelConfig, eps: float = 1e-6):
    return ops.rmsnorm(x, p["w"], eps=eps, use_kernels=cfg.use_kernels)


def activation(x, cfg: ModelConfig):
    return vml.silu(x) if cfg.use_vml_act else F.silu(x)


def rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs     # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------

def attention(x, p: Params, cfg: ModelConfig, *, positions,
              cache: Optional[Tuple] = None):
    """Causal self-attention with RoPE.  cache=(k_cache, v_cache, lengths)
    with the caches in (B, KV, S_cache, D) layout; returns (out,
    new_cache).

    With a cache, the new keys and values are written into ``k_cache``
    and ``v_cache`` in place (the reference rebuilt the caches
    functionally with ``dynamic_update_slice``); the returned caches are
    the same tensors."""
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q = matmul(x, p["wq"].reshape(d, H * hd)).view(B, S, H, hd)
    k = matmul(x, p["wk"].reshape(d, KV * hd)).view(B, S, KV, hd)
    v = matmul(x, p["wv"].reshape(d, KV * hd)).view(B, S, KV, hd)

    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        k_cache, v_cache, lengths = cache
        if S == 1:
            # decode: each batch row writes its new K/V at its OWN length
            # (continuous-batching slots sit at different positions), in
            # place, then attends over lengths + 1 keys.  The reference's
            # dynamic_update_slice clamps the start into the cache; so
            # does the clamp here.
            rows = torch.arange(B, device=x.device)
            pos = lengths.to(torch.int64).clamp(0, k_cache.shape[2] - 1)
            k_cache[rows, :, pos] = k[:, 0].to(k_cache.dtype)
            v_cache[rows, :, pos] = v[:, 0].to(v_cache.dtype)
            o = ops.decode_attention(q[:, 0], k_cache, v_cache, lengths + 1,
                                     use_kernels=cfg.use_kernels)
            out = o[:, None]                          # (B,1,H,D)
            new_cache = (k_cache, v_cache, lengths + 1)
        else:
            # prefill: attend causally over the fresh K/V, then write the
            # whole prompt into the cache at position 0, in place
            out = blocked_attention(q, k, v, causal=True,
                                    block_q=cfg.attn_block_q,
                                    block_k=cfg.attn_block_k)
            k_cache[:, :, :S] = k.transpose(1, 2).to(k_cache.dtype)
            v_cache[:, :, :S] = v.transpose(1, 2).to(v_cache.dtype)
            new_cache = (k_cache, v_cache, lengths + S)
    else:
        if cfg.use_kernels and S <= 4096:
            # the reference's Pallas branch (layers.py:130): its flash
            # kernel has no port yet, so this raises (ROADMAP §B.4)
            out = ops.attention(q, k, v, use_kernels=True)
        else:
            out = blocked_attention(q, k, v, causal=True,
                                    block_q=cfg.attn_block_q,
                                    block_k=cfg.attn_block_k)

    y = matmul(out.reshape(B, S, H * hd), p["wo"].reshape(H * hd, d))
    return y, new_cache


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def mlp(x, p: Params, cfg: ModelConfig):
    """The gated MLP: activation(x @ w_gate) * (x @ w_up) @ w_down."""
    h = matmul(x, p["w_up"])
    h = activation(matmul(x, p["w_gate"]), cfg) * h
    return matmul(h, p["w_down"])


# ---------------------------------------------------------------------------
# residual block
# ---------------------------------------------------------------------------

def attn_block(x, p: Params, cfg: ModelConfig, *, positions, cache=None):
    """pre-norm attention + FFN block; returns (x, new_cache).  (The
    reference also returns the MoE aux loss, always 0 in a dense block.)"""
    h, new_cache = attention(norm(x, p["ln1"], cfg), p["attn"], cfg,
                             positions=positions, cache=cache)
    x = x + h
    h = mlp(norm(x, p["ln2"], cfg), p["ffn"], cfg)
    return x + h, new_cache


__all__ = ["activation", "attention", "attn_block", "mlp", "norm", "rope"]
