"""Model layers of the dense and ssm families, in torch.

The port of the part of ``repro.models.layers`` that those models run:
``norm`` (RMSNorm), ``activation`` (silu), ``rope``, ``attention`` (with
and without a KV cache), the gated ``mlp`` and ``attn_block``; the
Mamba-2 mixer (``_causal_conv``, ``mamba2``) and ``mamba_block``.  The
math and the dtypes follow the reference (its einsums become matmuls in
the promoted dtype); the sharding annotations (``constrain``) are
dropped, since the port runs on one card.  Kernels are swapped in at the
:mod:`repro_torch.kernels.ops` dispatch layer.  MoE, cross- and
encoder-decoder blocks wait for their families (ROADMAP A.8).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import vml
from ..kernels import ops
from ..kernels.ref import matmul, promoted
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
            # the reference's Pallas branch (layers.py:130), with its
            # layout repaired (ROADMAP §C.2): the flash kernel takes
            # (B, H, S, D), so q/k/v go over and the output comes back
            out = ops.attention(
                q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(), causal=True, use_kernels=True,
                block_q=cfg.attn_block_q, block_k=cfg.attn_block_k,
            ).transpose(1, 2)
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


# ---------------------------------------------------------------------------
# Mamba-2 (SSD) mixer
# ---------------------------------------------------------------------------

def _causal_conv(u, w, b, state=None):
    """Depthwise causal conv.  u: (B,S,C), w: (W,C).  With ``state``
    ((B,W-1,C)) performs a streaming step update (decode) and returns the
    new window too."""
    W = w.shape[0]
    if state is not None:
        window = torch.cat(promoted(state, u), dim=1)     # (B,W,C) for S=1
        y = torch.einsum("bwc,wc->bc", *promoted(window[:, -W:], w))
        return (y + b)[:, None], window[:, 1:]
    pad = F.pad(u, (0, 0, W - 1, 0))
    S = u.shape[1]
    y = 0
    for i in range(W):
        y = y + pad[:, i:i + S] * w[i]
    return y + b, None


def _conv_window(u_raw, W: int):
    """The streaming window a prefill leaves for decode: the last W-1
    pre-conv inputs, left-padded with zeros when the prompt is shorter
    (the zeros the causal conv padded it with)."""
    tail = u_raw[:, max(0, u_raw.shape[1] - (W - 1)):]
    short = (W - 1) - tail.shape[1]
    return F.pad(tail, (0, 0, short, 0)) if short else tail


def _pad_steps(t, pad: int):
    """``t`` (b, s, ...) with ``pad`` zero steps appended on axis 1."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t


def mamba2(x, p: Params, cfg: ModelConfig, *, cache: Optional[Tuple] = None):
    """Mamba-2 SSD mixer.  cache=(conv_x, conv_B, conv_C, ssd_state); with
    one token it is a decode step, with more a prefill that starts from
    a zero state.  Returns (out, new_cache).

    Two differences from the reference, both where its cache would be
    wrong: a scan of any length is taken (the reference asserts a
    prefill needs no padding), and a prompt shorter than W-1 leaves a
    zero-padded conv window.  The kernel takes a ragged last chunk
    itself; for the torch ref, whose scan needs whole chunks, the scan
    is padded to a multiple of ``ssm_chunk`` with dt = 0, which leaves
    the state exactly as the last real token left it.  The decode step is
    plain torch, as the reference's is plain jnp."""
    B, S, _ = x.shape
    Hh, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    Gq = cfg.ssm_groups

    z = matmul(x, p["w_z"])
    u = matmul(x, p["w_x"])
    Bp = matmul(x, p["w_B"])
    Cp = matmul(x, p["w_C"])
    dt = matmul(x, p["w_dt"])

    decode = cache is not None and S == 1
    cx = cB = cC = st = None
    if decode:
        cx, cB, cC, st = cache
    # conv state = the last (W-1) PRE-conv inputs (streaming window)
    W = cfg.ssm_conv
    u_raw, B_raw, C_raw = u, Bp, Cp
    u, ncx = _causal_conv(u, p["conv_x_w"], p["conv_x_b"], cx)
    Bp, ncB = _causal_conv(Bp, p["conv_B_w"], p["conv_B_b"], cB)
    Cp, ncC = _causal_conv(Cp, p["conv_C_w"], p["conv_C_b"], cC)
    u, Bp, Cp = activation(u, cfg), activation(Bp, cfg), activation(Cp, cfg)

    xs = u.reshape(B, S, Hh, P)
    Bm = Bp.reshape(B, S, Gq, N)
    Cm = Cp.reshape(B, S, Gq, N)
    dt = _softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"].to(torch.float32))

    new_cache = None
    if decode:
        y, new_state = ops.ref.ssd_decode_step(
            st, xs[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
        y = y[:, None]
        new_cache = (ncx, ncB, ncC, new_state)
    else:
        pad = 0 if cfg.use_kernels else (-S) % cfg.ssm_chunk
        # dt = 0 on the padded steps: exp(0 * A) = 1 leaves the state as
        # it was and no input enters; their y is dropped
        y, final_state = ops.ssd_scan(
            _pad_steps(xs, pad), _pad_steps(dt, pad), A,
            _pad_steps(Bm, pad), _pad_steps(Cm, pad),
            chunk=cfg.ssm_chunk, use_kernels=cfg.use_kernels)
        y = y[:, :S]
        if cache is not None:   # prefill: stash streaming window + state
            new_cache = (_conv_window(u_raw, W), _conv_window(B_raw, W),
                         _conv_window(C_raw, W), final_state)

    y = y.to(x.dtype) + xs * p["D"][None, None, :, None].to(xs.dtype)
    y = y.reshape(B, S, Hh * P)
    # gated RMSNorm (Mamba-2 norm before out-proj)
    y = ops.rmsnorm(y * activation(z, cfg), p["norm_w"],
                    use_kernels=cfg.use_kernels)
    return matmul(y, p["w_out"]), new_cache


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` as jnp computes it,
    max(x, 0) + log1p(exp(-|x|)), each op rounded to x's dtype."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def mamba_block(x, p: Params, cfg: ModelConfig, *, cache=None):
    h, new_cache = mamba2(norm(x, p["ln1"], cfg), p["mixer"], cfg,
                          cache=cache)
    return x + h, new_cache


__all__ = ["activation", "attention", "attn_block", "mamba2", "mamba_block",
           "mlp", "norm", "rope"]
