"""Memory-efficient blocked attention with a recompute-based backward, in
plain torch.

The port of ``repro.models.flash``: the online softmax over
``(block_q, block_k)`` tiles of ``_fwd_scan``, which also returns the row
log-sum-exp, and the blocked backward ``_bwd_scan``, which recomputes
each tile's probabilities from (q, k, lse) instead of saving them.  The
reference's ``jax.custom_vjp`` becomes two ``torch.autograd.Function``
classes, each saving (q, k, v, o, lse):

* :class:`_BlockedFlash`, the custom VJP of :func:`blocked_attention`
  (``_flash``, ``_flash_fwd``, ``_flash_bwd``), with ``_fwd_scan`` as its
  forward.  It is the serving prefill's attention and the training
  forward's with ``use_kernels=False``, which the reference also runs as
  plain XLA code.
* :class:`FlashAttention`, whose forward is the flash attention kernel
  (:func:`repro_torch.kernels.flash_attention.flash_attention`: the CUDA
  kernel for CUDA tensors, its plain version for CPU tensors) and whose
  backward is ``_bwd_scan`` again — the reference's own plan: "on TPU the
  Pallas kernel replaces the forward, while this VJP structure still
  drives the backward".

Same layouts as the reference — (B, S, H, D) at the public wrapper,
(B, H, S, D) inside — and the same dtypes: scores, the running max,
normalizer and accumulator in f32, probabilities cast to V's dtype before
the forward's product, gradients accumulated in f32.  The blocks are
Python loops (the reference's ``lax.map``/``lax.scan``); the backward
takes ragged last blocks where the reference needs whole ones.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import flash_attention as _fa

NEG = -1e30


def _mask(qpos, kpos, causal: bool, sk_valid: int):
    m = kpos[None, :] < sk_valid
    if causal:
        m = m & (kpos[None, :] <= qpos[:, None])
    return m


def _fwd_scan(q, k, v, *, causal, bq, bk, sk_valid, q_offset):
    """q: (B,H,Sq,D) padded; k/v: (B,H,Sk,D) padded.  Returns (o, lse)."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    nq, nk = Sq // bq, Sk // bk
    dev = q.device
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    for qi in range(nq):
        qblk = q[:, :, qi * bq:(qi + 1) * bq].to(torch.float32)
        qpos = q_offset + qi * bq + torch.arange(bq, device=dev)
        m = torch.full((B, H, bq), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, bq, D), dtype=torch.float32, device=dev)
        for j in range(nk):
            if causal and j * bk > q_offset + (qi + 1) * bq - 1:
                # every key of the block is masked for every query of the
                # q block: p == 0 and alpha == 1 exactly, so skipping the
                # step changes no bit of m, l or acc
                continue
            kblk = k[:, :, j * bk:(j + 1) * bk]
            vblk = v[:, :, j * bk:(j + 1) * bk]
            kpos = j * bk + torch.arange(bk, device=dev)
            s = torch.matmul(qblk, kblk.to(torch.float32).transpose(-1, -2))
            s = torch.where(_mask(qpos, kpos, causal, sk_valid)[None, None],
                            s, torch.full_like(s, NEG))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.matmul(p.to(vblk.dtype).to(torch.float32),
                              vblk.to(torch.float32))
            acc = acc * alpha[..., None] + pv
            m = m_new
        l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
        o[:, :, qi * bq:(qi + 1) * bq] = (acc / l_safe[..., None]).to(q.dtype)
        lse[:, :, qi * bq:(qi + 1) * bq] = m + torch.log(l_safe)
    return o, lse


def _bwd_scan(q, k, v, o, lse, do, *, causal, bq, bk, sk_valid, q_offset):
    """q, o, do: (B,H,Sq,D); k/v: (B,H,Sk,D); lse: (B,H,Sq).  Returns
    (dq, dk, dv) in float32 (float64 for a float64 q, for gradient
    checks).

    ``_bwd_scan`` of the reference: for each k block, a pass over the q
    blocks that recomputes p = exp(s - lse), accumulates dv and dk in f32
    and adds each q block's dq.  Two differences, neither of which changes
    a row that has a valid key: a ragged last block is taken as it is,
    and p is 0 where the mask is false (the reference's exp(NEG - lse)
    is 0 there already unless the row has no valid key, whose lse is
    NEG too and whose output the forward gives as zeros)."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    f32 = torch.promote_types(q.dtype, torch.float32)
    dev = q.device
    Drow = torch.sum(do.to(f32) * o.to(f32), dim=-1)            # (B,H,Sq)
    dq = torch.zeros((B, H, Sq, D), dtype=f32, device=dev)
    dk = torch.empty((B, H, Sk, D), dtype=f32, device=dev)
    dv = torch.empty((B, H, Sk, D), dtype=f32, device=dev)
    for j0 in range(0, Sk, bk):
        kblk = k[:, :, j0:j0 + bk].to(f32)
        vblk = v[:, :, j0:j0 + bk].to(f32)
        kpos = j0 + torch.arange(kblk.shape[2], device=dev)
        dk_j = torch.zeros_like(kblk)
        dv_j = torch.zeros_like(vblk)
        for i0 in range(0, Sq, bq):
            qblk = q[:, :, i0:i0 + bq].to(f32)
            doblk = do[:, :, i0:i0 + bq].to(f32)
            qpos = q_offset + i0 + torch.arange(qblk.shape[2], device=dev)
            msk = _mask(qpos, kpos, causal, sk_valid)[None, None]
            s = torch.matmul(qblk, kblk.transpose(-1, -2))
            s = torch.where(msk, s, torch.full_like(s, NEG))
            p = torch.where(msk, torch.exp(s - lse[:, :, i0:i0 + bq, None]),
                            torch.zeros_like(s))
            dv_j = dv_j + torch.matmul(p.transpose(-1, -2), doblk)
            dp = torch.matmul(doblk, vblk.transpose(-1, -2))
            ds = p * (dp - Drow[:, :, i0:i0 + bq, None])
            ds = torch.where(msk, ds, torch.zeros_like(ds))
            dq[:, :, i0:i0 + bq] += torch.matmul(ds, kblk)
            dk_j = dk_j + torch.matmul(ds.transpose(-1, -2), qblk)
        dk[:, :, j0:j0 + bk] = dk_j
        dv[:, :, j0:j0 + bk] = dv_j
    return dq, dk, dv


class _BlockedFlash(torch.autograd.Function):
    """The custom VJP of :func:`blocked_attention`: ``_fwd_scan`` forward,
    ``_bwd_scan`` backward, saving (q, k, v, o, lse).  q, k, v are padded
    to whole blocks and in (B, H, S, D); ``meta`` is (causal, bq, bk,
    sk_valid, q_offset)."""

    @staticmethod
    def forward(ctx, q, k, v, meta):
        causal, bq, bk, sk_valid, q_offset = meta
        o, lse = _fwd_scan(q, k, v, causal=causal, bq=bq, bk=bk,
                           sk_valid=sk_valid, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.meta = meta
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, bq, bk, sk_valid, q_offset = ctx.meta
        dq, dk, dv = _bwd_scan(q, k, v, o, lse, do, causal=causal, bq=bq,
                               bk=bk, sk_valid=sk_valid, q_offset=q_offset)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient.  q: (B, H, Sq, D); k, v: (B, Hkv,
    Sk, D) -> o (B, H, Sq, D) in q's dtype; the causal mask is aligned to
    the key tail, as the kernel's.

    forward: :func:`repro_torch.kernels.flash_attention.flash_attention`
    (the CUDA kernel for CUDA tensors, its plain version for CPU tensors),
    saving (q, k, v, o, lse).  backward: :func:`_bwd_scan` in
    ``(block_q, block_k)`` blocks, on q scaled by ``sm_scale`` in f32 (the
    kernel scales the f32-upcast q) and k, v repeated to H heads; dq is
    scaled once more (the chain rule through ``sm_scale``), and dk, dv are
    summed over each KV head's group of query heads."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True,
                sm_scale: Optional[float] = None, block_q: int = 512,
                block_k: int = 1024):
        o, lse = _fa.flash_attention(q, k, v, causal=causal,
                                     sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (bool(causal), sm_scale, int(block_q), int(block_k))
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, sm_scale, bq, bk = ctx.args
        B, H, Sq, D = q.shape
        Hkv, Sk = k.shape[1], k.shape[2]
        G = H // Hkv
        scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
        qs = q.to(torch.promote_types(q.dtype, torch.float32)) * scale
        kr = k.repeat_interleave(G, dim=1) if G > 1 else k
        vr = v.repeat_interleave(G, dim=1) if G > 1 else v
        dqs, dk, dv = _bwd_scan(qs, kr, vr, o, lse, do, causal=causal,
                                bq=bq, bk=bk, sk_valid=Sk, q_offset=Sk - Sq)
        if G > 1:
            dk = dk.view(B, Hkv, G, Sk, D).sum(dim=2)
            dv = dv.view(B, Hkv, G, Sk, D).sum(dim=2)
        return ((dqs * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def blocked_attention(q, k, v, *, causal: bool, block_q: int, block_k: int,
                      q_offset: int = 0):
    """q: (B,Sq,H,D); k/v: (B,Sk,KV,D) (GQA broadcast) -> (B,Sq,H,D)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    if rep > 1:
        k = k[:, :, :, None, :].expand(B, Sk, KV, rep, D).reshape(B, Sk, H, D)
        v = v[:, :, :, None, :].expand(B, Sk, KV, rep, D).reshape(B, Sk, H, D)

    q = (q * (1.0 / math.sqrt(D))).transpose(1, 2)          # (B,H,Sq,D)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)

    bq = min(block_q, Sq)
    bk = min(block_k, Sk)
    pq = (-Sq) % bq
    pk = (-Sk) % bk
    if pq:
        q = F.pad(q, (0, 0, 0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, pk))

    meta = (bool(causal), bq, bk, Sk, q_offset)
    o = _BlockedFlash.apply(q, k, v, meta)
    return o[:, :, :Sq].transpose(1, 2)


__all__ = ["FlashAttention", "blocked_attention"]
