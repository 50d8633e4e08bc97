"""Blocked (flash-style) causal attention, forward only, in plain torch.

The port of the forward half of ``repro.models.flash``: the online
softmax over ``(block_q, block_k)`` tiles of ``_fwd_scan``, in the same
layouts — (B, S, H, D) at the public wrapper, (B, H, S, D) inside — with
the same dtypes: queries scaled in their own dtype, scores and the
running max, normalizer and accumulator in f32, probabilities cast to
V's dtype before the product.  It is the prefill attention of the
serving path, which the reference also runs as plain XLA code.  The
custom VJP waits for the training slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG = -1e30


def _mask(qpos, kpos, causal: bool, sk_valid: int):
    m = kpos[None, :] < sk_valid
    if causal:
        m = m & (kpos[None, :] <= qpos[:, None])
    return m


def _fwd_scan(q, k, v, *, causal, bq, bk, sk_valid, q_offset):
    """q: (B,H,Sq,D) padded; k/v: (B,H,Sk,D) padded.  Returns o."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    nq, nk = Sq // bq, Sk // bk
    dev = q.device
    o = torch.empty_like(q)
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
    return o


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

    o = _fwd_scan(q, k, v, causal=bool(causal), bq=bq, bk=bk, sk_valid=Sk,
                  q_offset=q_offset)
    return o[:, :, :Sq].transpose(1, 2)


__all__ = ["blocked_attention"]
