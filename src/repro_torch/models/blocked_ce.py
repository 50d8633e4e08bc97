"""Streaming cross-entropy: fused unembed + CE, chunked over the vocab.

The port of ``repro.models.blocked_ce``.  Materializing (B, S, V) logits
costs the most memory of a training step at a large vocabulary.  This
version walks vocab chunks computing a running (max, sumexp) plus the
target logit, and its backward recomputes each chunk's logits — the same
recompute-over-residuals trade as flash attention, applied to the LM
head.  The reference's ``jax.custom_vjp`` is :class:`_StreamingCE`, a
``torch.autograd.Function`` saving (x, w, targets, lse).  Peak extra
memory: one (B, S, C) chunk.
"""

from __future__ import annotations

import torch

NEG = -1e30


def _chunk_logits(x, w_chunk):
    """``x @ w_chunk`` in the operands' dtype (the reference's einsum),
    then float32."""
    return torch.matmul(x, w_chunk).to(torch.float32)


def _fwd_scan(x, w, targets, valid_vocab: int, chunk: int):
    """Returns (lse, tgt_logit): (B,S) each, float32."""
    B, S, d = x.shape
    V = w.shape[1]
    dev = x.device
    m = torch.full((B, S), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, S), dtype=torch.float32, device=dev)
    tgt = torch.full((B, S), NEG, dtype=torch.float32, device=dev)
    for j in range(V // chunk):
        logits = _chunk_logits(x, w[:, j * chunk:(j + 1) * chunk])
        cols = j * chunk + torch.arange(chunk, device=dev)
        logits = torch.where((cols < valid_vocab)[None, None], logits,
                             torch.full_like(logits, NEG))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        l = l * torch.exp(m - m_new) \
            + torch.exp(logits - m_new[..., None]).sum(dim=-1)
        m = m_new
        # target logit if it falls inside this chunk
        inside = (targets >= j * chunk) & (targets < (j + 1) * chunk)
        local = torch.clamp(targets - j * chunk, 0, chunk - 1).long()
        picked = torch.gather(logits, -1, local[..., None])[..., 0]
        tgt = torch.where(inside, picked, tgt)
    return m + torch.log(l), tgt


class _StreamingCE(torch.autograd.Function):
    """Mean token cross-entropy of softmax(x @ w) vs targets, with the
    chunk-recomputing backward of the reference's ``_ce_bwd``."""

    @staticmethod
    def forward(ctx, x, w, targets, valid_vocab: int, chunk: int):
        lse, tgt = _fwd_scan(x, w, targets, valid_vocab, chunk)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.meta = (valid_vocab, chunk)
        return torch.mean(lse - tgt)

    @staticmethod
    def backward(ctx, dce):
        x, w, targets, lse = ctx.saved_tensors
        valid_vocab, chunk = ctx.meta
        B, S, d = x.shape
        V = w.shape[1]
        f32 = torch.float32
        scale = dce / (B * S)
        xf = x.to(f32)
        dx = torch.zeros((B, S, d), dtype=f32, device=x.device)
        dw = torch.empty((d, V), dtype=f32, device=x.device)
        for j in range(V // chunk):
            wj = w[:, j * chunk:(j + 1) * chunk]
            logits = _chunk_logits(x, wj)
            cols = j * chunk + torch.arange(chunk, device=x.device)
            logits = torch.where((cols < valid_vocab)[None, None], logits,
                                 torch.full_like(logits, NEG))
            p = torch.exp(logits - lse[..., None])             # softmax chunk
            onehot = (targets[..., None] == cols[None, None]).to(f32)
            dl = (p - onehot) * scale                          # (B,S,C)
            dx = dx + torch.matmul(dl, wj.to(f32).T)
            dw[:, j * chunk:(j + 1) * chunk] = \
                torch.matmul(xf.reshape(B * S, d).T, dl.reshape(B * S, chunk))
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None


def streaming_ce(x, w, targets, valid_vocab: int, chunk: int):
    """Mean token cross-entropy of softmax(x @ w) vs targets.
    x: (B,S,d); w: (d,V) with V % chunk == 0; targets: (B,S) integers."""
    return _StreamingCE.apply(x, w, targets, valid_vocab, chunk)


__all__ = ["streaming_ce"]
