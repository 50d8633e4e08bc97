"""Plain torch references for the model kernels: the ``use_kernels=False``
path of :mod:`repro_torch.kernels.ops`.

The torch port of the part of ``repro.kernels.ref`` the serving path
calls.  Each keeps the reference's dtypes: a product of two bfloat16
operands gives bfloat16, and the decode scores are taken in the cache's
dtype before the f32 softmax.  Where the reference's ``jnp.einsum``
promotes mixed operands (bfloat16 with float32), the cast is written out
(:func:`promoted`): ``torch.einsum`` refuses mixed dtypes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two, as jnp.einsum does.

    A DTensor (B, S, d) whose S is cut is gathered over S first (the
    sequence-parallel residual entering a tensor-parallel product, as
    Megatron gathers it), and made contiguous: ``matmul`` flattens
    (B, S) into rows, which DTensor refuses with S cut, or as a view of
    a strided local tensor, in some PyTorch versions (2.11)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    if isinstance(a, DTensor) and a.dim() == 3:
        a = a.redistribute(a.device_mesh, [
            Replicate() if isinstance(p, Shard) and p.dim == 1 else p
            for p in a.placements])
        if not a.to_local().is_contiguous():
            # DTensor's own contiguous() looks at the global strides
            a = DTensor.from_local(a.to_local().contiguous(), a.device_mesh,
                                   a.placements, run_check=False,
                                   shape=a.shape, stride=a.stride())
    return torch.matmul(a, b)


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


def promoted(*ts: torch.Tensor):
    """The operands in their promoted dtype, as ``jnp.einsum`` casts them
    before it contracts."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _repeat_groups(t: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """``jnp.repeat(t, rep, axis=dim)``: each group broadcast over its
    ``rep`` heads."""
    return t.repeat_interleave(rep, dim=dim) if rep > 1 else t


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int = 64,
             initial_state: Optional[torch.Tensor] = None,
             return_state: bool = False):
    """Mamba-2 SSD (state-space duality) reference, chunked formulation.

    x:  (b, s, h, p)   inputs (already conv'd/activated)
    dt: (b, s, h)      positive step sizes (post softplus)
    A:  (h,)           negative state decay rates
    B:  (b, s, g, n)   input projections (g groups broadcast over h)
    C:  (b, s, g, n)   output projections
    Returns y: (b, s, h, p) in x's dtype [and the final state (b, h, p, n)
    in float32].

    Semantics: h_t = exp(dt_t*A) * h_{t-1} + dt_t * B_t x_t ; y_t = C_t h_t.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"ssd_scan: s={s} is not a multiple of chunk={chunk}")
    nc = s // chunk
    rep = h // g
    Bc = _repeat_groups(B, rep, 2).reshape(b, nc, chunk, h, n)
    Cc = _repeat_groups(C, rep, 2).reshape(b, nc, chunk, h, n)
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)

    dA = dtc * A[None, None, None, :]              # (b, nc, L, h), negative
    dA_cs = torch.cumsum(dA, dim=2)                # inclusive cumsum
    # intra-chunk: y_intra[i] = sum_{j<=i} C_i . B_j x_j dt_j exp(cs_i-cs_j)
    seg = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]  # (b,nc,i,j,h)
    idx = torch.arange(chunk, device=x.device)
    causal = idx[:, None] >= idx[None, :]
    L = torch.where(causal[None, None, :, :, None], torch.exp(seg),
                    torch.zeros((), dtype=seg.dtype, device=x.device))
    cb = torch.einsum("bcihn,bcjhn->bcijh", *promoted(Cc, Bc))
    y_intra = torch.einsum("bcijh,bcijh,bcjh,bcjhp->bcihp",
                           *promoted(cb, L, dtc, xc))

    # chunk-final states: S_c = sum_j exp(cs_L - cs_j) dt_j B_j x_j^T
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)   # (b,nc,L,h)
    states = torch.einsum("bcjh,bcjh,bcjhn,bcjhp->bchpn",
                          *promoted(decay_to_end, dtc, Bc, xc))

    # inter-chunk recurrence over c: S'_c = G_c S'_{c-1} + states_c, in
    # float32 whatever the activations' dtype; each chunk sees the state
    # *entering* it
    G = torch.exp(dA_cs[:, :, -1, :]).to(torch.float32)     # (b, nc, h)
    states = states.to(torch.float32)
    carry = initial_state.to(torch.float32) if initial_state is not None \
        else torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = G[:, c, :, None, None] * carry + states[:, c]
    prev_states = torch.stack(prev, dim=1)                   # (b,nc,h,p,n)

    # inter-chunk contribution: y_inter[i] = C_i exp(cs_i) S_prev
    decay_from_start = torch.exp(dA_cs)                      # (b,nc,L,h)
    y_inter = torch.einsum("bcihn,bcih,bchpn->bcihp",
                           *promoted(Cc, decay_from_start, prev_states))

    y = (y_intra + y_inter).reshape(b, s, h, p).to(x.dtype)
    if return_state:
        return y, carry
    return y


def ssd_decode_step(state: torch.Tensor, x_t: torch.Tensor,
                    dt_t: torch.Tensor, A: torch.Tensor, B_t: torch.Tensor,
                    C_t: torch.Tensor):
    """Single-token SSD recurrence.  state: (b,h,p,n); x_t: (b,h,p);
    dt_t: (b,h); B_t, C_t: (b,g,n).  Returns (y_t, new_state); y_t takes
    the promoted dtype of the state and C_t, as the reference's einsum
    does."""
    b, h, p = x_t.shape
    rep = h // B_t.shape[1]
    Bh = _repeat_groups(B_t, rep, 1)                         # (b,h,n)
    Ch = _repeat_groups(C_t, rep, 1)
    dA = torch.exp(dt_t * A[None, :])                        # (b,h)
    new = dA[:, :, None, None] * state + \
        (dt_t[:, :, None] * x_t)[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", *promoted(new, Ch))
    return y, new


__all__ = ["attention", "decode_attention", "matmul", "promoted",
           "repeat_kv", "rmsnorm", "ssd_decode_step", "ssd_scan"]
