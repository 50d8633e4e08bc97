"""Model layers of all six families, in torch.

The port of ``repro.models.layers``: ``norm`` (RMSNorm, or LayerNorm
where the block has a bias), ``activation`` (silu or tanh-approximated
gelu), ``rope``, ``attention`` (self-attention with and without a KV
cache, causal or not, and cross-attention to ``kv_x``), the ``mlp``
(gated or not), the top-k ``moe`` FFN and the residual blocks
(``attn_block``, ``cross_block``, ``encdec_block``); the Mamba-2 mixer
(``_causal_conv``, ``mamba2``) and ``mamba_block``.  The math and the
dtypes follow the reference (its einsums become matmuls in the promoted
dtype).  Each layer takes the sharding ``rules`` and constrains its
tensors by logical axis names at the reference's places
(:func:`repro_torch.distributed.sharding.constrain`): on a mesh, where the
parameters and the batch are DTensors, that redistributes them to the
rules' placements; with plain tensors or ``rules=None`` it does nothing.
Kernels are swapped in at the :mod:`repro_torch.kernels.ops` dispatch
layer, which runs them on the local shards of DTensors.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .. import vml
from ..distributed.sharding import ShardingRules, constrain
from ..kernels import ops
from ..kernels.ref import matmul, promoted
from .config import ModelConfig

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def norm(x, p: Params, cfg: ModelConfig, eps: float = 1e-6):
    """LayerNorm in float32 where the block has a bias (``b``), as the
    reference computes it (no kernel there either); RMSNorm otherwise."""
    if "b" in p:                                   # layernorm
        xf = x.to(torch.float32)
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["w"].to(torch.float32)
                + p["b"].to(torch.float32)).to(x.dtype)
    return ops.rmsnorm(x, p["w"], eps=eps, use_kernels=cfg.use_kernels)


def activation(x, cfg: ModelConfig):
    """silu, or gelu with the tanh approximation (``jax.nn.gelu``'s
    default), from vml under ``cfg.use_vml_act``.  A DTensor goes
    through its local shards (a partial sum reduced first): vml's bit
    tricks shift int32 views, and DTensor's ``<<`` returns its input
    unshifted."""
    if isinstance(x, DTensor):
        pl = [Replicate() if isinstance(p, Partial) else p
              for p in x.placements]
        x = x.redistribute(x.device_mesh, pl)
        # the global shape given, for shards that are not all alike
        return DTensor.from_local(activation(x.to_local(), cfg),
                                  x.device_mesh, pl, run_check=False,
                                  shape=x.shape, stride=x.stride())
    if cfg.use_vml_act:
        return vml.silu(x) if cfg.act == "silu" else vml.gelu_tanh(x)
    return F.silu(x) if cfg.act == "silu" \
        else F.gelu(x, approximate="tanh")


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

# On a mesh, a (heads x head_dim) dim flattened for a matmul is placed as
# its heads are, on both sides of the reshape: DTensor splits a flat dim
# into (heads, head_dim) only where its cut divides the heads, and the
# constraint also places the gradient that comes back through the
# reshape.  With plain tensors both are plain reshapes.

def _flat_heads(w, rules, heads: str):
    """A (d, heads, head_dim) projection as (d, heads * head_dim)."""
    d, h, k = w.shape
    return constrain(w.reshape(d, h * k), rules, "embed_fsdp", heads)


def _split_heads(t, rules, heads: str, n: int):
    """A (B, S, n * head_dim) product as (B, S, n, head_dim)."""
    B, S, f = t.shape
    return constrain(t, rules, "batch", "seq", heads).view(B, S, n, f // n)


def _whole(t):
    """A DTensor's whole value (a plain tensor as it is)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _written(cache):
    """What a decode step writes its keys and values into: a DTensor
    cache every rank holds whole is written in its local tensor
    (DTensor's in-place ``index_put_`` fails there in some PyTorch
    versions, 2.11); a cache cut over the mesh raises, its rows' writes
    waiting for ROADMAP A.14."""
    if not isinstance(cache, DTensor):
        return cache
    if any(isinstance(p, Shard) for p in cache.placements):
        raise NotImplementedError(
            f"decode into a KV cache cut over the mesh "
            f"({list(cache.placements)}): waits for ROADMAP A.14")
    return cache.to_local()


def attention(x, p: Params, cfg: ModelConfig,
              rules: Optional[ShardingRules] = None, *, positions,
              causal: bool = True, kv_x=None, use_rope: bool = True,
              cache: Optional[Tuple] = None):
    """Self- or cross-attention (to ``kv_x``, (B, T, d): no RoPE on its
    keys, no cache).  cache=(k_cache, v_cache, lengths) with the caches in
    (B, KV, S_cache, D) layout; returns (out, new_cache).

    With a cache, the new keys and values are written into ``k_cache``
    and ``v_cache`` in place (the reference rebuilt the caches
    functionally with ``dynamic_update_slice``); the returned caches are
    the same tensors.  A cached prefill is causal whatever ``causal``
    says, as in the reference."""
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    src = kv_x if kv_x is not None else x
    T = src.shape[1]
    q = _split_heads(matmul(x, _flat_heads(p["wq"], rules, "heads")),
                     rules, "heads", H)
    q = constrain(q, rules, "batch", "seq", "heads", "head_dim")
    k = _split_heads(matmul(src, _flat_heads(p["wk"], rules, "kv_heads")),
                     rules, "kv_heads", KV)
    v = _split_heads(matmul(src, _flat_heads(p["wv"], rules, "kv_heads")),
                     rules, "kv_heads", KV)
    k = constrain(k, rules, "batch", "seq", "kv_heads", "head_dim")
    v = constrain(v, rules, "batch", "seq", "kv_heads", "head_dim")

    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        if kv_x is None:
            k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None and kv_x is None:
        k_cache, v_cache, lengths = cache
        if S == 1:
            # decode: each batch row writes its new K/V at its OWN length
            # (continuous-batching slots sit at different positions), in
            # place, then attends over lengths + 1 keys.  The reference's
            # dynamic_update_slice clamps the start into the cache; so
            # does the clamp here.
            rows = torch.arange(B, device=x.device)
            pos = _whole(lengths).to(torch.int64) \
                .clamp(0, k_cache.shape[2] - 1)
            _written(k_cache)[rows, :, pos] = _whole(k[:, 0]) \
                .to(k_cache.dtype)
            _written(v_cache)[rows, :, pos] = _whole(v[:, 0]) \
                .to(v_cache.dtype)
            o = ops.decode_attention(q[:, 0], k_cache, v_cache, lengths + 1,
                                     use_kernels=cfg.use_kernels, rules=rules)
            out = o[:, None]                          # (B,1,H,D)
            new_cache = (k_cache, v_cache, lengths + 1)
        else:
            # prefill: attend causally over the fresh K/V, then write the
            # whole prompt into the cache at position 0, in place
            out = ops.blocked_attention(q, k, v, True, cfg.attn_block_q,
                                        cfg.attn_block_k, rules)
            k_cache[:, :, :S] = k.transpose(1, 2).to(k_cache.dtype)
            v_cache[:, :, :S] = v.transpose(1, 2).to(v_cache.dtype)
            new_cache = (k_cache, v_cache, lengths + S)
    elif cfg.use_kernels and S <= 4096 and kv_x is None:
        # the reference's Pallas branch (layers.py:130), with its layout
        # repaired (ROADMAP §C.2): the flash kernel takes (B, H, S, D), so
        # q/k/v go over and the output comes back
        out = ops.attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=causal, use_kernels=True,
            block_q=cfg.attn_block_q, block_k=cfg.attn_block_k, rules=rules,
        ).transpose(1, 2)
    else:
        out = ops.blocked_attention(q, k, v, causal and kv_x is None,
                                    cfg.attn_block_q, cfg.attn_block_k,
                                    rules)

    out = constrain(out, rules, "batch", "seq", "heads", "head_dim")
    wo = constrain(p["wo"].reshape(H * hd, d), rules, "heads", "embed_fsdp")
    y = matmul(constrain(out.reshape(B, S, H * hd), rules, "batch", "seq",
                         "heads"), wo)
    y = constrain(y, rules, "batch", "act_seq", "d_model")
    return y, new_cache


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def mlp(x, p: Params, cfg: ModelConfig,
        rules: Optional[ShardingRules] = None):
    """The MLP: activation(x @ w_gate) * (x @ w_up) @ w_down where it is
    gated, activation(x @ w_up) @ w_down where not (gelu)."""
    h = matmul(x, p["w_up"])
    if "w_gate" in p:
        h = activation(matmul(x, p["w_gate"]), cfg) * h
    else:
        h = activation(h, cfg)
    h = constrain(h, rules, "batch", "seq", "mlp")
    return constrain(matmul(h, p["w_down"]), rules, "batch", "act_seq",
                     "d_model")


def moe_route(x, router, cfg: ModelConfig,
              rules: Optional[ShardingRules] = None):
    """The MoE's routing, as the reference's ``moe`` takes it: tokens in
    groups of ``g = min(cfg.moe_group, S)`` (S padded with zero tokens to
    a multiple, which claim no capacity), router probabilities in float32,
    each token's top-k experts and their gates renormalized to sum to 1,
    and each (token, k) pair's position in its expert's buffer of
    ``C = max(1, int(g * top_k * capacity_factor / n_experts))`` slots,
    claimed in token order, then k order.  A pair at a position >= C is
    dropped.

    Returns a dict: ``xt`` (G, g, d), ``valid`` (G, g) bool, ``probs``
    (G, g, E), ``gate_vals`` (G, g, K) (0 on padded tokens), ``gate_idx``
    (G, g, K), ``pos`` (G, g, K), ``keep`` (G, g, K) bool, ``C``."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    g = min(cfg.moe_group, S)
    pad = (-S) % g
    if pad:     # pad to a group multiple; padded tokens never claim capacity
        x = F.pad(x, (0, 0, 0, pad))
    Sp = S + pad
    G = (B * Sp) // g
    C = max(1, int(g * K * cfg.capacity_factor / E))
    # on a mesh the tokens regroup with only their batch dim cut, and the
    # groups' gradient comes back so placed: DTensor regroups a cut
    # sequence, or groups cut over more dims than B has, wrongly
    xt = constrain(constrain(x, rules, "batch", "seq", "d_model")
                   .reshape(G, g, d), rules, "batch", None, "d_model")
    valid = (torch.arange(Sp, device=x.device) < S)[None] \
        .expand(B, Sp).reshape(G, g)
    logits = matmul(xt, router).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)       # (G,g,K)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    gate_vals = gate_vals * valid[..., None]
    onehot = F.one_hot(gate_idx, E) * valid[..., None, None]  # (G,g,K,E)
    pos = torch.cumsum(onehot.reshape(G, g * K, E), dim=1) \
        .reshape(G, g, K, E) - 1
    pos = (pos * onehot).sum(dim=-1)                          # (G,g,K)
    return {"xt": xt, "valid": valid, "probs": probs,
            "gate_vals": gate_vals, "gate_idx": gate_idx, "pos": pos,
            "keep": pos < C, "C": C}


def _expert_ffn(xin, w_up, w_gate, w_down, cfg: ModelConfig,
                rules: Optional[ShardingRules] = None):
    """The experts' gated FFN over their (E, G, C, d) slots (on a mesh
    it runs on local shards, where the constraint is the reference's
    placement of ``h`` and does nothing)."""
    up = torch.einsum("egcd,edf->egcf", *promoted(xin, w_up))
    gt = torch.einsum("egcd,edf->egcf", *promoted(xin, w_gate))
    h = activation(gt, cfg) * up
    h = constrain(h, rules, "experts", "batch", "moe_capacity", "expert_mlp")
    return torch.einsum("egcf,efd->egcd", *promoted(h, w_down))


def moe(x, p: Params, cfg: ModelConfig,
        rules: Optional[ShardingRules] = None):
    """Token-choice top-k MoE with capacity dropping (:func:`moe_route`),
    the dispatch and the expert products as the reference's einsums, and
    the Switch load-balancing aux loss.  Returns (y, aux).

    One difference from the reference, where its aux loss is wrong
    (ROADMAP §C.16): the reference averages the router probabilities
    ``me`` and the expert counts ``ce`` over every token of the padded
    groups, and a padded (zero) token routes uniformly, so the loss moves
    with the padding; here both average over the real tokens of each
    group.  Where S is a multiple of the group the two are the same."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    r = moe_route(x, p["router"], cfg, rules)
    xt, valid, C = r["xt"], r["valid"], r["C"]
    G, g = valid.shape
    # dispatch: (G, g, E, C) one-hot over (expert, slot), per k
    disp = torch.zeros((G, g, E, C), dtype=x.dtype, device=x.device)
    comb = torch.zeros((G, g, E, C), dtype=torch.float32, device=x.device)
    for kk in range(K):
        sel = F.one_hot(r["gate_idx"][..., kk], E).to(x.dtype) \
            * (r["keep"][..., kk] & valid)[..., None].to(x.dtype)
        # a dropped pair's position is >= C: its one-hot row is all zeros
        slot = F.one_hot(r["pos"][..., kk].clamp(max=C), C + 1)[..., :C] \
            .to(x.dtype)
        contrib = sel[..., None] * slot[..., None, :]
        disp = disp + contrib
        comb = comb + contrib.to(torch.float32) \
            * r["gate_vals"][..., kk, None, None]

    xin = torch.einsum("gsec,gsd->egcd", *promoted(disp, xt))
    # the token-group dim stays sharded on the data axis: the dispatch is
    # an all-to-all over (data -> experts), not a gather of all tokens
    xin = constrain(xin, rules, "experts", "batch", "moe_capacity",
                    "d_model")
    w = (p["w_up"], p["w_gate"], p["w_down"])
    if isinstance(xin, DTensor):
        # on a mesh the experts' FFN runs on each rank's experts, groups
        # and slots
        eo = ops.expertwise(functools.partial(_expert_ffn, cfg=cfg), xin, *w)
    else:
        eo = _expert_ffn(xin, *w, cfg, rules)
    eo = constrain(eo, rules, "experts", "batch", "moe_capacity", "d_model")
    if isinstance(eo, DTensor):     # the combine takes every slot whole
        eo = constrain(eo, rules, None, "batch", None,
                       "d_model").contiguous()
    y = torch.einsum("gsec,egcd->gsd", *promoted(comb.to(x.dtype), eo))

    # load-balancing auxiliary loss (Switch-style), over the real tokens
    vf = valid.to(torch.float32)[..., None]                 # (G,g,1)
    n = vf.sum(dim=1)                                       # (G,1)
    me = (r["probs"] * vf).sum(dim=1) / n                   # (G,E)
    ce = (F.one_hot(r["gate_idx"], E).to(torch.float32).sum(dim=2)
          * vf).sum(dim=1) / n / K
    aux = E * torch.mean(torch.sum(me * ce, dim=-1))
    y = y.reshape(B, -1, d)[:, :S]
    return constrain(y, rules, "batch", "act_seq", "d_model"), aux


# ---------------------------------------------------------------------------
# residual blocks
# ---------------------------------------------------------------------------

def attn_block(x, p: Params, cfg: ModelConfig,
               rules: Optional[ShardingRules] = None, *, positions,
               causal=True, use_rope=True, cache=None):
    """pre-norm attention + FFN block (the MoE FFN where the block has a
    router); returns (x, aux_loss, new_cache), the aux loss a float32 0
    where there is no MoE."""
    h, new_cache = attention(norm(x, p["ln1"], cfg), p["attn"], cfg, rules,
                             positions=positions, causal=causal,
                             use_rope=use_rope, cache=cache)
    x = x + h
    if cfg.family == "moe" and "router" in p["ffn"]:
        h, aux = moe(norm(x, p["ln2"], cfg), p["ffn"], cfg, rules)
    else:
        h = mlp(norm(x, p["ln2"], cfg), p["ffn"], cfg, rules)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h, aux, new_cache


def cross_block(x, p: Params, cfg: ModelConfig,
                rules: Optional[ShardingRules] = None, *, kv_x, positions):
    """Gated cross-attention block (llama-3.2-vision style): x plus
    tanh(gate) times the attention of norm(x) to ``kv_x``."""
    h, _ = attention(norm(x, p["ln"], cfg), p["xattn"], cfg, rules,
                     positions=positions, causal=False, kv_x=kv_x,
                     use_rope=False)
    return x + (torch.tanh(p["gate"].to(torch.float32)) * h).to(x.dtype)


def encdec_block(x, p: Params, cfg: ModelConfig,
                 rules: Optional[ShardingRules] = None, *, enc_out,
                 positions, cache=None):
    """Whisper decoder block: causal self-attention (no RoPE), then
    cross-attention to ``enc_out``, then the MLP; returns (x, new_cache)."""
    h, new_cache = attention(norm(x, p["ln1"], cfg), p["attn"], cfg, rules,
                             positions=positions, causal=True,
                             use_rope=False, cache=cache)
    x = x + h
    h, _ = attention(norm(x, p["lnx"], cfg), p["xattn"], cfg, rules,
                     positions=positions, causal=False, kv_x=enc_out,
                     use_rope=False)
    x = x + h
    h = mlp(norm(x, p["ln2"], cfg), p["ffn"], cfg, rules)
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
    if isinstance(u, DTensor):      # on each sequence's local channels
        return ops.channelwise(lambda u, w, b: _causal_conv(u, w, b)[0],
                               u, w, b), None
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


def mamba2(x, p: Params, cfg: ModelConfig,
           rules: Optional[ShardingRules] = None, *,
           cache: Optional[Tuple] = None):
    """Mamba-2 SSD mixer.  cache=(conv_x, conv_B, conv_C, ssd_state); with
    one token it is a decode step, with more a prefill that starts from
    a zero state.  Returns (out, new_cache).

    Two differences from the reference, both where its cache would be
    wrong: a scan of any length is taken (the reference asserts a
    prefill needs no padding), and a prompt shorter than W-1 leaves a
    zero-padded conv window.  The scan takes a ragged last chunk with
    dt = 0, which leaves the state exactly as the last real token left
    it (:func:`repro_torch.kernels.ops.ssd_scan`).  The decode step is
    plain torch, as the reference's is plain jnp."""
    B, S, _ = x.shape
    Hh, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    Gq = cfg.ssm_groups

    z = matmul(x, p["w_z"])
    u = matmul(x, p["w_x"])
    Bp = matmul(x, p["w_B"])
    Cp = matmul(x, p["w_C"])
    dt = matmul(x, p["w_dt"])
    u = constrain(u, rules, "batch", "seq", "conv_dim")

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
    xs = constrain(xs, rules, "batch", "seq", "ssm_heads", None)
    Bm = Bp.reshape(B, S, Gq, N)
    Cm = Cp.reshape(B, S, Gq, N)
    dt = _softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"].to(torch.float32))
    # the scan's other inputs placed as its kernel takes them on a mesh
    # (the groups whole; no-ops on plain tensors)
    Bm = constrain(Bm, rules, "batch", "seq", None, None)
    Cm = constrain(Cm, rules, "batch", "seq", None, None)
    dt = constrain(dt, rules, "batch", "seq", "ssm_heads")
    A = constrain(A, rules, "ssm_heads")

    new_cache = None
    if decode:
        y, new_state = ops.ref.ssd_decode_step(
            st, xs[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
        y = y[:, None]
        new_cache = (ncx, ncB, ncC, new_state)
    else:
        y, final_state = ops.ssd_scan(xs, dt, A, Bm, Cm,
                                      chunk=cfg.ssm_chunk,
                                      use_kernels=cfg.use_kernels,
                                      rules=rules)
        if cache is not None:   # prefill: stash streaming window + state
            new_cache = (_conv_window(u_raw, W), _conv_window(B_raw, W),
                         _conv_window(C_raw, W), final_state)

    y = y.to(x.dtype) + xs * p["D"][None, None, :, None].to(xs.dtype)
    y = y.reshape(B, S, Hh * P)
    # gated RMSNorm (Mamba-2 norm before out-proj), over the whole inner
    # dim: the kernel takes rows whole, so on a mesh the (model-cut)
    # channels are gathered first
    y = constrain(y * activation(z, cfg), rules, "batch", "seq", None)
    y = ops.rmsnorm(y, p["norm_w"], use_kernels=cfg.use_kernels)
    return constrain(matmul(y, p["w_out"]), rules, "batch", "act_seq",
                     "d_model"), new_cache


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` as jnp computes it,
    max(x, 0) + log1p(exp(-|x|)), each op rounded to x's dtype."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def mamba_block(x, p: Params, cfg: ModelConfig,
                rules: Optional[ShardingRules] = None, *, cache=None):
    h, new_cache = mamba2(norm(x, p["ln1"], cfg), p["mixer"], cfg, rules,
                          cache=cache)
    return x + h, new_cache


__all__ = ["activation", "attention", "attn_block", "cross_block",
           "encdec_block", "mamba2", "mamba_block", "mlp", "moe",
           "moe_route", "norm", "rope"]
