"""End-to-end language models of all six families, in torch.

The port of ``repro.models.model``: the compute-dtype cast of the
parameters, the embedding and LM head, the backbones of the dense, moe,
ssm, hybrid, vlm and encdec families (a Python loop over the stacked
layers where the reference scanned them) with per-block remat in
training (:func:`_maybe_remat`), the forward entry point with the vlm's
image and the encdec's audio-frame embeddings as auxiliary inputs, the
training loss (:func:`loss_fn`), and the caches.  ``rules`` (the
sharding rules of a mesh, :mod:`repro_torch.distributed.sharding`) go
down to every layer; the embedding and the logits are constrained at the
reference's places.  ``rules=None`` is the one-device model.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Mapping, Optional, Union

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..distributed.sharding import (ShardingRules, constrain,
                                    implicit_replication)
from ..kernels import ops
from ..kernels.ref import matmul
from . import layers
from . import params as P
from .blocked_ce import streaming_ce
from .config import ModelConfig

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def model_defs(cfg: ModelConfig):
    return P.model_defs(cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: Optional[torch.dtype] = None,
                device: Union[str, torch.device] = "cpu") -> Params:
    dtype = dtype or torch_dtype(cfg.param_dtype)
    return P.init_params(P.model_defs(cfg), generator, dtype, device)


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _cast(params: Params, cfg: ModelConfig) -> Params:
    """Compute-dtype view of the params (bf16 matmuls, fp32 master): every
    float32 leaf with two or more dims goes to ``cfg.dtype``.  The
    per-layer norm weights are stacked to (L, d), so inside the blocks
    they are in ``cfg.dtype`` too, while ``ln_f.w`` (d,) stays float32.
    Leaves already in the compute dtype are returned as they are, so a
    cast tree casts again for free."""
    cdt = torch_dtype(cfg.dtype)

    def leaf(x):
        return x.to(cdt) if x.dtype == torch.float32 and x.dim() >= 2 else x
    return _tree_map(leaf, params)


def _layer(tree, i: int):
    return _tree_map(lambda x: x[i], tree)


#: the products whose outputs ``remat="dots"`` keeps: matmuls without a
#: batch dimension (the projections; torch folds a (B, S, d) @ (d, k)
#: product into one ``mm``), as the reference's
#: ``dots_with_no_batch_dims_saveable`` policy keeps them
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` (one block) checkpointed as ``cfg.remat`` asks: ``"block"``
    and ``"full"`` save its inputs only and recompute it in the backward
    (``torch.utils.checkpoint``, non-reentrant); ``"dots"`` also saves the
    outputs of its matmuls without a batch dimension and recomputes the
    elementwise and norm chains; ``"none"`` saves everything.  Only while
    grad mode is on: a forward with no backward has nothing to save."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "dots":
        ctx_fn = functools.partial(create_selective_checkpoint_contexts,
                                   _dots_policy)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=ctx_fn)
    if cfg.remat in ("block", "full"):
        return functools.partial(checkpoint, fn, use_reentrant=False)
    raise ValueError(f"remat {cfg.remat!r}: none | block | full | dots")


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(params: Params, tokens, cfg: ModelConfig,
                 rules: Optional[ShardingRules] = None):
    # T5-style sqrt(d) embedding scale, in the table's dtype
    emb = params["embed"]
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=emb.dtype,
                         device=emb.device)
    rows = ops.embedding(emb, tokens) if isinstance(emb, DTensor) \
        else emb[tokens]
    return constrain(rows * scale, rules, "batch", "act_seq", "d_model")


def lm_head(params: Params, x, cfg: ModelConfig,
            rules: Optional[ShardingRules] = None):
    x = layers.norm(x, params["ln_f"], cfg)
    w = params["unembed"] if "unembed" in params else params["embed"].T
    logits = matmul(x, w)
    # seq and vocab cannot both land on "model"; prefer the seq sharding
    # when sequence parallelism is on (CE is then fully token-parallel)
    if rules is not None and rules.act_seq is not None:
        logits = constrain(logits, rules, "batch", "act_seq", None)
    else:
        logits = constrain(logits, rules, "batch", "seq", "vocab")
    if cfg.padded_vocab != cfg.vocab:   # mask padded vocab rows
        pad_mask = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab
        logits = torch.where(pad_mask, logits,
                             torch.full_like(logits, -1e9))
    return logits


# ---------------------------------------------------------------------------
# backbones (mode: "train" | "prefill" | "decode")
# ---------------------------------------------------------------------------

def _zero_aux(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _dense_backbone(params, x, cfg, rules=None, *, positions, caches,
                    mode):
    """The attention stack of the dense and moe families; returns (x,
    the summed MoE aux loss, new caches).  With caches, each layer writes
    its K/V into ``caches["k"][i]`` and ``caches["v"][i]`` (views of the
    stacked caches) in place."""
    def block(x, lp):
        y, a, _ = layers.attn_block(x, lp, cfg, rules, positions=positions)
        return y, a

    if mode == "train":
        block = _maybe_remat(block, cfg)
    aux = _zero_aux(x)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        if caches is None:
            x, a = block(x, lp)
        else:
            x, a, _ = layers.attn_block(
                x, lp, cfg, rules, positions=positions,
                cache=(caches["k"][i], caches["v"][i], caches["len"]))
        aux = aux + a
    if caches is None:
        return x, aux, None
    return x, aux, {"k": caches["k"], "v": caches["v"],
                    "len": caches["len"] + x.shape[1]}


def _ssm_backbone(params, x, cfg, rules=None, *, positions, caches, mode):
    """The Mamba-2 stack of the ssm family, and of the hybrid family
    (zamba2-style), where ONE shared attention block (unstacked
    parameters, ``params["shared_attn"]``) follows every
    ``attn_every``-th mamba block, each application with its own KV cache
    (``caches["attn_k"][app]``), written in place.  With caches, each
    layer's SSD state is written into ``caches["ssd"]`` in place (it is
    float32 in every model), while the conv windows come back stacked in
    the dtype the layers computed them in, as the reference's scan
    returns them."""
    hybrid = cfg.family == "hybrid"
    every = cfg.attn_every if hybrid else 0

    def mblock(x, lp):
        return layers.mamba_block(x, lp, cfg, rules)[0]

    def ablock(x, lp):
        return layers.attn_block(x, lp, cfg, rules, positions=positions)[0]

    if mode == "train":
        mblock, ablock = _maybe_remat(mblock, cfg), _maybe_remat(ablock, cfg)
    windows = ([], [], [])
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        if caches is None:
            x = mblock(x, lp)
        else:
            lc = (caches["conv_x"][i], caches["conv_B"][i],
                  caches["conv_C"][i], caches["ssd"][i])
            x, nc = layers.mamba_block(x, lp, cfg, rules, cache=lc)
            for acc, w in zip(windows, nc[:3]):
                acc.append(w)
            caches["ssd"][i].copy_(nc[3])
        if hybrid and (i + 1) % every == 0:
            if caches is None:
                x = ablock(x, params["shared_attn"])
            else:
                app = (i + 1) // every - 1
                x, _, _ = layers.attn_block(
                    x, params["shared_attn"], cfg, rules, positions=positions,
                    cache=(caches["attn_k"][app], caches["attn_v"][app],
                           caches["len"]))
    if caches is None:
        return x, _zero_aux(x), None
    out = {"conv_x": torch.stack(windows[0]),
           "conv_B": torch.stack(windows[1]),
           "conv_C": torch.stack(windows[2]), "ssd": caches["ssd"],
           "len": caches["len"] + x.shape[1]}
    if hybrid:
        out.update(attn_k=caches["attn_k"], attn_v=caches["attn_v"])
    return x, _zero_aux(x), out


def _vlm_backbone(params, x, cfg, rules=None, *, positions, img_embeds,
                  caches, mode):
    """``n_groups`` times: the gated cross-attention to the image tokens,
    then ``cross_attn_every`` self-attention decoder layers.  With caches,
    layer j of group g writes ``caches["k"][g, j]`` in place."""
    every = cfg.cross_attn_every

    def cross(x, xp):
        return layers.cross_block(x, xp, cfg, rules, kv_x=img_embeds,
                                  positions=positions)

    def block(x, lp):
        y, a, _ = layers.attn_block(x, lp, cfg, rules, positions=positions)
        return y, a

    if mode == "train":
        cross, block = _maybe_remat(cross, cfg), _maybe_remat(block, cfg)
    aux = _zero_aux(x)
    for g in range(cfg.n_layers // every):
        x = cross(x, _layer(params["cross"], g))
        group = _layer(params["layers"], g)
        for j in range(every):
            lp = _layer(group, j)
            if caches is None:
                x, a = block(x, lp)
            else:
                x, a, _ = layers.attn_block(
                    x, lp, cfg, rules, positions=positions,
                    cache=(caches["k"][g, j], caches["v"][g, j],
                           caches["len"]))
            aux = aux + a
    if caches is None:
        return x, aux, None
    return x, aux, {"k": caches["k"], "v": caches["v"],
                    "len": caches["len"] + x.shape[1]}


def _encode_audio(params, frames, cfg, rules=None):
    """The whisper encoder over the (stubbed) precomputed frame
    embeddings: learned positions, ``enc_layers`` non-causal attention
    blocks without RoPE, the final norm."""
    x = frames + params["enc_pos_embed"][None, :frames.shape[1]]
    for i in range(cfg.enc_layers):
        x, _, _ = layers.attn_block(x, _layer(params["enc_layers"], i), cfg,
                                    rules, positions=None, causal=False,
                                    use_rope=False)
    return layers.norm(x, params["ln_enc"], cfg)


def _encdec_backbone(params, x, cfg, rules=None, *, positions, enc_out,
                     caches, mode):
    """The whisper decoder: self-attention, cross-attention to
    ``enc_out`` and the MLP in each layer.  The new caches carry
    ``enc_out`` as computed (the executor's insert takes it to the
    batch cache's dtype)."""
    def block(x, lp):
        return layers.encdec_block(x, lp, cfg, rules, enc_out=enc_out,
                                   positions=positions)[0]

    if mode == "train":
        block = _maybe_remat(block, cfg)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        if caches is None:
            x = block(x, lp)
        else:
            x, _ = layers.encdec_block(
                x, lp, cfg, rules, enc_out=enc_out, positions=positions,
                cache=(caches["k"][i], caches["v"][i], caches["len"]))
    if caches is None:
        return x, _zero_aux(x), None
    return x, _zero_aux(x), {"k": caches["k"], "v": caches["v"],
                             "enc_out": enc_out,
                             "len": caches["len"] + x.shape[1]}


_BACKBONES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _BACKBONES:
        raise ValueError(f"unknown family {cfg.family!r}; known: "
                         f"{_BACKBONES}")


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def forward(params: Params, tokens, cfg: ModelConfig, *,
            aux_inputs: Optional[Mapping[str, torch.Tensor]] = None,
            caches=None, mode: str = "train", return_hidden: bool = False,
            rules: Optional[ShardingRules] = None):
    """Returns (logits, moe_aux_loss, new_caches); the aux loss is a
    float32 0 outside the moe family.  ``aux_inputs`` holds the vlm's
    ``img_embeds`` (B, n_img_tokens, d) or the encdec's ``frames`` (B,
    enc_seq, d); an encdec decode step reads the encoder's output from
    ``caches["enc_out"]`` instead.  With ``return_hidden`` the final-norm
    hidden states replace the logits (the streaming-CE path computes the
    LM head itself).  In ``mode="train"`` each block is checkpointed as
    ``cfg.remat`` asks (:func:`_maybe_remat`).  ``rules`` constrain the
    activations on a mesh (``None``: one device).

    ``caches`` (from :func:`init_caches`) are updated in place: the
    returned dict holds the same K/V or SSD state tensors, the new conv
    windows of the ssm and hybrid families, the encdec's ``enc_out`` and
    a new length vector."""
    _check_family(cfg)
    if isinstance(tokens, DTensor):
        # on a mesh the few tensors the forward makes itself (positions,
        # RoPE's angles, masks) join the DTensors as replicated
        with implicit_replication():
            return _forward(params, tokens, cfg, aux_inputs, caches, mode,
                            return_hidden, rules)
    return _forward(params, tokens, cfg, aux_inputs, caches, mode,
                    return_hidden, rules)


def _forward(params, tokens, cfg, aux_inputs, caches, mode, return_hidden,
             rules):
    params = _cast(params, cfg)
    aux_inputs = aux_inputs or {}
    B, S = tokens.shape
    if caches is not None and mode == "decode":
        ln = caches["len"]
        positions = ln.expand(B, S) if ln.dim() == 0 else ln[:, None]
    else:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)

    x = embed_tokens(params, tokens, cfg, rules)
    fam = cfg.family
    if fam == "encdec":
        x = x + params["pos_embed"][positions.long()]
    if fam in ("dense", "moe"):
        x, aux, nc = _dense_backbone(params, x, cfg, rules,
                                     positions=positions, caches=caches,
                                     mode=mode)
    elif fam in ("ssm", "hybrid"):
        x, aux, nc = _ssm_backbone(params, x, cfg, rules,
                                   positions=positions, caches=caches,
                                   mode=mode)
    elif fam == "vlm":
        img = aux_inputs["img_embeds"].to(x.dtype)
        x, aux, nc = _vlm_backbone(params, x, cfg, rules,
                                   positions=positions, img_embeds=img,
                                   caches=caches, mode=mode)
    else:
        if caches is not None and mode == "decode":
            enc_out = caches["enc_out"]
        else:
            enc_out = _encode_audio(params, aux_inputs["frames"].to(x.dtype),
                                    cfg, rules)
        x, aux, nc = _encdec_backbone(params, x, cfg, rules,
                                      positions=positions, enc_out=enc_out,
                                      caches=caches, mode=mode)
    if return_hidden:
        return layers.norm(x, params["ln_f"], cfg), aux, nc
    return lm_head(params, x, cfg, rules), aux, nc


def _token_ce(logits, targets):
    """Each token's cross-entropy: logsumexp of its logits minus its
    target's."""
    logz = torch.logsumexp(logits, dim=-1)
    return logz - torch.gather(logits, -1, targets[..., None].long())[..., 0]


def loss_fn(params: Params, batch: Mapping[str, torch.Tensor],
            cfg: ModelConfig, aux_weight: float = 0.01,
            rules: Optional[ShardingRules] = None):
    """Mean token cross-entropy of the training forward against
    ``batch["targets"]``, plus ``aux_weight`` times the MoE aux loss.
    The batch's other entries (``img_embeds``, ``frames``) are the
    forward's auxiliary inputs.  Returns (loss, {"ce", "aux", "ppl"}),
    all float32 scalars.

    The logits are taken to float32 before the logsumexp, as in the
    reference; with ``cfg.use_streaming_ce`` the fused, vocab-chunked CE
    of :mod:`.blocked_ce` replaces the full logits."""
    tokens, targets = batch["tokens"], batch["targets"]
    aux_in = {k: v for k, v in batch.items() if k not in ("tokens",
                                                          "targets")}
    if cfg.use_streaming_ce:
        hidden, aux, _ = forward(params, tokens, cfg, aux_inputs=aux_in,
                                 mode="train", return_hidden=True,
                                 rules=rules)
        cparams = _cast(params, cfg)
        w = cparams["unembed"] if "unembed" in cparams \
            else cparams["embed"].T
        # largest divisor of the padded vocab <= ce_chunk
        V = cfg.padded_vocab
        chunk = min(cfg.ce_chunk, V)
        while V % chunk:
            chunk -= 1
        ce = streaming_ce(hidden, w, targets, cfg.vocab, chunk)
    else:
        logits, aux, _ = forward(params, tokens, cfg, aux_inputs=aux_in,
                                 mode="train", rules=rules)
        logits = logits.to(torch.float32)
        if isinstance(logits, DTensor):     # each rank's rows whole
            ce = torch.mean(ops.rowwise(_token_ce, logits, targets))
        else:
            ce = torch.mean(_token_ce(logits, targets))
    loss = ce + aux_weight * aux
    return loss, {"ce": ce, "aux": aux,
                  "ppl": torch.exp(torch.clamp(ce, max=20.0))}


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                device: Union[str, torch.device] = "cpu"):
    """Per-family caches, stacked on a leading layer axis.  K/V are in
    the attention kernel's (B, KV, S, D) layout: (L, ...) for the dense,
    moe and encdec families, (n_groups, every, ...) for the vlm, and one
    per application of the hybrid's shared block.  The ssm and hybrid
    families keep the last W-1 pre-conv inputs of x, B and C and the
    (B, H, P, N) SSD state, whatever ``max_seq`` is; the encdec the
    encoder's output (B, enc_seq, d).  Every cache but the float32 SSD
    state and the int32 lengths is bfloat16 whatever ``cfg.dtype`` is, as
    in the reference.  On the ``meta`` device the caches take no memory
    (:meth:`TorchExecutor.cache_bytes` sizes them so)."""
    _check_family(cfg)
    L = cfg.n_layers

    def mk(shape, dt=torch.bfloat16):
        return torch.zeros(shape, dtype=dt, device=device)

    fam = cfg.family
    out = {"len": mk((batch,), torch.int32)}
    kv_tail = (batch, cfg.n_kv, max_seq, cfg.hd)
    if fam in ("dense", "moe", "encdec"):
        out.update(k=mk((L,) + kv_tail), v=mk((L,) + kv_tail))
        if fam == "encdec":
            out["enc_out"] = mk((batch, cfg.enc_seq, cfg.d_model))
    elif fam == "vlm":
        every = cfg.cross_attn_every
        kv = (L // every, every) + kv_tail
        out.update(k=mk(kv), v=mk(kv))
    else:
        W, inner = cfg.ssm_conv, cfg.ssm_inner
        GN = cfg.ssm_groups * cfg.ssm_state
        out.update(
            conv_x=mk((L, batch, W - 1, inner)),
            conv_B=mk((L, batch, W - 1, GN)),
            conv_C=mk((L, batch, W - 1, GN)),
            ssd=mk((L, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                    cfg.ssm_state), torch.float32))
        if fam == "hybrid":
            napps = L // cfg.attn_every
            out.update(attn_k=mk((napps,) + kv_tail),
                       attn_v=mk((napps,) + kv_tail))
    return out


def cache_logical_axes(cfg: ModelConfig):
    """Logical axis names for every cache leaf (the executor reads the
    batch axis from them)."""
    _check_family(cfg)
    fam = cfg.family
    out = {"len": (None,)}
    kv = (None, "batch", "kv_heads", "cache_seq", "head_dim")
    if fam in ("dense", "moe", "encdec"):
        out.update(k=kv, v=kv)
        if fam == "encdec":
            out["enc_out"] = ("batch", None, "d_model")
    elif fam == "vlm":
        out.update(k=(None,) + kv, v=(None,) + kv)
    else:
        out.update(conv_x=(None, "batch", None, "conv_dim"),
                   conv_B=(None, "batch", None, None),
                   conv_C=(None, "batch", None, None),
                   ssd=(None, "batch", "ssm_heads", None, None))
        if fam == "hybrid":
            out.update(attn_k=kv, attn_v=kv)
    return out


__all__ = ["cache_logical_axes", "embed_tokens", "forward", "init_caches",
           "init_params", "lm_head", "loss_fn", "model_defs", "torch_dtype"]
