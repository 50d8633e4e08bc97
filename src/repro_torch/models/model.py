"""End-to-end language models of the dense and ssm families, in torch.

The port of those families of ``repro.models.model``: the compute-dtype
cast of the parameters, the embedding and LM head, the backbones (a
Python loop over the stacked layers where the reference scanned them)
with per-block remat in training (:func:`_maybe_remat`), the forward
entry point, the training loss (:func:`loss_fn`), and the caches.  Other
families raise.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Mapping, Optional, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

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

def embed_tokens(params: Params, tokens, cfg: ModelConfig):
    # T5-style sqrt(d) embedding scale, in the table's dtype
    emb = params["embed"]
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=emb.dtype,
                         device=emb.device)
    return emb[tokens] * scale


def lm_head(params: Params, x, cfg: ModelConfig):
    x = layers.norm(x, params["ln_f"], cfg)
    w = params["unembed"] if "unembed" in params else params["embed"].T
    logits = matmul(x, w)
    if cfg.padded_vocab != cfg.vocab:   # mask padded vocab rows
        pad_mask = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab
        logits = torch.where(pad_mask, logits,
                             torch.full_like(logits, -1e9))
    return logits


# ---------------------------------------------------------------------------
# backbone
# ---------------------------------------------------------------------------

def _dense_backbone(params, x, cfg, *, positions, caches, mode):
    def block(x, lp):
        return layers.attn_block(x, lp, cfg, positions=positions)[0]

    if mode == "train":
        block = _maybe_remat(block, cfg)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        if caches is None:
            x = block(x, lp)
        else:
            # caches["k"][i] is a view: the layer writes into the stacked
            # cache in place
            x, _ = layers.attn_block(
                x, lp, cfg, positions=positions,
                cache=(caches["k"][i], caches["v"][i], caches["len"]))
    if caches is None:
        return x, None
    return x, {"k": caches["k"], "v": caches["v"],
               "len": caches["len"] + x.shape[1]}


def _ssm_backbone(params, x, cfg, *, caches, mode):
    """The Mamba-2 stack.  With caches, each layer's SSD state is written
    into ``caches["ssd"]`` in place (it is float32 in every model), while
    the conv windows come back stacked in the dtype the layers computed
    them in, as the reference's scan returns them."""
    if caches is None:
        def block(x, lp):
            return layers.mamba_block(x, lp, cfg)[0]

        if mode == "train":
            block = _maybe_remat(block, cfg)
        for i in range(cfg.n_layers):
            x = block(x, _layer(params["layers"], i))
        return x, None
    windows = ([], [], [])
    for i in range(cfg.n_layers):
        lc = (caches["conv_x"][i], caches["conv_B"][i], caches["conv_C"][i],
              caches["ssd"][i])
        x, nc = layers.mamba_block(x, _layer(params["layers"], i), cfg,
                                   cache=lc)
        for acc, w in zip(windows, nc[:3]):
            acc.append(w)
        caches["ssd"][i].copy_(nc[3])
    return x, {"conv_x": torch.stack(windows[0]),
               "conv_B": torch.stack(windows[1]),
               "conv_C": torch.stack(windows[2]), "ssd": caches["ssd"],
               "len": caches["len"] + x.shape[1]}


_BACKBONES = ("dense", "ssm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _BACKBONES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP A.8)")


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------

def forward(params: Params, tokens, cfg: ModelConfig, *, caches=None,
            mode: str = "train", return_hidden: bool = False):
    """Returns (logits, moe_aux_loss, new_caches); the aux loss is 0 in the
    dense and ssm families.  With ``return_hidden`` the final-norm hidden
    states replace the logits (the streaming-CE path computes the LM head
    itself).  In ``mode="train"`` each block is checkpointed as
    ``cfg.remat`` asks (:func:`_maybe_remat`).

    ``caches`` (from :func:`init_caches`) are updated in place: the
    returned dict holds the same K/V (dense) or SSD state (ssm) tensors,
    the ssm family's new conv windows and a new length vector."""
    _check_family(cfg)
    params = _cast(params, cfg)
    B, S = tokens.shape
    if caches is not None and mode == "decode":
        ln = caches["len"]
        positions = ln.expand(B, S) if ln.dim() == 0 else ln[:, None]
    else:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)

    x = embed_tokens(params, tokens, cfg)
    if cfg.family == "ssm":
        x, nc = _ssm_backbone(params, x, cfg, caches=caches, mode=mode)
    else:
        x, nc = _dense_backbone(params, x, cfg, positions=positions,
                                caches=caches, mode=mode)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return layers.norm(x, params["ln_f"], cfg), aux, nc
    return lm_head(params, x, cfg), aux, nc


def loss_fn(params: Params, batch: Mapping[str, torch.Tensor],
            cfg: ModelConfig, aux_weight: float = 0.01):
    """Mean token cross-entropy of the training forward against
    ``batch["targets"]``, plus ``aux_weight`` times the MoE aux loss.
    Returns (loss, {"ce", "aux", "ppl"}), all float32 scalars.

    The logits are taken to float32 before the logsumexp, as in the
    reference; with ``cfg.use_streaming_ce`` the fused, vocab-chunked CE
    of :mod:`.blocked_ce` replaces the full logits."""
    tokens, targets = batch["tokens"], batch["targets"]
    if cfg.use_streaming_ce:
        hidden, aux, _ = forward(params, tokens, cfg, mode="train",
                                 return_hidden=True)
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
        logits, aux, _ = forward(params, tokens, cfg, mode="train")
        logits = logits.to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        ce = torch.mean(logz - tgt)
    loss = ce + aux_weight * aux
    return loss, {"ce": ce, "aux": aux,
                  "ppl": torch.exp(torch.clamp(ce, max=20.0))}


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                device: Union[str, torch.device] = "cpu"):
    """Per-family caches, stacked on a leading layer axis.  The dense
    family's K/V are in the attention kernel's (B, KV, S, D) layout; the
    ssm family keeps the last W-1 pre-conv inputs of x, B and C and the
    (B, H, P, N) SSD state, whatever ``max_seq`` is.  Every cache but the
    float32 SSD state and the int32 lengths is bfloat16 whatever
    ``cfg.dtype`` is, as in the reference.  On the ``meta`` device the
    caches take no memory (:meth:`TorchExecutor.cache_bytes` sizes them
    so)."""
    _check_family(cfg)
    L = cfg.n_layers

    def mk(shape, dt=torch.bfloat16):
        return torch.zeros(shape, dtype=dt, device=device)

    out = {"len": mk((batch,), torch.int32)}
    if cfg.family == "dense":
        kv = (L, batch, cfg.n_kv, max_seq, cfg.hd)
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
    return out


def cache_logical_axes(cfg: ModelConfig):
    """Logical axis names for every cache leaf (the executor reads the
    batch axis from them)."""
    _check_family(cfg)
    if cfg.family == "dense":
        kv = (None, "batch", "kv_heads", "cache_seq", "head_dim")
        return {"len": (None,), "k": kv, "v": kv}
    return {"len": (None,), "conv_x": (None, "batch", None, "conv_dim"),
            "conv_B": (None, "batch", None, None),
            "conv_C": (None, "batch", None, None),
            "ssd": (None, "batch", "ssm_heads", None, None)}


__all__ = ["cache_logical_axes", "embed_tokens", "forward", "init_caches",
           "init_params", "lm_head", "loss_fn", "model_defs", "torch_dtype"]
