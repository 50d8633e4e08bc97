"""End-to-end dense language model, in torch.

The port of the dense family of ``repro.models.model``: the compute-dtype
cast of the parameters, the embedding and LM head, the backbone (a Python
loop over the stacked layers where the reference scanned them), the
forward entry point, and the KV caches.  Other families raise.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Union

import torch

from ..kernels.ref import matmul
from . import layers
from . import params as P
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

def _dense_backbone(params, x, cfg, *, positions, caches):
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        if caches is None:
            x, _ = layers.attn_block(x, lp, cfg, positions=positions)
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


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------

def forward(params: Params, tokens, cfg: ModelConfig, *, caches=None,
            mode: str = "train"):
    """Returns (logits, moe_aux_loss, new_caches); the aux loss is 0 in a
    dense model.

    ``caches`` (from :func:`init_caches`) are updated in place: the
    returned dict holds the same K/V tensors and a new length vector."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP A.8)")
    params = _cast(params, cfg)
    B, S = tokens.shape
    if caches is not None and mode == "decode":
        ln = caches["len"]
        positions = ln.expand(B, S) if ln.dim() == 0 else ln[:, None]
    else:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)

    x = embed_tokens(params, tokens, cfg)
    x, nc = _dense_backbone(params, x, cfg, positions=positions,
                            caches=caches)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return lm_head(params, x, cfg), aux, nc


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                device: Union[str, torch.device] = "cpu"):
    """The dense family's caches, stacked on a leading layer axis, in the
    attention kernel's (B, KV, S, D) layout.  The K/V caches are bfloat16
    whatever ``cfg.dtype`` is, as in the reference."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP A.8)")
    kv = (cfg.n_layers, batch, cfg.n_kv, max_seq, cfg.hd)
    return {"len": torch.zeros((batch,), dtype=torch.int32, device=device),
            "k": torch.zeros(kv, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(kv, dtype=torch.bfloat16, device=device)}


def cache_logical_axes(cfg: ModelConfig):
    """Logical axis names for every cache leaf (the executor reads the
    batch axis from them)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP A.8)")
    kv = (None, "batch", "kv_heads", "cache_seq", "head_dim")
    return {"len": (None,), "k": kv, "v": kv}


__all__ = ["cache_logical_axes", "embed_tokens", "forward", "init_caches",
           "init_params", "lm_head", "model_defs", "torch_dtype"]
