"""Declarative parameter tables and initialization, in torch.

The port of ``repro.models.params`` for the dense family.  One table per
architecture declares every parameter's shape and init scale; random
initialization reads it, drawing from an explicit ``torch.Generator``.
The reference's logical sharding axes are dropped: the port runs on one
card.

:func:`params_from_jax` carries the reference's parameters (as numpy
arrays) across, so both packages can run the same weights.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"          # normal | ones
    scale: Optional[float] = None  # None -> 1/sqrt(fan_in)


ParamTree = Dict[str, object]   # nested dicts of ParamDef / tensors


def _fan_in_scale(shape: Tuple[int, ...]) -> float:
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return 1.0 / math.sqrt(max(fan_in, 1))


def _init_leaf(gen: torch.Generator, d: ParamDef,
               dtype: torch.dtype) -> torch.Tensor:
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype)
    if d.init != "normal":
        raise ValueError(f"init {d.init!r} belongs to a family that is not "
                         f"ported yet (ROADMAP A.8)")
    scale = d.scale if d.scale is not None else _fan_in_scale(d.shape)
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32) * scale
    return x.to(dtype)


def _map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_params(defs: ParamTree, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: Union[str, torch.device] = "cpu") -> ParamTree:
    """Random parameters for ``defs``, drawn on the CPU from
    ``generator`` in table order and moved to ``device``, so a seed gives
    the same weights on every device."""
    return _map(lambda d: _init_leaf(generator, d, dtype).to(device), defs)


# ---------------------------------------------------------------------------
# the dense family's table
# ---------------------------------------------------------------------------

def _stack(n: int, d: ParamDef) -> ParamDef:
    """Stack a per-layer def along a leading layer axis."""
    return ParamDef((n,) + d.shape, d.init, d.scale)


def _resid_scale(cfg: ModelConfig, fan_in: int) -> float:
    """Residual-branch output projections: fan-in init divided by
    sqrt(2L) (GPT-2 style) so the residual stream's scale stays
    depth-stable."""
    return 1.0 / (math.sqrt(fan_in) * math.sqrt(2.0 * max(cfg.n_layers, 1)))


def attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv
    return {
        # explicit fan-in scales: the heuristic (shape[-2]) would read the
        # HEAD COUNT for these 3D projections, not d_model
        "wq": ParamDef((d, H, hd), scale=1.0 / math.sqrt(d)),
        "wk": ParamDef((d, KV, hd), scale=1.0 / math.sqrt(d)),
        "wv": ParamDef((d, KV, hd), scale=1.0 / math.sqrt(d)),
        "wo": ParamDef((H, hd, d), scale=_resid_scale(cfg, H * hd)),
    }


def mlp_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """The gated (silu) MLP."""
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_up": ParamDef((d, f)),
        "w_down": ParamDef((f, d), scale=_resid_scale(cfg, f)),
        "w_gate": ParamDef((d, f)),
    }


def _norm(cfg: ModelConfig) -> Dict[str, ParamDef]:
    return {"w": ParamDef((cfg.d_model,), init="ones")}


def block_defs(cfg: ModelConfig) -> Dict[str, object]:
    """One residual block: pre-norm + attention + pre-norm + MLP."""
    return {"ln1": _norm(cfg), "attn": attn_defs(cfg),
            "ln2": _norm(cfg), "ffn": mlp_defs(cfg)}


def model_defs(cfg: ModelConfig) -> ParamTree:
    """Full parameter table of a dense model with RMSNorm and a gated silu
    MLP (the only kind ported)."""
    if (cfg.family, cfg.norm, cfg.act) != ("dense", "rmsnorm", "silu"):
        raise NotImplementedError(
            f"{cfg.family} model with {cfg.norm} and {cfg.act}: only the "
            f"dense rmsnorm/silu family is ported (ROADMAP A.8)")
    out: ParamTree = {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model), scale=0.02),
        "ln_f": _norm(cfg),
    }
    if not cfg.tie_embeddings:
        out["unembed"] = ParamDef((cfg.d_model, cfg.padded_vocab))
    out["layers"] = _map(lambda p: _stack(cfg.n_layers, p), block_defs(cfg))
    return out


def params_from_jax(tree: Mapping, cfg: ModelConfig,
                    device: Union[str, torch.device] = "cpu") -> ParamTree:
    """The reference's parameters (``repro.models.init_params``, as a
    nested dict of numpy arrays) as the port's: the same tree, the same
    dtypes, tensors on ``device``.  Every leaf is checked against this
    port's table for ``cfg``."""
    defs = model_defs(cfg)

    def walk(d, t, path):
        if isinstance(d, ParamDef):
            x = torch.from_numpy(np.array(t, copy=True)).to(device)
            if tuple(x.shape) != d.shape:
                raise ValueError(f"{path}: shape {tuple(x.shape)}, the "
                                 f"table says {d.shape}")
            return x
        if set(d) != set(t):
            raise ValueError(f"{path or 'params'}: keys {sorted(t)}, the "
                             f"table has {sorted(d)}")
        return {k: walk(d[k], t[k], f"{path}/{k}") for k in d}

    return walk(defs, tree, "")


__all__ = ["ParamDef", "block_defs", "init_params", "model_defs",
           "params_from_jax"]
