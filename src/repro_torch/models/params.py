"""Declarative parameter tables and initialization, in torch.

The port of ``repro.models.params`` for the dense and ssm families.  One
table per architecture declares every parameter's shape and init scale; random
initialization reads it, drawing from an explicit ``torch.Generator``.
The reference's logical sharding axes are dropped: the port runs on one
card.

:func:`params_from_jax` carries the reference's parameters (as numpy
arrays) across, so both packages can run the same weights, and
:func:`state_from_jax` a whole train state (parameters, AdamW moments and
step), so both trainers can start from the same state.
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
    init: str = "normal"          # normal | zeros | ones | ssm_a | ssm_dt
    scale: Optional[float] = None  # None -> 1/sqrt(fan_in)


ParamTree = Dict[str, object]   # nested dicts of ParamDef / tensors


def _fan_in_scale(shape: Tuple[int, ...]) -> float:
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return 1.0 / math.sqrt(max(fan_in, 1))


def _uniform(gen: torch.Generator, shape, lo: float, hi: float):
    return torch.rand(shape, generator=gen, dtype=torch.float32) \
        * (hi - lo) + lo


def _init_leaf(gen: torch.Generator, d: ParamDef,
               dtype: torch.dtype) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype)
    if d.init == "ssm_a":       # Mamba2: A in [-1.5, -0.5]
        return (-_uniform(gen, d.shape, 0.5, 1.5)).to(dtype)
    if d.init == "ssm_dt":      # dt bias ~ softplus^-1(U(1e-3, 1e-1))
        u = _uniform(gen, d.shape, 1e-3, 1e-1)
        return torch.log(torch.expm1(u)).to(dtype)
    if d.init != "normal":
        raise ValueError(f"unknown init {d.init!r}")
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
# the dense and ssm families' tables
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


def mamba2_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """Mamba-2 (SSD) mixer, with the reference's separate z/x/B/C/dt input
    projections."""
    d = cfg.d_model
    inner = cfg.ssm_inner
    H, N, G = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    return {
        "w_z": ParamDef((d, inner)),
        "w_x": ParamDef((d, inner)),
        "w_B": ParamDef((d, G * N)),
        "w_C": ParamDef((d, G * N)),
        "w_dt": ParamDef((d, H)),
        "conv_x_w": ParamDef((cfg.ssm_conv, inner)),
        "conv_x_b": ParamDef((inner,), init="zeros"),
        "conv_B_w": ParamDef((cfg.ssm_conv, G * N)),
        "conv_B_b": ParamDef((G * N,), init="zeros"),
        "conv_C_w": ParamDef((cfg.ssm_conv, G * N)),
        "conv_C_b": ParamDef((G * N,), init="zeros"),
        "A_log": ParamDef((H,), init="ssm_a"),
        "dt_bias": ParamDef((H,), init="ssm_dt"),
        "D": ParamDef((H,), init="ones"),
        "norm_w": ParamDef((inner,), init="ones"),
        "w_out": ParamDef((inner, d), scale=_resid_scale(cfg, inner)),
    }


def _norm(cfg: ModelConfig) -> Dict[str, ParamDef]:
    return {"w": ParamDef((cfg.d_model,), init="ones")}


def block_defs(cfg: ModelConfig, kind: str = "attn") -> Dict[str, object]:
    """One residual block: pre-norm + attention + pre-norm + MLP
    (``"attn"``), or pre-norm + Mamba-2 mixer (``"mamba"``)."""
    if kind == "attn":
        return {"ln1": _norm(cfg), "attn": attn_defs(cfg),
                "ln2": _norm(cfg), "ffn": mlp_defs(cfg)}
    if kind == "mamba":
        return {"ln1": _norm(cfg), "mixer": mamba2_defs(cfg)}
    raise ValueError(kind)


#: the families ported, each with its block kind
_FAMILY_BLOCKS = {"dense": "attn", "ssm": "mamba"}


def model_defs(cfg: ModelConfig) -> ParamTree:
    """Full parameter table of a dense model with RMSNorm and a gated silu
    MLP, or of a Mamba-2 (ssm) model with RMSNorm (the kinds ported)."""
    if cfg.family not in _FAMILY_BLOCKS or (cfg.norm, cfg.act) != \
            ("rmsnorm", "silu"):
        raise NotImplementedError(
            f"{cfg.family} model with {cfg.norm} and {cfg.act}: only the "
            f"dense and ssm rmsnorm/silu families are ported (ROADMAP A.8)")
    out: ParamTree = {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model), scale=0.02),
        "ln_f": _norm(cfg),
    }
    if not cfg.tie_embeddings:
        out["unembed"] = ParamDef((cfg.d_model, cfg.padded_vocab))
    out["layers"] = _map(lambda p: _stack(cfg.n_layers, p),
                         block_defs(cfg, _FAMILY_BLOCKS[cfg.family]))
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


def state_from_jax(state: Mapping, cfg: ModelConfig,
                   device: Union[str, torch.device] = "cpu") -> Dict:
    """A reference train state (``repro.training.init_state`` or
    ``Trainer.state``, as nested dicts of numpy arrays: ``params``,
    ``opt`` with ``m`` and ``v``, ``step``) as the port's: the three
    parameter-shaped trees through :func:`params_from_jax`, the step as a
    0-dim int32 tensor, all on ``device``."""
    return {"params": params_from_jax(state["params"], cfg, device),
            "opt": {k: params_from_jax(state["opt"][k], cfg, device)
                    for k in ("m", "v")},
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}


__all__ = ["ParamDef", "block_defs", "init_params", "mamba2_defs",
           "model_defs", "params_from_jax", "state_from_jax"]
