"""Declarative parameter tables and initialization, in torch.

The port of ``repro.models.params`` for all six families (dense, moe,
ssm, hybrid, vlm, encdec).  One table per architecture declares every
parameter's shape, logical sharding axes and init scale; random
initialization reads it, drawing from an explicit ``torch.Generator``,
and so do the ``meta``-device stand-ins of the dry-run
(:func:`abstract_params`) and the mesh placements (:func:`param_pspecs`,
:func:`param_placements`), so the three can never drift apart.

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

from ..distributed.sharding import ShardingRules, logical_to_sharding
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | ssm_a | ssm_dt
    scale: Optional[float] = None  # None -> 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"ParamDef: shape {self.shape} and logical "
                             f"axes {self.logical} differ in length")


ParamTree = Dict[str, object]   # nested dicts of ParamDef / tensors


def _fan_in_scale(shape: Tuple[int, ...]) -> float:
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return 1.0 / math.sqrt(max(fan_in, 1))


def _uniform(gen: torch.Generator, shape, lo: float, hi: float):
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=gen.device) \
        * (hi - lo) + lo


def _init_leaf(gen: torch.Generator, d: ParamDef,
               dtype: torch.dtype) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=gen.device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=gen.device)
    if d.init == "ssm_a":       # Mamba2: A in [-1.5, -0.5]
        return (-_uniform(gen, d.shape, 0.5, 1.5)).to(dtype)
    if d.init == "ssm_dt":      # dt bias ~ softplus^-1(U(1e-3, 1e-1))
        u = _uniform(gen, d.shape, 1e-3, 1e-1)
        return torch.log(torch.expm1(u)).to(dtype)
    if d.init != "normal":
        raise ValueError(f"unknown init {d.init!r}")
    scale = d.scale if d.scale is not None else _fan_in_scale(d.shape)
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    return x.to(dtype)


def _map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_params(defs: ParamTree, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: Union[str, torch.device] = "cpu") -> ParamTree:
    """Random parameters for ``defs``, drawn from ``generator`` in table
    order on the generator's device and moved to ``device``.  A CPU
    generator gives the same weights on every device; a CUDA generator
    draws billions of parameters in a second where the host takes a
    minute, and gives the same weights on every card of its kind."""
    return _map(lambda d: _init_leaf(generator, d, dtype).to(device), defs)


def abstract_params(defs: ParamTree,
                    dtype: torch.dtype = torch.float32) -> ParamTree:
    """The parameters' shapes and dtype on the ``meta`` device: no
    memory, the dry-run's stand-ins."""
    return _map(lambda d: torch.empty(d.shape, dtype=dtype, device="meta"),
                defs)


def param_pspecs(defs: ParamTree, rules: ShardingRules) -> ParamTree:
    """Per leaf, the mesh axes of each dim (the entries of the
    reference's ``PartitionSpec``)."""
    return _map(lambda d: rules.spec(*d.logical), defs)


def param_placements(defs: ParamTree, mesh, rules: ShardingRules
                     ) -> ParamTree:
    """Per leaf, its DTensor placements on ``mesh`` (the counterpart of
    the reference's ``param_shardings``)."""
    return _map(lambda d: logical_to_sharding(mesh, rules, d.logical), defs)


def _leaves(tree):
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def count_params(defs: ParamTree) -> int:
    return int(sum(int(np.prod(d.shape)) for d in _leaves(defs)))


# ---------------------------------------------------------------------------
# per-family parameter tables
# ---------------------------------------------------------------------------

def _stack(n: int, d: ParamDef) -> ParamDef:
    """Stack a per-layer def along a leading (replicated) layer axis."""
    return ParamDef((n,) + d.shape, (None,) + d.logical, d.init, d.scale)


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
        "wq": ParamDef((d, H, hd), ("embed_fsdp", "heads", "head_dim"),
                       scale=1.0 / math.sqrt(d)),
        "wk": ParamDef((d, KV, hd), ("embed_fsdp", "kv_heads", "head_dim"),
                       scale=1.0 / math.sqrt(d)),
        "wv": ParamDef((d, KV, hd), ("embed_fsdp", "kv_heads", "head_dim"),
                       scale=1.0 / math.sqrt(d)),
        "wo": ParamDef((H, hd, d), ("heads", "head_dim", "embed_fsdp"),
                       scale=_resid_scale(cfg, H * hd)),
    }


def mlp_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """The MLP: gated (``w_gate``) for silu, not for gelu."""
    d, f = cfg.d_model, cfg.d_ff
    out = {
        "w_up": ParamDef((d, f), ("embed_fsdp", "mlp")),
        "w_down": ParamDef((f, d), ("mlp", "embed_fsdp"),
                           scale=_resid_scale(cfg, f)),
    }
    if cfg.act == "silu":       # gated
        out["w_gate"] = ParamDef((d, f), ("embed_fsdp", "mlp"))
    return out


def moe_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """The MoE FFN: a router and ``n_experts`` gated expert MLPs."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamDef((d, E), ("embed_fsdp", None), scale=0.02),
        "w_up": ParamDef((E, d, f), ("experts", "embed_fsdp", "expert_mlp")),
        "w_gate": ParamDef((E, d, f),
                           ("experts", "embed_fsdp", "expert_mlp")),
        "w_down": ParamDef((E, f, d), ("experts", "expert_mlp", "embed_fsdp"),
                           scale=_resid_scale(cfg, f)),
    }


def mamba2_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """Mamba-2 (SSD) mixer, with the reference's separate z/x/B/C/dt input
    projections."""
    d = cfg.d_model
    inner = cfg.ssm_inner
    H, N, G = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    return {
        "w_z": ParamDef((d, inner), ("embed_fsdp", "conv_dim")),
        "w_x": ParamDef((d, inner), ("embed_fsdp", "conv_dim")),
        "w_B": ParamDef((d, G * N), ("embed_fsdp", None)),
        "w_C": ParamDef((d, G * N), ("embed_fsdp", None)),
        "w_dt": ParamDef((d, H), ("embed_fsdp", "ssm_heads")),
        "conv_x_w": ParamDef((cfg.ssm_conv, inner), (None, "conv_dim")),
        "conv_x_b": ParamDef((inner,), ("conv_dim",), init="zeros"),
        "conv_B_w": ParamDef((cfg.ssm_conv, G * N), (None, None)),
        "conv_B_b": ParamDef((G * N,), (None,), init="zeros"),
        "conv_C_w": ParamDef((cfg.ssm_conv, G * N), (None, None)),
        "conv_C_b": ParamDef((G * N,), (None,), init="zeros"),
        "A_log": ParamDef((H,), ("ssm_heads",), init="ssm_a"),
        "dt_bias": ParamDef((H,), ("ssm_heads",), init="ssm_dt"),
        "D": ParamDef((H,), ("ssm_heads",), init="ones"),
        "norm_w": ParamDef((inner,), ("conv_dim",), init="ones"),
        "w_out": ParamDef((inner, d), ("conv_dim", "embed_fsdp"),
                          scale=_resid_scale(cfg, inner)),
    }


def _norm(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """RMSNorm's weight, and LayerNorm's bias beside it."""
    out = {"w": ParamDef((cfg.d_model,), ("d_model",), init="ones")}
    if cfg.norm == "layernorm":
        out["b"] = ParamDef((cfg.d_model,), ("d_model",), init="zeros")
    return out


def block_defs(cfg: ModelConfig, kind: str = "attn") -> Dict[str, object]:
    """One residual block: pre-norm + attention + pre-norm + FFN (MLP, or
    MoE in the moe family) (``"attn"``), pre-norm + Mamba-2 mixer
    (``"mamba"``), or the gated cross-attention block (``"cross"``)."""
    if kind == "attn":
        ffn = moe_defs(cfg) if cfg.family == "moe" else mlp_defs(cfg)
        return {"ln1": _norm(cfg), "attn": attn_defs(cfg),
                "ln2": _norm(cfg), "ffn": ffn}
    if kind == "mamba":
        return {"ln1": _norm(cfg), "mixer": mamba2_defs(cfg)}
    if kind == "cross":
        return {"ln": _norm(cfg), "xattn": attn_defs(cfg),
                "gate": ParamDef((1,), (None,), init="zeros")}
    raise ValueError(kind)


def model_defs(cfg: ModelConfig) -> ParamTree:
    """Full parameter table for any of the six families."""
    out: ParamTree = {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model),
                          ("vocab", "embed_fsdp"), scale=0.02),
        "ln_f": _norm(cfg),
    }
    if not cfg.tie_embeddings:
        out["unembed"] = ParamDef((cfg.d_model, cfg.padded_vocab),
                                  ("embed_fsdp", "vocab"))

    L = cfg.n_layers
    fam = cfg.family
    if fam in ("dense", "moe"):
        out["layers"] = _map(lambda p: _stack(L, p), block_defs(cfg, "attn"))
    elif fam in ("ssm", "hybrid"):
        out["layers"] = _map(lambda p: _stack(L, p), block_defs(cfg, "mamba"))
        if fam == "hybrid":
            # zamba2-style single SHARED attention block, applied every
            # ``attn_every`` mamba blocks: its parameters are not stacked
            out["shared_attn"] = block_defs(cfg, "attn")
    elif fam == "vlm":
        every = cfg.cross_attn_every
        if L % every:
            raise ValueError(f"vlm: n_layers {L} is not a multiple of "
                             f"cross_attn_every {every}")
        n_groups = L // every
        # self-attention decoder layers grouped (n_groups, every, ...)
        out["layers"] = _map(
            lambda p: ParamDef((n_groups, every) + p.shape,
                               (None, None) + p.logical, p.init, p.scale),
            block_defs(cfg, "attn"))
        out["cross"] = _map(lambda p: _stack(n_groups, p),
                            block_defs(cfg, "cross"))
    elif fam == "encdec":
        out["layers"] = _map(          # decoder: self + cross + ffn
            lambda p: _stack(L, p), {**block_defs(cfg, "attn"),
                                     "lnx": _norm(cfg),
                                     "xattn": attn_defs(cfg)})
        out["enc_layers"] = _map(lambda p: _stack(cfg.enc_layers, p),
                                 block_defs(cfg, "attn"))
        out["ln_enc"] = _norm(cfg)
        out["pos_embed"] = ParamDef((4096, cfg.d_model), (None, "d_model"),
                                    scale=0.02)
        out["enc_pos_embed"] = ParamDef((cfg.enc_seq, cfg.d_model),
                                        (None, "d_model"), scale=0.02)
    else:
        raise ValueError(f"unknown family {fam!r}")
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


__all__ = ["ParamDef", "abstract_params", "block_defs", "count_params",
           "init_params", "mamba2_defs", "model_defs", "moe_defs",
           "param_placements", "param_pspecs", "params_from_jax",
           "state_from_jax"]
