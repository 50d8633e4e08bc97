"""Abstract input specs for every (arch × shape) cell, on the ``meta``
device.

The port of ``repro.launch.specs``: stand-ins with the inputs' shapes and
dtypes that take no memory, which the dry-run (:mod:`.dryrun`) turns
into fake tensors.  Token ids are int64, as the port's trainer and
executor make them (the reference's are int32).  Modality frontends are
stubs: ``[audio]``/``[vlm]`` cells receive precomputed frame/patch
embeddings.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models import ModelConfig, init_caches
from ..models.config import ShapeConfig


def sds(shape, dtype: torch.dtype) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype`` (the counterpart of a
    ``jax.ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _aux(cfg: ModelConfig, B: int) -> Dict[str, torch.Tensor]:
    out = {}
    if cfg.family == "vlm":
        out["img_embeds"] = sds((B, cfg.n_img_tokens, cfg.d_model),
                                torch.bfloat16)
    if cfg.family == "encdec":
        out["frames"] = sds((B, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    return out


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig
                      ) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": sds((B, S), torch.int64),
            "targets": sds((B, S), torch.int64), **_aux(cfg, B)}


def serve_input_specs(cfg: ModelConfig, shape: ShapeConfig
                      ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(aux/token specs, cache specs).  For ``decode`` kinds the step
    consumes one new token against a seq_len-deep cache; for ``prefill``
    the step consumes the full prompt and writes the cache."""
    B, S = shape.global_batch, shape.seq_len
    caches = init_caches(cfg, B, S, device="meta")
    toks = {"tokens": sds((B, 1 if shape.kind == "decode" else S),
                          torch.int64), **_aux(cfg, B)}
    return toks, caches


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """The dry-run entry: the step's inputs by name."""
    if shape.kind == "train":
        return {"batch": train_input_specs(cfg, shape)}
    toks, caches = serve_input_specs(cfg, shape)
    return {"batch": toks, "caches": caches}


__all__ = ["input_specs", "sds", "serve_input_specs", "train_input_specs"]
