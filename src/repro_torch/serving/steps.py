"""Prefill / decode step functions over the torch model (the port of
``repro.serving.steps``, which the reference shares between the serving
engine and the multi-pod dry-run).  A batch is a dict with ``tokens``;
the dense family takes no other inputs."""

from __future__ import annotations

import torch

from ..models import ModelConfig, forward


def make_prefill_step(cfg: ModelConfig):
    """The prefill step: consumes a full prompt batch, fills the KV caches
    (in place) and returns the last-position logits."""
    def prefill_step(params, batch, caches):
        logits, _, caches = forward(params, batch["tokens"], cfg,
                                    caches=caches, mode="prefill")
        return logits[:, -1], caches
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """The decode step: one synchronized token for the whole batch,
    greedily sampled from the step logits."""
    def decode_step(params, batch, caches):
        logits, _, caches = forward(params, batch["tokens"], cfg,
                                    caches=caches, mode="decode")
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return tok, caches
    return decode_step
