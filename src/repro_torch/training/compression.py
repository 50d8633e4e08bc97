"""Error-feedback int8 gradient compression (distributed-optimization
trick for the DP all-reduce), over the port's nested-dict trees.

The port of ``repro.training.compression``.  Each tensor is quantized to
int8 with a per-tensor scale before crossing the data-parallel axis; the
quantization residual is kept locally and added back into the next
step's gradient (error feedback), which keeps SGD/Adam convergence
unbiased in the long run.  8x less DP traffic for <1% noise per step
once feedback has warmed up.

``torch.round`` rounds half to even, as ``jnp.round`` does, so on the
same float32 inputs the payloads and scales equal the reference's bit
for bit.  A quantized tree has the gradients' structure with a
(payload, scale) pair in each leaf's place.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from .tree import leaves_with_paths, tree_map, unflatten


def compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float grad -> (int8 payload, f32 scale)."""
    amax = torch.max(torch.abs(g))
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones_like(amax)).to(torch.float32)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_feedback(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_grads(grads, feedback):
    """Apply error feedback, quantize, and return (quantized tree,
    new feedback tree).  The quantized tree (a (payload, scale) pair per
    leaf, same structure) is what crosses the wire."""
    qs, fbs = {}, {}
    fb = dict(leaves_with_paths(feedback))
    for path, g in leaves_with_paths(grads):
        g_corr = g.to(torch.float32) + fb[path]
        q, s = compress(g_corr)
        qs[path] = (q, s)
        fbs[path] = g_corr - decompress(q, s)
    return unflatten(grads, qs), unflatten(grads, fbs)


def decompress_grads(qtree):
    """The quantized tree's gradients, float32, in its structure."""
    return _map_pairs(lambda pair: decompress(*pair), qtree)


def _map_pairs(fn, tree):
    if isinstance(tree, tuple):
        return fn(tree)
    return {k: _map_pairs(fn, v) for k, v in tree.items()}


__all__ = ["compress", "compress_grads", "decompress", "decompress_grads",
           "init_feedback"]
