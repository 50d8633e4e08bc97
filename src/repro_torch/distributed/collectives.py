"""Hierarchical cross-pod gradient reduction.

The port of ``repro.distributed.collectives``.  On a multi-pod mesh the
data-parallel axis factors as (pod, data).  The naive all-reduce moves
every gradient byte across the (slow, few-link) pod interconnect once per
participant.  The hierarchical schedule

  1. reduce-scatter inside each pod      (fast links, 1/data of the bytes)
  2. all-reduce the scattered shards across pods (bytes/data)
  3. all-gather inside each pod          (fast links)

moves only 1/data of the gradient bytes over the pod axis.  The three
steps are ``torch.distributed`` collectives on the process groups of a
(``pod``, ``data``, ``model``) :class:`DeviceMesh`'s dims; without a
``pod`` dim the sum is one all-reduce over ``data``.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
import torch.distributed as dist
import torch.nn.functional as F


def _psum_one(g: torch.Tensor, mesh) -> torch.Tensor:
    names = mesh.mesh_dim_names
    out = g.contiguous().clone()
    if "pod" not in names:
        dist.all_reduce(out, group=mesh.get_group("data"))
        return out
    data = mesh.get_group("data")
    n = mesh.size(names.index("data"))
    flat = out.reshape(-1)
    # the flat gradient padded to a multiple of the pod's data ranks
    flat = F.pad(flat, (0, (-flat.numel()) % n))
    # 1. reduce-scatter in-pod over 'data'
    scat = torch.empty(flat.numel() // n, dtype=g.dtype, device=g.device)
    dist.reduce_scatter_tensor(scat, flat, group=data)
    # 2. all-reduce across pods (small shards)
    dist.all_reduce(scat, group=mesh.get_group("pod"))
    # 3. all-gather in-pod
    full = torch.empty_like(flat)
    dist.all_gather_into_tensor(full, scat, group=data)
    return full[:g.numel()].view(g.shape)


def hierarchical_psum(tree, mesh):
    """Sum every tensor of ``tree`` (a tensor or nested dicts of them,
    this rank's values) over the mesh's
    ('pod', 'data') dims, hierarchically; a flat all-reduce over 'data'
    when there is no pod dim.  Every rank of those dims calls it and gets
    the sum."""
    if isinstance(tree, Mapping):
        return {k: hierarchical_psum(v, mesh) for k, v in tree.items()}
    return _psum_one(tree, mesh)


def hierarchical_grad_reduce(grad_fn: Callable, mesh) -> Callable:
    """Wrap a per-shard grad function so its output grads are reduced
    hierarchically: ``grad_fn(params, batch)`` gives this rank's
    (unreduced, local) gradients of its shard of the batch, with the
    parameters replicated; the wrapper returns their sum over ('pod',
    'data')."""
    def reduced(params, batch):
        return hierarchical_psum(grad_fn(params, batch), mesh)
    return reduced


__all__ = ["hierarchical_grad_reduce", "hierarchical_psum"]
