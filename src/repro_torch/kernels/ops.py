"""Dispatch wrappers: hand-written CUDA kernel vs plain torch reference.

The model stack calls these; ``use_kernels`` selects the kernels of this
package (:mod:`.rmsnorm`, :mod:`.decode_attention`, :mod:`.ssd_scan`,
:mod:`.flash_attention`), whose wrappers launch the CUDA kernel for CUDA
tensors and run its plain version for CPU tensors.  ``use_kernels=False``
selects :mod:`.ref`.  Attention with kernels goes through
:class:`repro_torch.models.flash.FlashAttention`, the flash kernel's
forward with the blocked backward of ``models/flash.py``; the SSD scan
with kernels through :class:`.ssd_scan.SSDScan`, the scan kernel's
forward with the gradient of the reference's scan.

On a mesh the inputs are DTensors.  A kernel launches through ``ctypes``
on ``data_ptr()``, so a DTensor handed to it would be wrong, not slow:
each entry point then runs its kernel on the local shards through
``torch.distributed.tensor.experimental.local_map``, which also carries
the autograd of :class:`FlashAttention`, :class:`.rmsnorm.RMSNorm` and
:class:`.ssd_scan.SSDScan`.  The placements local_map is given are
declared from the sharding rules (:func:`kernel_placements`), and an
input whose placements differ raises: the layers constrain each input to
the rules first, so a difference is a fault.  A placement the kernel
cannot take (a sequence, head size or ``d_model`` cut over more than one
device) raises too.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..core.errors import InvalidArgError
from ..distributed.sharding import ShardingRules, logical_to_sharding
from . import decode_attention as _dec
from . import ref
from . import rmsnorm as _rms
from . import ssd_scan as _ssd

#: the logical names of each kernel's tensors, in its argument order, and
#: the dims each needs whole
_LOGICAL: Dict[str, Tuple[Tuple[Optional[str], ...], ...]] = {
    "attention": (("batch", "heads", "seq", "head_dim"),
                  ("batch", "kv_heads", "seq", "head_dim"),
                  ("batch", "kv_heads", "seq", "head_dim")),
    "blocked_attention": (("batch", "seq", "heads", "head_dim"),
                          ("batch", "seq", "kv_heads", "head_dim"),
                          ("batch", "seq", "kv_heads", "head_dim")),
    "decode_attention": (("batch", "heads", "head_dim"),
                         ("batch", "kv_heads", "cache_seq", "head_dim"),
                         ("batch", "kv_heads", "cache_seq", "head_dim"),
                         ("batch",)),
    "ssd_scan": (("batch", "seq", "ssm_heads", None),
                 ("batch", "seq", "ssm_heads"),
                 ("ssm_heads",),
                 ("batch", "seq", None, None),
                 ("batch", "seq", None, None)),
}
_WHOLE = {"attention": (2, 3), "blocked_attention": (1, 3),
          "decode_attention": (2, 3), "ssd_scan": (1,)}


def kernel_placements(kernel: str, mesh, rules: ShardingRules) -> list:
    """The placements each tensor argument of ``kernel`` has on ``mesh``
    under ``rules``: the declaration :func:`local_map` is given."""
    return [logical_to_sharding(mesh, rules, lg) for lg in _LOGICAL[kernel]]


def _cut(mesh, placements, dim: int) -> int:
    """How many pieces ``placements`` cut tensor dim ``dim`` into."""
    n = 1
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            n *= mesh.size(i)
    return n


def _check_whole(kernel: str, mesh, placements, dims: Sequence[int],
                 what: str) -> None:
    for d in dims:
        if _cut(mesh, placements, d) > 1:
            raise InvalidArgError(
                f"{kernel} on a mesh: {what} dim {d} is sharded "
                f"({list(placements)}); the kernel needs it whole")


def _shard_index(mesh, placements, dim: int) -> int:
    """This rank's shard of tensor dim ``dim``, counted over the mesh
    dims that cut it, in mesh-dim order (DTensor's nesting)."""
    idx = 0
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx


def _grouped(kernel: str, mesh, qpl, kpl, n_q: int, n_kv: int,
             q_dim: int, kv_dim: int):
    """How the local query heads find their KV heads (or SSD groups).

    Returns None where the local shards line up as they are (heads
    whole, or query and KV heads cut alike), else the local query heads'
    KV indices, for KV heads that stay whole while the query heads are
    cut."""
    nq, nk = _cut(mesh, qpl, q_dim), _cut(mesh, kpl, kv_dim)
    if nq == 1 and nk == 1:
        return None
    if nq == nk and all((isinstance(a, Shard) and a.dim == q_dim)
                        == (isinstance(b, Shard) and b.dim == kv_dim)
                        for a, b in zip(qpl, kpl)):
        return None
    if nk != 1:
        raise InvalidArgError(
            f"{kernel} on a mesh: query heads cut {nq} ways and KV heads "
            f"{nk} ways ({list(qpl)} against {list(kpl)})")
    hl = n_q // nq
    first = _shard_index(mesh, qpl, q_dim) * hl
    return torch.div(torch.arange(first, first + hl), n_q // n_kv,
                     rounding_mode="floor")


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient comes back contiguous.  A local
    backward may return a strided gradient (a slice of a padded block,
    a transpose); local_map hands it to DTensor, whose next operator
    takes the local strides for the global ones and views them (PyTorch
    2.11)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _on_shards(fn, tensors, inp, outp):
    """``fn`` on the local shards of DTensor ``tensors``, through
    local_map with the declared input placements ``inp`` (a DTensor
    placed otherwise raises) and output placements ``outp``.  An input
    replicated over a mesh dim that cuts the output (a norm's weight
    beside cut rows, KV heads beside cut query heads) gets back a
    partial-sum gradient there: each shard's gradient covers its own
    part of the work."""
    mesh = tensors[0].device_mesh
    cut = {i for i, p in enumerate(outp[0]) if isinstance(p, Shard)}
    grad = tuple([Partial() if i in cut and isinstance(p, Replicate) else p
                  for i, p in enumerate(pl)] for pl in inp)

    def run(*ts):
        return fn(*(_ContiguousGrad.apply(t) if t.requires_grad else t
                    for t in ts))
    return local_map(run, out_placements=tuple(outp) if len(outp) > 1
                     else outp[0], in_placements=tuple(inp),
                     in_grad_placements=grad, device_mesh=mesh)(*tensors)


#: per kernel: the query heads' argument and dim, the arguments whose
#: heads (KV heads, SSD groups) serve them, and those arguments' dim
_GROUPS = {"attention": (0, 1, (1, 2), 1),
           "blocked_attention": (0, 2, (1, 2), 2),
           "decode_attention": (0, 1, (1, 2), 1),
           "ssd_scan": (0, 2, (3, 4), 2)}


def _sharded(kernel: str, fn, tensors, rules: Optional[ShardingRules],
             out_logical):
    """:func:`_on_shards` with the placements :func:`kernel_placements`
    declares for ``kernel`` and the outputs' logical names; a dim the
    kernel needs whole that is cut raises; whole KV heads beside cut
    query heads are picked per local query head (:func:`_grouped`)."""
    if rules is None:
        raise InvalidArgError(f"{kernel}: DTensor inputs need the sharding "
                              f"rules that placed them")
    mesh = tensors[0].device_mesh
    inp = kernel_placements(kernel, mesh, rules)
    for i, (pl, lg) in enumerate(zip(inp, _LOGICAL[kernel])):
        _check_whole(kernel, mesh, pl,
                     [d for d in _WHOLE[kernel] if d < len(lg)],
                     f"argument {i}")
    qa, qd, kvs, kd = _GROUPS[kernel]
    sel = _grouped(kernel, mesh, inp[qa], inp[kvs[0]], tensors[qa].shape[qd],
                   tensors[kvs[0]].shape[kd], qd, kd)

    def run(*ts):
        if sel is not None:
            ts = [t.index_select(kd, sel.to(t.device)) if i in kvs else t
                  for i, t in enumerate(ts)]
        return fn(*ts)
    outp = [logical_to_sharding(mesh, rules, lg) for lg in out_logical]
    return _on_shards(run, tensors, inp, outp)


def attention(q, k, v, causal: bool = True, use_kernels: bool = False,
              block_q: int = 512, block_k: int = 1024,
              rules: Optional[ShardingRules] = None):
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D).  With kernels, the
    backward runs in ``(block_q, block_k)`` blocks; the reference ignores
    the block sizes.  DTensor inputs run on their local shards, placed
    by ``rules``: batch and heads may be cut, the sequence and head size
    not; KV heads that stay whole while the query heads are cut are
    picked per local query head."""
    if isinstance(q, DTensor):
        return _sharded("attention", lambda q, k, v: attention(
            q, k, v, causal, use_kernels, block_q, block_k), (q, k, v),
            rules, [_LOGICAL["attention"][0]])
    if use_kernels:
        # imported here: repro_torch.models imports this package
        from ..models.flash import FlashAttention
        return FlashAttention.apply(q, k, v, causal, None, block_q, block_k)
    return ref.attention(q, k, v, causal=causal)


def blocked_attention(q, k, v, causal: bool, block_q: int, block_k: int,
                      rules: Optional[ShardingRules] = None):
    """The memory-efficient attention of :mod:`repro_torch.models.flash`
    (no kernel: torch in blocks, with its own backward), q (B, Sq, H, D)
    and k, v (B, Sk, Hkv, D).  DTensor inputs run on their local shards
    as :func:`attention`'s do: its backward writes its blocks in place,
    which a DTensor cannot take."""
    from ..models.flash import blocked_attention as blocked
    if isinstance(q, DTensor):
        return _sharded("blocked_attention", lambda q, k, v: blocked_attention(
            q, k, v, causal, block_q, block_k), (q, k, v), rules,
            [_LOGICAL["blocked_attention"][0]])
    return blocked(q, k, v, causal=causal, block_q=block_q, block_k=block_k)


def decode_attention(q, k_cache, v_cache, lengths, use_kernels: bool = False,
                     rules: Optional[ShardingRules] = None):
    """q: (B, H, D); caches (B, Hkv, S, D); lengths (B,).  DTensor inputs
    run on their local shards as :func:`attention`'s do; the cache's
    sequence may not be cut."""
    if isinstance(q, DTensor):
        return _sharded("decode_attention", lambda q, k, v, n:
                        decode_attention(q, k, v, n, use_kernels),
                        (q, k_cache, v_cache, lengths), rules,
                        [_LOGICAL["decode_attention"][0]])
    if use_kernels:
        return _dec.decode_attention(q, k_cache, v_cache, lengths)
    return ref.decode_attention(q, k_cache, v_cache, lengths)


def rmsnorm(x, w, eps: float = 1e-6, use_kernels: bool = False):
    """Over the last dim.  A DTensor ``x`` runs on its local rows, with
    its own placements for the row dims (any cut of rows is fine for a
    row-wise norm); its last dim must be whole and ``w`` replicated, or
    it raises."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        xpl = list(x.placements)
        if any(isinstance(p, Partial) for p in xpl):
            raise InvalidArgError(f"rmsnorm on a mesh: x is a partial sum "
                                  f"({xpl}); reduce it first")
        _check_whole("rmsnorm", mesh, xpl, [x.dim() - 1], "x")
        rep = [Replicate()] * mesh.ndim
        if isinstance(w, DTensor) and tuple(w.placements) != tuple(rep):
            w = w.redistribute(mesh, rep)     # a weight cut with its channels

        def local(x, w):
            return rmsnorm(x, w, eps, use_kernels)
        return _on_shards(local, (x, w), [xpl, rep], [xpl])
    if use_kernels:
        return _rms.rmsnorm(x, w, eps=eps)
    return ref.rmsnorm(x, w, eps=eps)


def embedding(table, ids):
    """``table[ids]`` for a DTensor table: the table gathered whole (a
    (vocab, d) weight) and each rank's ids looked up locally, the rows
    placed as the ids are.  DTensor's own gather cannot take a cut
    table and cut ids together in some PyTorch versions (its backward
    in 2.11, its masked reduction in 2.13)."""
    mesh = table.device_mesh
    rep = [Replicate()] * mesh.ndim
    table = table.redistribute(mesh, rep)
    ipl = [Replicate() if isinstance(p, Partial) else p
           for p in ids.placements]
    return _on_shards(lambda t, i: t[i],
                      (table, ids.redistribute(mesh, ipl)), [rep, ipl],
                      [ipl])


def expertwise(fn, x, *weights):
    """``fn(x, *weights)`` for a DTensor x (E, ...) of per-expert rows on
    its local shards, each of ``weights`` (E, ...) cut over the experts
    as x is and otherwise whole: the expert FFN of the moe family, whose
    einsums DTensor would flatten across a cut capacity dim (refused in
    some PyTorch versions, 2.11)."""
    mesh = x.device_mesh
    xpl = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    x = x.redistribute(mesh, xpl)
    wpl = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
           for p in xpl]
    weights = [w.redistribute(mesh, wpl) for w in weights]
    return _on_shards(fn, (x, *weights),
                      [xpl] + [wpl] * len(weights), [xpl])


def rowwise(fn, x, *others):
    """``fn(x, *others)`` for a DTensor x (..., V) whose last dim is whole
    on its local rows, each of ``others`` (...) placed as x's leading
    dims; the result (...) too.  For the cross-entropy over the logits:
    DTensor's backward of ``gather`` builds its zeros at the global
    shape (a (B, S, V) float32 tensor on every device)."""
    mesh = x.device_mesh
    xpl = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    _check_whole("rowwise", mesh, xpl, [x.dim() - 1], "x")
    x = x.redistribute(mesh, xpl)
    others = [t.redistribute(mesh, xpl) for t in others]
    return _on_shards(fn, (x, *others), [xpl] * (1 + len(others)), [xpl])


def channelwise(fn, x, *params):
    """``fn(x, *params)`` for a DTensor x (B, S, C) on its local shards,
    each sequence whole (gathered where it is cut), with each of
    ``params`` (..., C) cut over the channels as x is: for an operator
    that needs each sequence whole and treats channels apart
    (Mamba-2's causal conv, whose padding DTensor cannot place in some
    PyTorch versions, 2.11)."""
    mesh = x.device_mesh
    # the sequences gathered whole, a partial sum reduced
    xpl = [Replicate() if isinstance(p, Partial)
           or isinstance(p, Shard) and p.dim == 1 else p
           for p in x.placements]
    x = x.redistribute(mesh, xpl)
    pls = []
    for t in params:
        pl = [Shard(t.dim() - 1) if isinstance(p, Shard) and p.dim == 2
              else Replicate() for p in xpl]
        pls.append(pl)
    params = [t.redistribute(mesh, pl) for t, pl in zip(params, pls)]
    return _on_shards(fn, (x, *params), [xpl, *pls], [xpl])


def ssd_scan(x, dt, A, B, C, chunk: int = 64, use_kernels: bool = False,
             rules: Optional[ShardingRules] = None):
    """Returns (y, final_state) either way, each with a gradient, for any
    length s (a ragged last chunk taken with dt = 0): with kernels the
    kernel's forward and the gradient of the reference scan recomputed
    (:class:`.ssd_scan.SSDScan`), without them the reference scan
    (:func:`.ssd_scan.ssd_scan_reference`).  DTensor inputs run on their
    local shards: batch and heads may be cut, the sequence not; B and C's
    groups stay whole, picked per local head where heads are cut."""
    if isinstance(x, DTensor):
        return _sharded("ssd_scan", lambda x, dt, A, B, C: ssd_scan(
            x, dt, A, B, C, chunk, use_kernels), (x, dt, A, B, C), rules,
            [_LOGICAL["ssd_scan"][0], ("batch", "ssm_heads", None, None)])
    if use_kernels:
        return _ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)
    return _ssd.ssd_scan_reference(x, dt, A, B, C, chunk=chunk)


__all__ = ["attention", "blocked_attention", "channelwise",
           "decode_attention", "embedding", "expertwise",
           "kernel_placements", "rmsnorm", "rowwise", "ssd_scan"]
