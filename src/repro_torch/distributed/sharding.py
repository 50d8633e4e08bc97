"""Logical-axis sharding rules for the (pod, data, model) mesh, as DTensor
placements.

The port of ``repro.distributed.sharding``.  The model stack annotates
every tensor with **logical axis names** (batch/seq/heads/mlp/...) and
this module owns the single table that maps logical names onto the axes
of a ``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`.
Changing the parallel mapping edits the rule table only; the model
definition is untouched, as retargeting a pocl work-group function from
SIMD lanes to VLIW slots leaves the kernel alone.

Where the reference builds a ``PartitionSpec`` (one entry per tensor
dim), :meth:`ShardingRules.spec` returns a plain tuple with the same
entries; :func:`logical_to_sharding` turns it into the DTensor
placements of a mesh (one entry per mesh dim), and :func:`constrain`
redistributes a DTensor to them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple, Union

from torch.distributed.tensor import DTensor, Replicate, Shard

Axis = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical-name -> physical mesh axis (or tuple of axes) mapping."""

    batch: Axis = ("pod", "data")       # global batch dimension
    seq: Axis = None                    # sequence (attention/mixer-internal)
    act_seq: Axis = "model"             # residual-stream sequence dim:
    # sharding the saved per-layer residuals over the model axis is
    # Megatron-style sequence parallelism
    heads: Axis = "model"               # attention query heads
    kv_heads: Axis = None               # GQA KV heads (often < model size)
    head_dim: Axis = None
    d_model: Axis = None                # residual stream (activations)
    embed_fsdp: Axis = "data"           # the d_model dim OF PARAMS: FSDP /
    # ZeRO-style sharding over the data axis.  Off for serving (latency).
    mlp: Axis = "model"                 # FFN hidden
    vocab: Axis = "model"               # embedding / logits vocab dim
    experts: Axis = "model"             # MoE expert dimension (EP)
    expert_mlp: Axis = None             # MoE per-expert FFN hidden (TP)
    moe_capacity: Axis = None           # dispatch capacity dim
    cache_seq: Axis = None              # KV-cache sequence dim (decode)
    ssm_heads: Axis = "model"           # Mamba2 SSD heads
    ssm_state: Axis = None
    conv_dim: Axis = "model"            # Mamba conv channels

    def spec(self, *logical: Optional[str]) -> Tuple[Axis, ...]:
        """The mesh axes of a tensor whose dims carry these logical names:
        the entries of the reference's ``PartitionSpec``, one per dim (a
        one-axis tuple as its axis, as ``PartitionSpec`` keeps it)."""
        def entry(name):
            axis = None if name is None else getattr(self, name)
            return axis[0] if isinstance(axis, tuple) and len(axis) == 1 \
                else axis
        return tuple(entry(name) for name in logical)

    def replace(self, **kw) -> "ShardingRules":
        return dataclasses.replace(self, **kw)


# Paper-faithful baseline: plain 2D data x tensor parallelism, experts on the
# model axis when divisible.
BASELINE_RULES = ShardingRules()

# Prefill: weights stay fully materialized per model-rank (no FSDP
# regather per layer): serving batches are small and latency-bound.
PREFILL_RULES = BASELINE_RULES.replace(embed_fsdp=None)

# Decode: KV caches shard along the cache sequence dimension so 32k-token
# caches fit; params keep their tensor-parallel sharding (heads on
# "model").  S=1 steps cannot shard the token dim, so act_seq is off.
DECODE_RULES = BASELINE_RULES.replace(cache_seq="model", act_seq=None,
                                      embed_fsdp=None)

# Long-context single-sequence decode (batch=1): no data parallelism is
# possible, so the cache sequence shards over BOTH mesh axes.
LONG_DECODE_RULES = BASELINE_RULES.replace(
    batch=None, cache_seq=("data", "model"), act_seq=None, embed_fsdp=None)


def _axis_size(mesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def _kept(entry: Axis, names: Sequence[str]) -> Axis:
    """``entry`` without the mesh axes the mesh does not have."""
    if isinstance(entry, tuple):
        kept = tuple(a for a in entry if a in names)
        return kept if kept else None
    if isinstance(entry, str):
        return entry if entry in names else None
    return entry


def logical_to_sharding(mesh, rules: ShardingRules,
                        logical: Sequence[Optional[str]]) -> List:
    """The DTensor placements (one per mesh dim) of a tensor whose dims
    carry these logical names.

    Mesh axes the mesh lacks are dropped (e.g. "pod" on the single-pod
    mesh), as in the reference.  Two cases have no single placement and
    are handled so:

    - one tensor dim on a tuple of mesh axes (``batch=("pod", "data")``,
      ``cache_seq=("data", "model")``): ``Shard(d)`` on each named mesh
      dim, which DTensor splits in mesh-dim order, the order a
      ``PartitionSpec`` tuple gives;
    - two tensor dims on the same mesh axis (which a ``PartitionSpec``
      refuses): the first dim keeps the axis, the later ones replicate.

    A mesh dim of size 1 replicates whatever the rules name: one piece
    is the whole tensor, and DTensor then has no cut dim to work around.
    """
    names = mesh.mesh_dim_names
    placements = [Replicate() for _ in names]
    taken = set()
    for d, entry in enumerate(rules.spec(*logical)):
        entry = _kept(entry, names)
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        for a in axes:
            if a in taken:
                continue
            taken.add(a)
            if _axis_size(mesh, a) > 1:
                placements[names.index(a)] = Shard(d)
    return placements


def constrain(x, rules: Optional[ShardingRules], *logical: Optional[str]):
    """Redistribute a DTensor to the placements the rules give these
    logical names: the counterpart of ``with_sharding_constraint``.  The
    gradient that comes back through it returns to the placements the
    DTensor had, even where it had these already.  A plain tensor (no
    mesh) or ``rules=None`` comes back as it is."""
    if rules is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh,
                          logical_to_sharding(x.device_mesh, rules, logical))


@contextlib.contextmanager
def implicit_replication() -> Iterator[None]:
    """``torch.distributed.tensor.experimental.implicit_replication``,
    re-entrant: plain tensors that meet DTensors inside (positions,
    RoPE's angles, masks) join them as replicated.  PyTorch's own turns
    the switch off when any nested use ends, which would leave a remat
    re-forward in the backward without it; this one restores what it
    found."""
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def prune_to_mesh(rules: ShardingRules, mesh) -> ShardingRules:
    """Drop mesh axes the target mesh does not have (e.g. 'pod' on the
    single-pod mesh) from every rule entry."""
    names = mesh.mesh_dim_names
    return ShardingRules(**{f.name: _kept(getattr(rules, f.name), names)
                            for f in dataclasses.fields(rules)})


def divisible(n: int, mesh, axis: Axis) -> bool:
    """Whether dim of size n divides evenly over the mesh axes in ``axis``."""
    if axis is None:
        return True
    axes = (axis,) if isinstance(axis, str) else axis
    names = mesh.mesh_dim_names
    total = 1
    for a in axes:
        if a in names:
            total *= _axis_size(mesh, a)
    return n % total == 0


def adapt_rules_for(rules: ShardingRules, mesh, *,
                    n_kv: int = 0, n_experts: int = 0,
                    n_heads: int = 0, d_ff: int = 0,
                    vocab: int = 0) -> ShardingRules:
    """Fix up rules whose dims don't divide the mesh (pocl's 'local size
    not a multiple of the vector width' fallback, applied to mesh axes).

    - KV heads that don't divide the model axis are replicated (GQA).
    - An expert count that doesn't divide the model axis falls back to
      TOKEN-PARALLEL MoE (capacity dim on the model axis); the TP
      fallback remains available as the 'moe_tp_fallback' variant.
    """
    out = rules
    if n_kv and not divisible(n_kv, mesh, rules.kv_heads):
        out = out.replace(kv_heads=None)
    if n_heads and not divisible(n_heads, mesh, rules.heads):
        out = out.replace(heads=None)
    if n_experts and not divisible(n_experts, mesh, rules.experts):
        out = out.replace(experts=None, expert_mlp=None,
                          moe_capacity="model")
    if vocab and not divisible(vocab, mesh, rules.vocab):
        out = out.replace(vocab=None)
    return out


def rules_for_model(cfg, mesh, base: ShardingRules = BASELINE_RULES
                    ) -> ShardingRules:
    """``base`` pruned to the mesh's axes and adapted to ``cfg``'s head,
    expert and vocab counts: the rules the trainer and the training
    entry point use on a mesh, as ``repro.launch.train`` builds them."""
    return adapt_rules_for(prune_to_mesh(base, mesh), mesh, n_kv=cfg.n_kv,
                           n_experts=cfg.n_experts, n_heads=cfg.n_heads,
                           d_ff=cfg.d_ff, vocab=cfg.padded_vocab)


__all__ = ["Axis", "BASELINE_RULES", "DECODE_RULES", "LONG_DECODE_RULES",
           "PREFILL_RULES", "ShardingRules", "adapt_rules_for", "constrain",
           "divisible", "implicit_replication", "logical_to_sharding", "prune_to_mesh",
           "rules_for_model"]
