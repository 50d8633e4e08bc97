"""DAG-level kernel fusion: IR stitching for producer→consumer chains.

The paper's §4 metadata (:class:`~repro.core.passes.ParallelRegionMD`,
the ``llvm.mem.parallel_loop_access`` analogue) exists so that *later
generic passes* can exploit data-parallelism the source level has lost.
This module is such a pass, operating one level above the kernel
compiler: given a chain of elementwise kernels enqueued back-to-back on
one queue — each a pure map where work-item *i* touches exactly element
*i* of every buffer — it composes ONE stitched :class:`~repro.core.ir.
Function` by concatenating the kernels' CFGs and *value-forwarding* the
producer's store into the consumer's load (docs/compiler.md §Fusion):

* each segment's blocks are renamed ``k<i>_…`` and its ``Return`` is
  replaced by a ``Jump`` to the next segment's entry;
* buffer parameters bound to the *same* Buffer object across segments
  collapse into one fused parameter (scalars stay per-segment);
* for every chain edge, the producer's single store to the chained
  buffer defines an SSA value that replaces every consumer load of that
  buffer — legal because both sides index at ``global_id(0)``
  (:class:`~repro.core.passes.BufferFootprint.gid_only`), so the
  forwarding is per-lane exact;
* an *elided* edge additionally deletes the store and drops the buffer
  from the fused signature — the intermediate is never allocated (lazy
  pool-backed buffers, docs/memory.md) and never written back.

The stitched function is checked by :func:`~repro.core.passes.verify_ir`
and wrapped in a :class:`~repro.core.program.Program`, so it flows
through the ordinary plan tier and device compilation caches; the
:class:`FusedSpec` produced here is itself cached under a structural
:class:`~repro.core.cache.FusedKey`, making steady-state fusion of a
repeated chain one dict lookup (docs/caching.md §Fused-chain caching).

The legality analysis (which enqueued commands may chain, which edges
may elide) lives with the DAG pattern-matcher in
:mod:`repro.runtime.queue`; this module provides the per-kernel
admission test (:func:`fusible_kernel`) and the pure IR surgery, so it
is testable without a runtime in sight.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .cache import CompilationCache, FusedKey, ir_hash
from .errors import BuildError, register_error
from .ir import (BufferArg, Function, Jump, LOCAL, Return, ScalarArg,
                 Value)
from .passes import (KernelFusibility, WorkGroupPlan, kernel_fusibility,
                     verify_ir)
from .program import Program


@register_error
class FusionError(BuildError):
    """A chain that passed the DAG matcher failed IR stitching — always
    a bug in the legality analysis, surfaced typed so the queue can fall
    back to unfused execution instead of corrupting results."""

    code = -9997
    code_name = "REPRO_FUSION_FAILED"


@dataclass(frozen=True)
class ChainEdge:
    """One forwarded buffer between two adjacent chain segments."""

    producer: int        # segment index writing the buffer
    consumer: int        # segment index (producer + 1) reading it
    prod_arg: str        # parameter name in the producer's signature
    cons_arg: str        # parameter name in the consumer's signature
    elide: bool          # drop the store + the fused parameter entirely


def fusible_kernel(plan_or_fn) -> bool:
    """Admission test for one kernel: elementwise per the middle-end's
    :class:`~repro.core.passes.KernelFusibility` facts, and — when a
    :class:`~repro.core.passes.WorkGroupPlan` is given — every region's
    :class:`~repro.core.passes.ParallelRegionMD` proves ``wi_parallel``
    (no region may carry cross-work-item dependencies the forwarding
    would reorder)."""
    if isinstance(plan_or_fn, WorkGroupPlan):
        facts = plan_or_fn.fusibility
        if facts is None:
            facts = kernel_fusibility(plan_or_fn.fn)
        if not all(m.wi_parallel for m in plan_or_fn.md.values()):
            return False
        return facts.elementwise
    facts = plan_or_fn if isinstance(plan_or_fn, KernelFusibility) \
        else kernel_fusibility(plan_or_fn)
    return facts.elementwise


def _single_return_block(fn: Function, seg: int) -> str:
    exits = fn.exit_blocks()
    if len(exits) != 1:
        raise FusionError(
            f"fusion segment {seg} ({fn.name!r}) has {len(exits)} return "
            f"blocks; elementwise kernels are straight-line")
    return exits[0]


def stitch_functions(fns: Sequence[Function],
                     edges: Sequence[ChainEdge],
                     alias_groups: Sequence[Sequence[Tuple[int, str]]],
                     name: Optional[str] = None
                     ) -> Tuple[Function, Dict[Tuple[int, str], str],
                                Dict[Tuple[int, str], str]]:
    """Compose one stitched Function from ``fns`` (chain order).

    ``alias_groups`` lists the (segment, arg-name) pairs bound to one
    buffer object; each group becomes a single fused parameter named
    after its first member (``k<seg>_<arg>`` — deterministic, so the
    canonical IR hash of the stitched function is stable across
    processes).  Returns ``(fused_fn, buffer_map, scalar_map)`` where
    the maps take ``(segment, original_name)`` to the fused parameter
    name (elided parameters are absent from ``buffer_map``).

    The input functions are mutated (renamed in place); callers pass
    freshly built IR, exactly as the compilation pipeline does.
    """
    if len(fns) < 2:
        raise FusionError("a fusion chain needs at least 2 kernels")
    fused_name = name or ("fused__" + "__".join(f.name for f in fns))
    for i, fn in enumerate(fns):
        facts = kernel_fusibility(fn)
        if not facts.elementwise:
            raise FusionError(
                f"fusion segment {i} ({fn.name!r}) is not elementwise: "
                f"{list(facts.reasons)}")

    # -- fused parameter names --------------------------------------------------
    group_of: Dict[Tuple[int, str], str] = {}
    for grp in alias_groups:
        members = sorted(grp)
        fname = f"k{members[0][0]}_{members[0][1]}"
        for m in members:
            group_of[tuple(m)] = fname
    buffer_map: Dict[Tuple[int, str], str] = {}
    scalar_map: Dict[Tuple[int, str], str] = {}
    fused = Function(fused_name, ndim=1)
    fused.blocks = {}
    seen_params: Dict[str, BufferArg] = {}
    for i, fn in enumerate(fns):
        for a in fn.buffer_args:
            if a.space == LOCAL:
                raise FusionError(
                    f"segment {i} has LOCAL array {a.name!r}")
            fname = group_of.get((i, a.name), f"k{i}_{a.name}")
            prev = seen_params.get(fname)
            if prev is None:
                arg = BufferArg(fname, a.dtype, a.space, a.size)
                seen_params[fname] = arg
                fused.buffer_args.append(arg)
            elif prev.dtype != a.dtype:
                raise FusionError(
                    f"aliased parameter {fname!r} bound with dtypes "
                    f"{prev.dtype} and {a.dtype}")
            buffer_map[(i, a.name)] = fname
        for a in fn.scalar_args:
            fname = f"k{i}_{a.name}"
            fused.scalar_args.append(ScalarArg(fname, a.dtype))
            fused.arg_values[fname] = fn.arg_values[a.name]
            scalar_map[(i, a.name)] = fname

    # -- rename + concatenate the CFGs ------------------------------------------
    entries: List[str] = []
    exits: List[str] = []
    for i, fn in enumerate(fns):
        exits.append(f"k{i}_{_single_return_block(fn, i)}")
        bmap = {n: f"k{i}_{n}" for n in fn.blocks}
        for old, blk in list(fn.blocks.items()):
            blk.name = bmap[old]
            blk.terminator = blk.terminator.replace(bmap)
            for phi in blk.phis:
                phi.incomings = {bmap.get(p, p): v
                                 for p, v in phi.incomings.items()}
            for ins in blk.instrs:
                if ins.op in ("load", "store"):
                    ins.attrs = dict(ins.attrs)
                    ins.attrs["buffer"] = buffer_map[
                        (i, str(ins.attrs["buffer"]))]
            fused.blocks[blk.name] = blk
        entries.append(f"k{i}_{fn.entry}")
    fused.entry = entries[0]
    for i in range(len(fns) - 1):
        fused.blocks[exits[i]].terminator = Jump(entries[i + 1])
    assert isinstance(fused.blocks[exits[-1]].terminator, Return)

    # -- value-forward each chain edge ------------------------------------------
    elided_params: List[str] = []
    for e in edges:
        if e.consumer != e.producer + 1:
            raise FusionError(
                f"chain edge {e} is not between adjacent segments")
        pname = buffer_map[(e.producer, e.prod_arg)]
        cname = buffer_map[(e.consumer, e.cons_arg)]
        if pname != cname:
            raise FusionError(
                f"edge {e}: producer arg maps to {pname!r} but consumer "
                f"arg to {cname!r} — not one buffer object")
        stores = [(blk, ins) for blk in fused.blocks.values()
                  if blk.name.startswith(f"k{e.producer}_")
                  for ins in blk.instrs
                  if ins.op == "store" and ins.attrs["buffer"] == pname]
        if len(stores) != 1:
            raise FusionError(
                f"edge {e}: producer has {len(stores)} stores to "
                f"{pname!r}; forwarding needs exactly one")
        store_blk, store = stores[0]
        forwarded: Value = store.operands[1]
        if not isinstance(forwarded, Value):
            raise FusionError(f"edge {e}: store of a raw constant")
        loads = [(blk, ins) for blk in fused.blocks.values()
                 if blk.name.startswith(f"k{e.consumer}_")
                 for ins in blk.instrs
                 if ins.op == "load" and ins.attrs["buffer"] == pname]
        if not loads:
            raise FusionError(
                f"edge {e}: consumer never loads {pname!r}")
        # SSA legality: a store under producer control flow does not
        # define the value on every path — it must dominate every load
        # it replaces (straight-line producers trivially satisfy this)
        dom = fused.dominators()
        for blk, _ in loads:
            if store_blk.name not in dom.get(blk.name, set()):
                raise FusionError(
                    f"edge {e}: store in {store_blk.name!r} does not "
                    f"dominate load in {blk.name!r}")
        replace: Dict[int, Value] = {}
        for _, ld in loads:
            if ld.result.dtype != forwarded.dtype:
                raise FusionError(
                    f"edge {e}: load dtype {ld.result.dtype} != stored "
                    f"value dtype {forwarded.dtype}")
            replace[ld.result.id] = forwarded
        dead = {id(ins) for _, ins in loads}
        for blk in fused.blocks.values():
            if not blk.name.startswith(f"k{e.consumer}_"):
                continue
            blk.instrs = [ins for ins in blk.instrs
                          if id(ins) not in dead]
            for ins in blk.instrs:
                ins.operands = [replace.get(o.id, o)
                                if isinstance(o, Value) else o
                                for o in ins.operands]
            for phi in blk.phis:
                phi.incomings = {p: replace.get(v.id, v)
                                 if isinstance(v, Value) else v
                                 for p, v in phi.incomings.items()}
        if e.elide:
            store_blk.instrs = [ins for ins in store_blk.instrs
                                if ins is not store]
            elided_params.append(pname)
    for pname in elided_params:
        still_used = any(
            ins.attrs.get("buffer") == pname
            for blk in fused.blocks.values() for ins in blk.instrs
            if ins.op in ("load", "store"))
        if still_used:
            raise FusionError(
                f"elided parameter {pname!r} still accessed after "
                f"forwarding — elision legality was mis-judged")
        fused.buffer_args = [a for a in fused.buffer_args
                             if a.name != pname]
        for key in [k for k, v in buffer_map.items() if v == pname]:
            del buffer_map[key]

    fused.verify()
    verify_ir(fused, (), pass_name="fusion-stitch")
    return fused, buffer_map, scalar_map


# ---------------------------------------------------------------------------
# FusedSpec — the cached, relaunchable product of one stitched chain
# ---------------------------------------------------------------------------

class _FusionContext:
    """Minimal Program-context shim: just the shared plan-cache tier, so
    a fused Program created inside the runtime reuses the same
    :class:`~repro.core.cache.CompilationCache` that holds its
    :class:`FusedSpec` (one cache object per device: fused tier, plan
    tier, and compiled-kernel tier all in one place)."""

    def __init__(self, cache: CompilationCache):
        self.cache = cache


@dataclass
class FusedSpec:
    """Everything the DAG rewriter needs to launch a stitched chain.

    Steady-state relaunch is argument re-binding through ``buffer_map``/
    ``scalar_map`` plus a memoized ``program.binary_for`` lookup — no
    stitching, planning, or compilation.
    """

    key: FusedKey
    kernel_name: str
    program: Program
    buffer_map: Dict[Tuple[int, str], str]   # (seg, arg) -> fused param
    scalar_map: Dict[Tuple[int, str], str]
    elided: Tuple[Tuple[int, str], ...]      # (seg, producer arg) elided
    names: Tuple[str, ...]                   # constituent kernel names

    def bind_launch(self, buffers_per_seg: Sequence[Dict[str, object]],
                    scalars_per_seg: Sequence[Dict[str, object]]
                    ) -> Tuple[Dict[str, object], Dict[str, object]]:
        """Rebind one chain's per-segment launch arguments to the fused
        signature (elided parameters are skipped — their buffers are
        never touched)."""
        buffers: Dict[str, object] = {}
        for i, segbufs in enumerate(buffers_per_seg):
            for arg, buf in segbufs.items():
                fname = self.buffer_map.get((i, arg))
                if fname is not None:
                    buffers[fname] = buf
        scalars: Dict[str, object] = {}
        for i, segscal in enumerate(scalars_per_seg):
            for arg, val in segscal.items():
                scalars[self.scalar_map[(i, arg)]] = val
        return buffers, scalars


def make_fused_key(ir_hashes: Sequence[str], edges: Sequence[ChainEdge],
                   alias_groups: Sequence[Sequence[Tuple[int, str]]],
                   **options) -> FusedKey:
    return FusedKey(
        parts=tuple(ir_hashes),
        edges=tuple((e.producer, e.consumer, e.prod_arg, e.cons_arg,
                     e.elide) for e in edges),
        aliases=tuple(tuple(sorted(tuple(m) for m in g))
                      for g in alias_groups),
        options=tuple(sorted(options.items())))


def build_fused_spec(builders: Sequence[Callable[[], Function]],
                     names: Sequence[str],
                     edges: Sequence[ChainEdge],
                     alias_groups: Sequence[Sequence[Tuple[int, str]]],
                     cache: CompilationCache,
                     key: Optional[FusedKey] = None,
                     **program_options) -> FusedSpec:
    """Build (or fetch from ``cache``'s fused tier) the
    :class:`FusedSpec` for one chain topology.

    ``builders`` are the constituent kernels' zero-argument IR builders
    (the Program contract: every call yields a fresh CFG), so the fused
    Program can re-stitch deterministically whenever a specialization
    needs fresh IR.
    """
    edges = tuple(edges)
    alias_groups = tuple(tuple(tuple(m) for m in g) for g in alias_groups)
    if key is None:
        key = make_fused_key([ir_hash(b()) for b in builders], edges,
                             alias_groups, **program_options)

    def construct() -> FusedSpec:
        def fused_builder() -> Function:
            fn, _, _ = stitch_functions([b() for b in builders], edges,
                                        alias_groups)
            return fn
        fn, buffer_map, scalar_map = stitch_functions(
            [b() for b in builders], edges, alias_groups)
        program = Program([fused_builder], context=_FusionContext(cache),
                          **program_options)
        # Program re-derived the builder's IR; assert the stitch is
        # deterministic (equal canonical hashes) so cached binaries match
        assert program.ir_hash(fn.name) == ir_hash(fn), \
            "stitched chain is not deterministic"
        elided = tuple(
            (e.producer, e.prod_arg) for e in edges if e.elide)
        return FusedSpec(key=key, kernel_name=fn.name, program=program,
                         buffer_map=buffer_map, scalar_map=scalar_map,
                         elided=elided, names=tuple(names))

    return cache.get_or_build_fused(key, construct)


__all__ = ["ChainEdge", "FusedSpec", "FusionError", "build_fused_spec",
           "fusible_kernel", "make_fused_key", "stitch_functions"]
