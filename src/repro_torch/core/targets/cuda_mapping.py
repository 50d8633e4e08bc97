"""How the ``cuda`` target maps a work-group plan onto a thread block.

One thread runs one work-item.  Three decisions, each taken from the
:class:`~repro_torch.core.passes.WorkGroupPlan` and the local size alone
(no flag, environment variable or per-kernel table chooses any of them):

1. **Region transitions.**  Where every region's successor is decided by
   work-group-uniform branches (:func:`is_direct`; a region with at most
   one successor needs none), each thread takes the branch itself and
   jumps straight to the next region: ``direct``.  Otherwise
   the kernel keeps the ``while (switch)`` schedule, in which work-item 0
   publishes the next region (the peeled first work-item of paper §4.4).

2. **Barriers.**  An explicit barrier always stays a ``__syncthreads()``.
   An implicit one (``entry``, ``exit`` and the §4.5/§4.6 b-loop
   barriers, which exist to form regions for targets that run work-items
   in a loop) is dropped when dropping it cannot reorder memory accesses
   of different work-items: between it and the nearest kept barrier (or
   kernel entry or exit) on one side there is no access to a memory that
   the other side stores to, or the other side does not touch it.  The
   kept set grows one barrier at a time, in schedule order, until every
   dropped barrier passes that test against the kept ones.  A kernel that
   races across an implicit barrier therefore keeps it, and with it the
   reference's lockstep result.  (Only direct kernels drop barriers: the
   ``while (switch)`` schedule needs its one barrier per region to publish
   the next region id.)

3. **Index bounds.**  :func:`int_ranges` bounds the int32 values that
   follow from the local size and literals.  An add, subtract or multiply
   whose bounds fit int32 cannot wrap, so it is emitted as plain C (which
   lets ``nvcc`` fold and vectorize addresses), and a ``LOCAL`` access
   whose index lies within the array needs neither the clamp of a load
   nor the range test of a store.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Sequence, Set, Tuple

import numpy as np

from .. import ir
from ..ir import CondBranch, Function, Value
from ..passes import WorkGroupPlan

INT32 = (-(1 << 31), (1 << 31) - 1)

Access = Tuple[str, bool]        # (memory class, is a store)


@dataclass(frozen=True)
class CudaMapping:
    """The mapping of one plan at one local size.

    ``direct``   regions jump straight to their successor (no ``switch``);
    ``kept``     barrier blocks emitted as ``__syncthreads()`` (every
                 barrier block when not ``direct``);
    ``ranges``   SSA value id -> (lo, hi) bounds of int32 values
                 (:func:`int_ranges`)."""

    direct: bool
    kept: FrozenSet[str]
    ranges: Dict[int, Tuple[int, int]]


def barrier_kind(fn: Function, bar: str) -> str:
    """``"explicit"`` or the ``implicit`` tag of barrier block ``bar``."""
    ins = next(i for i in fn.blocks[bar].instrs if i.op == "barrier")
    return str(ins.attrs.get("implicit", "")) or "explicit"


def _mem_class(fn: Function, buffer: str) -> str:
    """Each ``LOCAL`` array is its own memory; global buffers may alias,
    so they are one."""
    for a in fn.buffer_args:
        if a.name == buffer and a.space == ir.LOCAL:
            return buffer
    return "global"


def _block_accesses(fn: Function) -> Dict[str, List[Access]]:
    return {n: [(_mem_class(fn, i.attrs["buffer"]), i.op == "store")
                for i in blk.instrs if i.op in ("load", "store")]
            for n, blk in fn.blocks.items()}


def _side(fn: Function, start: List[str], step, kept: Set[str],
          acc: Dict[str, List[Access]]) -> Set[Access]:
    """Accesses on the blocks reached from ``start`` through ``step``
    without entering a kept barrier block."""
    seen: Set[str] = set()
    out: Set[Access] = set()
    stack = list(start)
    while stack:
        n = stack.pop()
        if n in seen or n in kept:
            continue
        seen.add(n)
        out.update(acc[n])
        stack.extend(step(n))
    return out


def _conflict(a: Set[Access], b: Set[Access]) -> bool:
    stores_a = {m for m, st in a if st}
    stores_b = {m for m, st in b if st}
    return any(m in stores_b for m, _ in a) or \
        any(m in stores_a for m, _ in b)


def kept_barriers(fn: Function, order: Sequence[str]) -> FrozenSet[str]:
    """The barrier blocks that stay a ``__syncthreads()`` (decision 2)."""
    acc = _block_accesses(fn)
    preds = fn.predecessors()
    kept = {b for b in order if barrier_kind(fn, b) == "explicit"}
    while True:
        for bar in order:
            if bar in kept:
                continue
            before = _side(fn, preds[bar], preds.__getitem__, kept, acc)
            after = _side(fn, fn.blocks[bar].successors(),
                          lambda n: fn.blocks[n].successors(), kept, acc)
            if _conflict(before, after):
                kept.add(bar)
                break
        else:
            return frozenset(kept)


def is_direct(plan: WorkGroupPlan) -> bool:
    """Decision 1: every region's successor is work-group uniform.  Every
    branch from which more than one successor barrier can be reached must
    be uniform.  (``ParallelRegionMD.uniform_exits`` checks only the
    branches that leave the region directly, so a varying branch that
    chooses the successor a block earlier passes it.)"""
    fn, uni = plan.fn, plan.uni
    for r in plan.wg.regions.values():
        if len(r.exits) <= 1:
            continue
        reach: Dict[str, Set[str]] = {}

        def exits_from(n: str) -> Set[str]:
            if n not in r.blocks:
                return {n}
            if n not in reach:
                reach[n] = set()
                seen, stack = set(), [n]
                while stack:
                    m = stack.pop()
                    if m in seen:
                        continue
                    seen.add(m)
                    for s in fn.blocks[m].successors():
                        if s in r.blocks:
                            stack.append(s)
                        else:
                            reach[n].add(s)
            return reach[n]

        for b in r.blocks:
            term = fn.blocks[b].terminator
            if isinstance(term, CondBranch) and len(exits_from(b)) > 1 \
                    and not (uni.value_uniform(term.cond)
                             and uni.block_uniform(b)):
                return False
    return True


def literal_int(o) -> int:
    """An integer literal as the emitter writes it (wrapped to int32)."""
    v = int(np.asarray(o).astype(np.int64)) & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def operand_range(ranges: Dict[int, Tuple[int, int]], o):
    """Bounds of an int32 operand, or None."""
    if isinstance(o, Value):
        return ranges.get(o.id)
    if np.asarray(o).dtype.kind in "iu":
        v = literal_int(o)
        return v, v
    return None


def _range(ins, r, lsz) -> "Tuple[int, int] | None":
    op = ins.op
    if op == "local_id":
        return 0, lsz[int(ins.attrs["dim"])] - 1
    if op == "local_size":
        n = lsz[int(ins.attrs["dim"])]
        return n, n
    args = [r(o) for o in ins.operands]
    if op == "convert":
        return args[0]
    if op == "select":
        args = args[1:]
    if len(args) != 2 or None in args:
        return None
    if op == "select":
        (a0, a1), (b0, b1) = args
        return min(a0, b0), max(a1, b1)
    (a0, a1), (b0, b1) = args
    if op == "add":
        return a0 + b0, a1 + b1
    if op == "sub":
        return a0 - b1, a1 - b0
    if op == "mul":
        p = (a0 * b0, a0 * b1, a1 * b0, a1 * b1)
        return min(p), max(p)
    if op == "min":
        return min(a0, b0), min(a1, b1)
    if op == "max":
        return max(a0, b0), max(a1, b1)
    if a0 < 0 or b0 < 0:
        return None
    if op == "rem" and b0 == b1 > 0:
        return 0, min(a1, b0 - 1)
    if op == "div" and b0 == b1 > 0:
        return a0 // b0, a1 // b0
    if op == "and":
        return 0, min(a1, b1)
    return None


def int_ranges(fn: Function, lsz: Sequence[int]) -> Dict[int, Tuple[int, int]]:
    """Bounds of the int32 SSA values that follow from local ids, the
    local size and literals through add, sub, mul, min, max, select,
    conversions, and rem, div and and of non-negative values.  A value
    whose bounds would leave int32 is left unbounded (the emitted
    arithmetic wraps there), as are group ids, scalars and registers."""
    ranges: Dict[int, Tuple[int, int]] = {}

    def r(o):
        if isinstance(o, Value) and np.dtype(o.dtype).kind not in "iu":
            return None
        return operand_range(ranges, o)

    for n in fn.rpo():
        for ins in fn.blocks[n].instrs:
            res = ins.result
            if res is None or np.dtype(res.dtype).kind not in "iu":
                continue
            b = _range(ins, r, lsz)
            if b is not None and INT32[0] <= b[0] and b[1] <= INT32[1]:
                ranges[res.id] = b
    return ranges


def map_plan(plan: WorkGroupPlan, lsz: Sequence[int]) -> CudaMapping:
    """The three decisions for ``plan`` at local size ``lsz`` (3-tuple)."""
    fn, wg = plan.fn, plan.wg
    direct = is_direct(plan)
    kept = kept_barriers(fn, wg.order) if direct else frozenset(wg.order)
    return CudaMapping(direct=direct, kept=kept, ranges=int_ranges(fn, lsz))


__all__ = ["CudaMapping", "barrier_kind", "int_ranges", "is_direct",
           "kept_barriers", "map_plan", "operand_range"]
