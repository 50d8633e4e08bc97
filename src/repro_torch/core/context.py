"""Private-variable context allocation (paper §4.7).

Values and virtual registers whose lifetime spans more than one parallel
region are placed in *context data arrays*: one element per work-item.
Values used only inside their defining region stay in (vector) registers —
the paper's lifetime optimization.  Uniform values are *merged* into a single
shared scalar instead of a per-WI array (§4.7 "merging of uniform
variables"), cutting context space; the saving is reported by
``ContextPlan.stats`` and benchmarked in ``benchmarks/bench_context.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Set, Tuple

import numpy as np

from .ir import CondBranch, Function, Value
from .regions import WGInfo
from .uniformity import Uniformity


@dataclass(frozen=True)
class Slot:
    kind: str          # 'val' | 'vreg'
    key: object        # Value id (int) or vreg name (str)
    dtype: str
    uniform: bool      # uniform slots are merged to a shared scalar
    name: str


@dataclass
class ContextPlan:
    slots: List[Slot]
    val_slots: Dict[int, Slot]
    vreg_slots: Dict[str, Slot]

    def stats(self, local_size: int) -> Dict[str, int]:
        merged = sum(1 for s in self.slots if s.uniform)
        bytes_merged = sum(
            np.dtype(s.dtype).itemsize * (1 if s.uniform else local_size)
            for s in self.slots)
        bytes_unmerged = sum(np.dtype(s.dtype).itemsize * local_size
                             for s in self.slots)
        return {
            "slots": len(self.slots),
            "uniform_merged": merged,
            "context_bytes": bytes_merged,
            "context_bytes_unmerged": bytes_unmerged,
        }


def fold_constants(fn: Function) -> None:
    """Replace uses of ``const`` results with numpy literals and delete the
    const instructions — cross-region constants are rematerialized for free
    instead of occupying context slots."""
    lits: Dict[int, object] = {}
    for blk in fn.blocks.values():
        for ins in blk.instrs:
            if ins.op == "const":
                lits[ins.result.id] = np.dtype(ins.result.dtype).type(
                    ins.attrs["value"])

    def sub(o):
        if isinstance(o, Value) and o.id in lits:
            return lits[o.id]
        return o

    for blk in fn.blocks.values():
        blk.instrs = [i for i in blk.instrs if i.op != "const"]
        for ins in blk.instrs:
            ins.operands = [sub(o) for o in ins.operands]
        term = blk.terminator
        if isinstance(term, CondBranch):
            term.cond = sub(term.cond)


def _region_touches(wg: WGInfo) -> Tuple[
        Dict[int, Set[str]], Dict[int, str], Dict[str, Set[str]]]:
    """Returns (value uses per region, value def block, vreg touch regions)."""
    fn = wg.fn
    val_use_regions: Dict[int, Set[str]] = {}
    val_def_block: Dict[int, str] = {}
    vreg_regions: Dict[str, Set[str]] = {}
    for bar, region in wg.regions.items():
        for bname in region.blocks:
            blk = fn.blocks[bname]
            for ins in blk.instrs:
                for o in ins.operands:
                    if isinstance(o, Value):
                        val_use_regions.setdefault(o.id, set()).add(bar)
                if ins.op in ("vreg_read", "vreg_write"):
                    vreg_regions.setdefault(ins.attrs["vreg"], set()).add(bar)
                if ins.result is not None:
                    val_def_block[ins.result.id] = bname
            term = blk.terminator
            if isinstance(term, CondBranch) and isinstance(term.cond, Value):
                val_use_regions.setdefault(term.cond.id, set()).add(bar)
    return val_use_regions, val_def_block, vreg_regions


def _schedule_reentrant(wg: WGInfo) -> Set[str]:
    """Barriers reachable from themselves through the schedule graph."""
    out: Set[str] = set()
    for b in wg.regions:
        seen: Set[str] = set()
        stack = list(wg.regions[b].exits)
        while stack:
            n = stack.pop()
            if n == b:
                out.add(b)
                break
            if n in seen:
                continue
            seen.add(n)
            stack.extend(wg.regions[n].exits)
    return out


def build_context_plan(wg: WGInfo, uni: Uniformity,
                       merge_uniform: bool = True) -> ContextPlan:
    fn = wg.fn
    val_uses, val_defs, vreg_regions = _region_touches(wg)
    reentrant = _schedule_reentrant(wg)

    # value dtype lookup
    val_dtype: Dict[int, str] = {}
    val_name: Dict[int, str] = {}
    for blk in fn.blocks.values():
        for ins in blk.instrs:
            if ins.result is not None:
                val_dtype[ins.result.id] = ins.result.dtype
                val_name[ins.result.id] = ins.result.name
    arg_ids = {v.id for v in fn.arg_values.values()}

    slots: List[Slot] = []
    val_slots: Dict[int, Slot] = {}
    vreg_slots: Dict[str, Slot] = {}

    # region -> blocks set for membership checks
    region_blocks = {bar: r.blocks for bar, r in wg.regions.items()}

    for vid, uses in sorted(val_uses.items()):
        if vid in arg_ids or vid not in val_defs:
            continue  # kernel args are ambient; undefined = builder constant
        defb = val_defs[vid]
        crossing = any(defb not in region_blocks[r] for r in uses)
        # values in re-entrant regions whose def might be bypassed are still
        # fine: SSA def-before-use holds within each execution
        if crossing:
            uniform = merge_uniform and uni.value_id_uniform(vid)
            s = Slot("val", vid, val_dtype[vid], uniform,
                     f"v_{val_name.get(vid, vid)}")
            slots.append(s)
            val_slots[vid] = s

    vreg_dtype: Dict[str, str] = {}
    for blk in fn.blocks.values():
        for ins in blk.instrs:
            if ins.op in ("vreg_read", "vreg_write"):
                vreg_dtype[ins.attrs["vreg"]] = ins.attrs["dtype"]

    for vreg, regions in sorted(vreg_regions.items()):
        crossing = len(regions) > 1 or any(r in reentrant for r in regions)
        if crossing:
            uniform = merge_uniform and uni.vreg_uniform(vreg)
            s = Slot("vreg", vreg, vreg_dtype[vreg], uniform, vreg)
            slots.append(s)
            vreg_slots[vreg] = s

    return ContextPlan(slots, val_slots, vreg_slots)
