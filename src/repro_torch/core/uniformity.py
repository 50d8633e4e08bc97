"""Uniformity / divergence analysis (paper §4.6, §4.7).

A value is *uniform* when it is known to hold the same value for every
work-item in the work-group; the analysis "resolves the origin of the
variables ... until a known uniform root is found" (§4.6).  Uniform roots:
constants, kernel (scalar) arguments, ``group_id``/``local_size``/
``num_groups``/``global_size``.  Varying roots: ``local_id``/``global_id``
and (conservatively) non-constant memory loads.

Divergence propagates through *control dependence*: a value computed in a
block whose execution is controlled by a varying branch is varying even if
its operands are uniform.  We compute control dependence from the
post-dominator tree (Ferrante et al.), which is the precision the paper needs
to prove §4.6 loop-entry predicates WI-invariant.

Runs on the phi-free (post out-of-SSA) CFG: virtual registers are uniform
iff every write is uniform and every writing block has a uniform predicate.
"""

from __future__ import annotations

from typing import Dict, List, Set

from . import ir
from .ir import CondBranch, Function, Value

UNIFORM_ID_OPS = {"group_id", "local_size", "num_groups", "global_size"}
VARYING_ID_OPS = {"local_id", "global_id"}


def postdominators(fn: Function) -> Dict[str, Set[str]]:
    """Post-dominator sets over the reversed CFG with a virtual exit."""
    exits = fn.exit_blocks()
    names = fn.rpo()
    succs = {n: fn.blocks[n].successors() for n in names}
    VEXIT = "__vexit__"
    rsuccs: Dict[str, List[str]] = {n: [] for n in names}
    rsuccs[VEXIT] = list(exits)
    preds_rev: Dict[str, List[str]] = {n: [] for n in names + [VEXIT]}
    for n in names:
        for s in succs[n]:
            preds_rev[n].append(s)  # reversed edge s -> n means pred_rev[n]+=[s]
    for e in exits:
        preds_rev[e].append(VEXIT)
    allb = set(names) | {VEXIT}
    pdom: Dict[str, Set[str]] = {n: set(allb) for n in allb}
    pdom[VEXIT] = {VEXIT}
    changed = True
    while changed:
        changed = False
        for n in names:  # any order; iterate to fixpoint
            ps = preds_rev[n]
            new = set(allb)
            for p in ps:
                new &= pdom[p]
            if not ps:
                new = set()
            new |= {n}
            if new != pdom[n]:
                pdom[n] = new
                changed = True
    return pdom


def control_deps(fn: Function) -> Dict[str, Set[str]]:
    """block -> set of CondBranch blocks it is control-dependent on."""
    pdom = postdominators(fn)
    cd: Dict[str, Set[str]] = {n: set() for n in fn.blocks}
    for c, blk in fn.blocks.items():
        if not isinstance(blk.terminator, CondBranch):
            continue
        for s in blk.terminator.successors():
            # blocks post-dominating s but not post-dominating c are CD on c
            for b in fn.blocks:
                if b == c:
                    continue
                if b in pdom.get(s, set()) and b not in pdom.get(c, set()):
                    cd[b].add(c)
    return cd


class AllVarying:
    """Degraded uniformity used when the §4.6 analysis is disabled: every
    value is treated as work-item-variant (the paper's no-pass baseline).
    Drop-in for :class:`Uniformity` in the context planner and targets."""

    def value_uniform(self, v) -> bool:
        return False

    def value_id_uniform(self, vid) -> bool:
        return False

    def vreg_uniform(self, name) -> bool:
        return False

    def block_uniform(self, name) -> bool:
        return False


class Uniformity:
    def __init__(self, varying_values: Set[int], varying_vregs: Set[str],
                 varying_blocks: Set[str]):
        self._vals = varying_values
        self._vregs = varying_vregs
        self._blocks = varying_blocks

    def value_uniform(self, v) -> bool:
        if not isinstance(v, Value):
            return True  # constants
        return v.id not in self._vals

    def value_id_uniform(self, vid: int) -> bool:
        return vid not in self._vals

    def vreg_uniform(self, name: str) -> bool:
        return name not in self._vregs

    def block_uniform(self, name: str) -> bool:
        return name not in self._blocks


def analyze(fn: Function) -> Uniformity:
    cd = control_deps(fn)
    cond_of: Dict[str, Value] = {}
    for n, blk in fn.blocks.items():
        if isinstance(blk.terminator, CondBranch):
            c = blk.terminator.cond
            if isinstance(c, Value):
                cond_of[n] = c

    varying_vals: Set[int] = set()
    varying_vregs: Set[str] = set()
    varying_blocks: Set[str] = set()

    def block_varying(n: str) -> bool:
        for c in cd.get(n, ()):
            cv = cond_of.get(c)
            if cv is not None and cv.id in varying_vals:
                return True
        return False

    changed = True
    while changed:
        changed = False
        for n in fn.rpo():
            blk = fn.blocks[n]
            bv = block_varying(n)
            if bv and n not in varying_blocks:
                varying_blocks.add(n)
                changed = True
            for insn in blk.instrs:
                var = False
                if insn.op in VARYING_ID_OPS:
                    var = True
                elif insn.op == "load":
                    # uniform only for constant-space loads at uniform index
                    idx = insn.operands[0]
                    uni_idx = not (isinstance(idx, Value)
                                   and idx.id in varying_vals)
                    var = not (insn.attrs.get("space") == ir.CONSTANT
                               and uni_idx)
                elif insn.op == "vreg_read":
                    var = insn.attrs["vreg"] in varying_vregs
                else:
                    var = any(isinstance(o, Value) and o.id in varying_vals
                              for o in insn.operands)
                # control dependence taints everything computed here
                var = var or bv
                if insn.op == "vreg_write":
                    if var and insn.attrs["vreg"] not in varying_vregs:
                        varying_vregs.add(insn.attrs["vreg"])
                        changed = True
                elif insn.result is not None:
                    if var and insn.result.id not in varying_vals:
                        varying_vals.add(insn.result.id)
                        changed = True
    return Uniformity(varying_vals, varying_vregs, varying_blocks)
