"""Parallel region formation (paper §4.3–§4.5).

Pipeline (mirrors pocl's work-group function generation):

1. ``normalize``        — single exit; implicit entry/exit barriers
                          (Algorithm 1, step 1); each barrier in its own block.
2. ``inject_loop_barriers`` — §4.5 implicit barriers for loops containing
                          barriers (b-loops): end of pre-header, before the
                          latch branch, after the header phi region.
3. ``out_of_ssa``       — phis become virtual registers (``vreg_read`` /
                          ``vreg_write``).  This is the IR realization of the
                          paper's *context data arrays* (§4.7): a vreg that
                          lives across parallel regions becomes a per-WI
                          context slot downstream.
4. ``tail_duplicate``   — Algorithm 2: replicate the tail sub-CFG of every
                          loop-free conditional barrier until every non-loop
                          barrier has a single immediate predecessor barrier
                          in the Barrier CFG (Definition 1 / Proposition 1).
5. ``form_regions``     — emit ``Region`` objects (single-entry sub-CFGs
                          between barriers) plus the region schedule graph.

Deviation noted in DESIGN.md: conditional barriers *inside* natural loops are
exempt from tail duplication; the run-time region scheduler (a uniform
switch, the analogue of the paper's peeled first work-item, §4.4/Fig. 7)
dispatches them dynamically.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from . import ir
from .ir import (
    Function, Instr, create_subgraph, ensure_single_exit, replicate_cfg, split_at_barriers)

ENTRY_BARRIER = "__entry_barrier__"


# ---------------------------------------------------------------------------
# Step 1: normalization (Algorithm 1, step 1)
# ---------------------------------------------------------------------------

def normalize(fn: Function) -> None:
    fn.prune_unreachable()
    exit_name = ensure_single_exit(fn)
    # implicit barrier at the entry node
    entry_blk = fn.blocks[fn.entry]
    entry_blk.instrs.insert(0, Instr("barrier", [], None,
                                     {"implicit": "entry"}))
    # implicit barrier at the exit node
    exit_blk = fn.blocks[exit_name]
    exit_blk.instrs.append(Instr("barrier", [], None, {"implicit": "exit"}))
    split_at_barriers(fn)
    fn.verify()


def barrier_blocks(fn: Function) -> List[str]:
    return [n for n, b in fn.blocks.items() if b.has_barrier()]


# ---------------------------------------------------------------------------
# Step 2: b-loop implicit barriers (§4.5)
# ---------------------------------------------------------------------------

def inject_loop_barriers(fn: Function, extra_loop_headers: Optional[Set[str]] = None) -> int:
    """Add the three §4.5 implicit barriers around every loop that contains a
    barrier.  ``extra_loop_headers`` lets the horizontal-parallelization pass
    (§4.6) force barrier treatment onto barrier-free loops.  Returns the
    number of loops processed.  Iterates until a fixpoint (outer loops whose
    bodies gained barriers become b-loops themselves)."""
    extra = set(extra_loop_headers or ())
    total = 0
    for _ in range(64):  # fixpoint cap; loop nests are shallow
        processed = _inject_once(fn, extra)
        extra = set()
        total += processed
        if processed == 0:
            break
    return total


def _inject_once(fn: Function, extra_headers: Set[str]) -> int:
    done: Set[str] = getattr(fn, "_bloop_done", set())
    fn._bloop_done = done  # type: ignore[attr-defined]
    loops = fn.natural_loops()
    preds = fn.predecessors()
    count = 0
    for header, body in loops:
        has_bar = any(fn.blocks[b].has_barrier() for b in body)
        if not (has_bar or header in extra_headers):
            continue
        if header in done:
            continue  # already processed
        done.add(header)
        hdr = fn.blocks[header]
        count += 1
        latches = [p for p in preds[header] if p in body]
        pre = [p for p in preds[header] if p not in body]
        assert pre, f"loop {header} has no pre-header"
        # 1. end of the loop pre-header block(s)
        for p in pre:
            blk = fn.blocks[p]
            if not (blk.instrs and blk.instrs[-1].op == "barrier"):
                blk.instrs.append(Instr("barrier", [], None,
                                        {"implicit": "bloop-pre"}))
        # 2. before the loop latch branch
        for l in latches:
            blk = fn.blocks[l]
            if not (blk.instrs and blk.instrs[-1].op == "barrier"):
                blk.instrs.append(Instr("barrier", [], None,
                                        {"implicit": "bloop-latch"}))
        # 3. after the phi-node region of the loop header (post out-of-SSA the
        # "phi region" is the leading run of vreg_read instructions)
        pos = 0
        while pos < len(hdr.instrs) and hdr.instrs[pos].op == "vreg_read":
            pos += 1
        hdr.instrs.insert(pos, Instr("barrier", [], None,
                                     {"implicit": "bloop-header"}))
    if count:
        split_at_barriers(fn)
        fn.verify()
    return count


# ---------------------------------------------------------------------------
# Step 3: out-of-SSA — phis to virtual registers
# ---------------------------------------------------------------------------

def out_of_ssa(fn: Function) -> None:
    preds = fn.predecessors()
    for name in list(fn.blocks.keys()):
        blk = fn.blocks[name]
        if not blk.phis:
            continue
        reads: List[Instr] = []
        for phi in blk.phis:
            vreg = f"r.{phi.result.name}"
            # parallel-copy writes at the end of each predecessor block
            for pred, val in phi.incomings.items():
                pblk = fn.blocks[pred]
                pblk.instrs.append(
                    Instr("vreg_write", [val], None,
                          {"vreg": vreg, "dtype": phi.result.dtype}))
            reads.append(Instr("vreg_read", [], phi.result,
                               {"vreg": vreg, "dtype": phi.result.dtype}))
        blk.phis = []
        blk.instrs[0:0] = reads
    # phi-incoming writes may have landed after a barrier in a barrier block;
    # re-split so barriers stay alone in their blocks.
    split_at_barriers(fn)
    fn.verify()


# ---------------------------------------------------------------------------
# Barrier CFG (Definition 1) and classification
# ---------------------------------------------------------------------------

def build_barrier_cfg(fn: Function) -> Dict[str, List[str]]:
    """Edges between barrier blocks when a no-barrier path connects them.
    Terminal barriers (implicit exit barriers) have no successors."""
    bcfg: Dict[str, List[str]] = {}
    for b in barrier_blocks(fn):
        succs: List[str] = []
        seen: Set[str] = set()
        stack = list(fn.blocks[b].successors())
        while stack:
            n = stack.pop()
            if n in seen:
                continue
            seen.add(n)
            if fn.blocks[n].has_barrier():
                if n not in succs:
                    succs.append(n)
                continue
            stack.extend(fn.blocks[n].successors())
        bcfg[b] = sorted(succs)
    return bcfg


def entry_barrier(fn: Function) -> str:
    """The implicit entry barrier block (first barrier from function entry)."""
    n = fn.entry
    while not fn.blocks[n].has_barrier():
        succ = fn.blocks[n].successors()
        assert len(succ) == 1, "pre-barrier entry code must be straight-line"
        n = succ[0]
    return n


def immediate_pred_barriers(fn: Function) -> Dict[str, List[str]]:
    bcfg = build_barrier_cfg(fn)
    preds: Dict[str, List[str]] = {b: [] for b in bcfg}
    for b, succs in bcfg.items():
        for s in succs:
            preds[s].append(b)
    return preds


def conditional_barriers(fn: Function) -> Set[str]:
    """Barriers that do not dominate every exit block (paper §4.3)."""
    dom = fn.dominators()
    exits = fn.exit_blocks()
    out: Set[str] = set()
    for b in barrier_blocks(fn):
        if not all(b in dom.get(e, set()) for e in exits):
            out.add(b)
    return out


def _loop_blocks(fn: Function) -> Set[str]:
    s: Set[str] = set()
    for _, body in fn.natural_loops():
        s |= body
    return s


# ---------------------------------------------------------------------------
# Step 4: tail duplication (Algorithm 2)
# ---------------------------------------------------------------------------

def tail_duplicate(fn: Function, max_iters: int = 256) -> int:
    """Replicate the tail of each loop-free conditional barrier until every
    loop-free barrier has at most one immediate predecessor barrier.  Returns
    the number of replications performed."""
    n_dup = 0
    suffix = 0
    for _ in range(max_iters):
        in_loop = _loop_blocks(fn)
        preds = immediate_pred_barriers(fn)
        cond = conditional_barriers(fn)
        # find a barrier with >=2 immediate predecessor barriers whose
        # ambiguity comes from a loop-free conditional barrier predecessor
        target: Optional[str] = None
        for b in fn.rpo():
            if b not in preds or len(preds[b]) < 2 or b in in_loop:
                continue
            culprits = [p for p in preds[b] if p in cond and p not in in_loop]
            if culprits:
                target = culprits[0]
                break
        if target is None:
            return n_dup
        # tail = everything reachable from the conditional barrier (CreateSubgraph
        # from the barrier to the exit nodes), excluding the barrier itself
        tail = create_subgraph(fn, target, set())
        if not tail:
            return n_dup
        suffix += 1
        mapping = replicate_cfg(fn, tail, f"t{suffix}")
        # redirect the conditional barrier's out-edges into the fresh copy
        term = fn.blocks[target].terminator
        fn.blocks[target].terminator = term.replace(mapping)
        fn.prune_unreachable()
        # stale phi incomings (none expected post out-of-ssa) and verify
        ir.remap_phi_preds(fn)
        fn.verify()
        n_dup += 1
    raise RuntimeError("tail duplication did not converge")


# ---------------------------------------------------------------------------
# Step 5: region formation
# ---------------------------------------------------------------------------

@dataclass
class Region:
    """A parallel region: single-entry sub-CFG between barriers (§4.3).

    ``barrier``  — the barrier block this region starts *after*;
    ``entry``    — first block of the region (successor of the barrier);
    ``blocks``   — region block set (no barrier blocks);
    ``exits``    — successor barrier blocks, in deterministic order.
    A terminal region has no exits (runs to Return).
    """

    barrier: str
    entry: Optional[str]
    blocks: Set[str]
    exits: List[str]
    attrs: Dict[str, object] = field(default_factory=dict)


@dataclass
class WGInfo:
    """The work-group function plan: regions + schedule over barrier ids."""

    fn: Function
    regions: Dict[str, Region]          # keyed by barrier block name
    order: List[str]                    # barrier blocks, entry first (RPO)
    entry: str                          # entry barrier block

    def is_chain(self) -> bool:
        """True if the schedule is a straight line (no cycles/branches)."""
        seen = set()
        cur = self.entry
        while True:
            if cur in seen:
                return False
            seen.add(cur)
            ex = self.regions[cur].exits
            if len(ex) == 0:
                return len(seen) == len(self.regions)
            if len(ex) != 1:
                return False
            cur = ex[0]

    def chain(self) -> List[str]:
        out = [self.entry]
        while self.regions[out[-1]].exits:
            out.append(self.regions[out[-1]].exits[0])
        return out


def form_regions(fn: Function) -> WGInfo:
    regions: Dict[str, Region] = {}
    bars = barrier_blocks(fn)
    for b in bars:
        succ = fn.blocks[b].successors()
        assert len(succ) <= 1, "barrier blocks are straight-line"
        if not succ:  # barrier immediately followed by nothing (shouldn't happen)
            regions[b] = Region(b, None, set(), [])
            continue
        entry = succ[0]
        blocks: Set[str] = set()
        exits: List[str] = []
        stack = [entry]
        while stack:
            n = stack.pop()
            if fn.blocks[n].has_barrier():
                if n not in exits:
                    exits.append(n)
                continue
            if n in blocks:
                continue
            blocks.add(n)
            stack.extend(fn.blocks[n].successors())
        regions[b] = Region(b, entry, blocks, sorted(exits))
    # barrier order: RPO restricted to barrier blocks
    order = [n for n in fn.rpo() if n in regions]
    ent = entry_barrier(fn)
    order.remove(ent)
    order.insert(0, ent)
    return WGInfo(fn, regions, order, ent)


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------

def lower_to_regions(fn: Function,
                     horizontal: bool = True) -> WGInfo:
    """Compatibility wrapper: run the full pass-manager pipeline
    (:mod:`repro.core.passes`) and return the region product only.

    Note two differences from the pre-pass-manager version: ``fn`` is
    mutated slightly further (``fold_constants`` deletes ``const``
    instructions and inlines their literals), and the full plan —
    uniformity facts, context slots, structured region plans, metadata —
    is computed and discarded.  Callers that want the plan (every target
    does) should use :func:`repro.core.passes.build_plan` instead."""
    from .passes import build_plan  # cycle-free import

    return build_plan(fn, horizontal=horizontal).wg
