"""Pass-manager pipeline for the kernel-compiler middle-end (paper Fig. 3).

The paper's central claim is that the kernel compiler is *modular*: the
target-independent parallel region formation runs once, and its product —
parallel regions, the region schedule, and the data-parallelism facts the
later passes exploit (the paper's ``llvm.mem.parallel_loop_access``
metadata, §4) — is consumed unchanged by every target-specific parallel
mapping.  This module makes that architecture explicit:

* :class:`Pass` — a named pipeline stage declaring which structural
  *properties* of the IR it requires and establishes (``single-exit``,
  ``barriers-isolated``, ``phi-free``, ...), with the transformation as a
  function over a :class:`PipelineState`.
* :class:`PassManager` — runs a pass list in order, enforcing the
  requires/establishes contracts, optionally running the structural IR
  verifier between passes (``verify=True`` or ``REPRO_VERIFY_IR=1``),
  recording per-pass wall times, and calling dump hooks after every pass
  (``tools/dump_pipeline.py`` and the golden-IR tests are built on these).
* :func:`verify_ir` — the structural verifier: CFG well-formedness,
  single exit, barrier isolation, phi/vreg consistency.  Violations raise
  :class:`VerifierError` naming the pass that produced the bad IR.
* :class:`WorkGroupPlan` — the pipeline's product: everything about a
  kernel that does not depend on the execution target.  All three targets
  (``loop`` / ``vector`` / ``pallas``) are thin parallel mappings over one
  shared plan; the plan is cached per canonical-IR hash
  (:mod:`repro.core.cache`), so an autotune sweep over the targets runs
  region formation exactly once per kernel (``plan_count()`` proves it;
  ``benchmarks/bench_compile.py`` measures it).

Pass order (identical semantics to the pre-refactor function chain):

  normalize → inject_loop_barriers → out_of_ssa → horizontal →
  tail_duplicate → form_regions → uniformity → fold_constants →
  context_planning → structure_regions → annotate_parallel_md
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from .errors import BuildError, register_error
from .ir import CONSTANT, CondBranch, Function, GLOBAL, Jump, LOCAL, Return
from .regions import (WGInfo, form_regions, inject_loop_barriers, normalize,
                      out_of_ssa, tail_duplicate)
from .context import ContextPlan, build_context_plan, fold_constants
from .uniformity import AllVarying, analyze

# running count of actual pipeline runs (plan-cache misses).  The
# companion to ``api.compile_count()`` one stage earlier: tests and
# benchmarks use the delta to prove the target-independent prefix runs
# once per kernel across a multi-target autotune sweep.
_plans_built = 0
_plans_lock = threading.Lock()


def plan_count() -> int:
    with _plans_lock:
        return _plans_built


@register_error
class VerifierError(BuildError, AssertionError):
    """Structural IR invariant violation, attributed to the pass whose
    output failed verification (``.pass_name``).

    Part of the typed :class:`~repro.core.errors.ReproError` hierarchy as
    a :class:`~repro.core.errors.BuildError`: a pass breaking the IR is a
    program-build failure, and :meth:`repro.core.program.Program.build`
    folds the report into the build log.  (``AssertionError`` is kept as
    a base for pre-hierarchy call sites.)"""

    code = -45
    code_name = "CL_INVALID_PROGRAM_EXECUTABLE"

    def __init__(self, pass_name: str, message: str):
        self.pass_name = pass_name
        text = f"[after pass {pass_name!r}] {message}"
        super().__init__(text, build_log=text)


# ---------------------------------------------------------------------------
# Structural IR verifier
# ---------------------------------------------------------------------------

def verify_ir(fn: Function, properties: Sequence[str] = (),
              pass_name: str = "<unknown>") -> None:
    """Check CFG well-formedness plus every property in ``properties``.

    Base checks (always): entry block exists, every block has a
    terminator, every successor edge targets an existing block, every
    block is reachable from entry, and phi incomings name actual
    predecessors.

    Property checks:
      ``single-exit``        exactly one ``Return`` block
      ``barriers-isolated``  every barrier instr is alone in its block,
                             terminated by an unconditional ``Jump``
      ``phi-free``           no phi nodes remain; every virtual register
                             has one consistent dtype across all
                             reads/writes
    """
    def fail(msg: str) -> None:
        raise VerifierError(pass_name, msg)

    if fn.entry not in fn.blocks:
        fail(f"entry block {fn.entry!r} missing")
    for name, blk in fn.blocks.items():
        if blk.terminator is None:
            fail(f"block {name!r} has no terminator")
        if not isinstance(blk.terminator, (Jump, CondBranch, Return)):
            fail(f"block {name!r} has unknown terminator "
                 f"{type(blk.terminator).__name__}")
        for s in blk.successors():
            if s not in fn.blocks:
                fail(f"block {name!r} branches to missing block {s!r}")
    reachable = set(fn.rpo())
    unreachable = sorted(set(fn.blocks) - reachable)
    if unreachable:
        fail(f"unreachable blocks: {unreachable}")
    preds = fn.predecessors()
    for name, blk in fn.blocks.items():
        for phi in blk.phis:
            for p in phi.incomings:
                if p not in preds[name]:
                    fail(f"phi in {name!r} names non-predecessor {p!r}")

    props = set(properties)
    if "single-exit" in props:
        exits = fn.exit_blocks()
        if len(exits) != 1:
            fail(f"expected a single exit block, found {exits}")
    if "barriers-isolated" in props:
        for name, blk in fn.blocks.items():
            bars = [i for i in blk.instrs if i.op == "barrier"]
            if not bars:
                continue
            if len(blk.instrs) != 1 or blk.phis \
                    or not isinstance(blk.terminator, Jump):
                fail(f"barrier in {name!r} is not isolated "
                     f"(instrs={len(blk.instrs)}, phis={len(blk.phis)}, "
                     f"terminator={type(blk.terminator).__name__})")
    if "phi-free" in props:
        vreg_dtype: Dict[str, str] = {}
        for name, blk in fn.blocks.items():
            if blk.phis:
                fail(f"block {name!r} still has {len(blk.phis)} phi(s)")
            for ins in blk.instrs:
                if ins.op in ("vreg_read", "vreg_write"):
                    nm, dt = ins.attrs["vreg"], ins.attrs["dtype"]
                    if vreg_dtype.setdefault(nm, dt) != dt:
                        fail(f"vreg {nm!r} used at dtype {dt!r} and "
                             f"{vreg_dtype[nm]!r}")


# ---------------------------------------------------------------------------
# Region structuring (target-independent; moved here from targets/vector.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BlockNode:
    name: str


@dataclasses.dataclass
class LoopNode:
    header: str
    body_entry: str
    exit_target: str            # header's out-of-loop successor
    body_items: List[object]
    blocks: Set[str]            # all loop blocks incl. header


def _sccs(nodes: Set[str], succs: Dict[str, List[str]]) -> List[List[str]]:
    """Tarjan SCCs (iterative).  Returned in reverse topological order."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    for root in sorted(nodes):
        if root in index:
            continue
        work = [(root, iter(succs.get(root, [])))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in nodes:
                    continue
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(succs.get(w, []))))
                    advanced = True
                    break
                elif w in on_stack:
                    low[v] = min(low[v], index[w])
            if not advanced:
                work.pop()
                if work:
                    pv = work[-1][0]
                    low[pv] = min(low[pv], low[v])
                if low[v] == index[v]:
                    scc = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        scc.append(w)
                        if w == v:
                            break
                    out.append(scc)
    return out


def structure_region(fn: Function, entry: str,
                     blocks: Set[str]) -> List[object]:
    """Collapse cyclic SCCs of the region sub-CFG to loop supernodes and
    order the resulting DAG topologically (reachable-from-entry only)."""
    succs = {b: [s for s in fn.blocks[b].successors() if s in blocks]
             for b in blocks}
    preds: Dict[str, List[str]] = {b: [] for b in blocks}
    for b, ss in succs.items():
        for s in ss:
            preds[s].append(b)

    sccs = _sccs(blocks, succs)  # reverse topological order
    scc_of: Dict[str, int] = {}
    for i, scc in enumerate(sccs):
        for b in scc:
            scc_of[b] = i

    # reachability from the entry's SCC over the SCC DAG
    reach: Set[int] = set()
    stack = [scc_of[entry]]
    while stack:
        i = stack.pop()
        if i in reach:
            continue
        reach.add(i)
        for b in sccs[i]:
            for s in succs[b]:
                if scc_of[s] != i:
                    stack.append(scc_of[s])

    items: List[object] = []
    for i in reversed(range(len(sccs))):  # topological order
        if i not in reach:
            continue
        scc = sccs[i]
        sset = set(scc)
        cyclic = len(scc) > 1 or any(b in succs[b] for b in scc)
        if not cyclic:
            items.append(BlockNode(scc[0]))
            continue
        # loop supernode: unique header = the block entered from outside
        heads = {b for b in scc
                 if b == entry or any(p not in sset for p in preds[b])}
        assert len(heads) == 1, \
            f"irreducible loop in region (headers {heads})"
        header = heads.pop()
        hdr = fn.blocks[header]
        term = hdr.terminator
        assert isinstance(term, CondBranch), \
            f"loop header {header} must end in a conditional branch"
        inside = [s for s in term.successors() if s in sset]
        outside = [s for s in term.successors() if s not in sset]
        assert len(inside) == 1 and len(outside) == 1, \
            f"loop {header} not in canonical while form"
        body_items = structure_region(fn, inside[0], sset - {header})
        items.append(LoopNode(header, inside[0], outside[0], body_items,
                              sset))
    return items


# ---------------------------------------------------------------------------
# ParallelRegionMD — the §4 parallelism metadata carried on each region
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParallelRegionMD:
    """Per-region data-parallelism facts, the analogue of the
    ``llvm.mem.parallel_loop_access`` metadata pocl attaches to the
    work-item loops it generates (§4): region formation *proves* these
    properties, and the target mappings rely on them instead of
    re-deriving (or conservatively forgetting) them.

    ``wi_parallel``    the region's work-item loop carries no cross-WI
                       dependencies — by construction: barriers bound the
                       region, so every lane may run concurrently.  This
                       is what licenses the vector/pallas lane mapping
                       and the loop target's unordered ``fori_loop``.
    ``uniform_exits``  every branch selecting the region's successor
                       barrier is provably work-group-uniform — what
                       licenses reading the next region id from a single
                       peeled work-item (§4.4).  OpenCL requires this of
                       well-formed kernels; ``False`` means the analysis
                       could not prove it (the peeled-WI schedule is
                       still used, per the OpenCL contract).
    ``lockstep``       region boundary produced by a b-loop implicit
                       barrier (§4.5) or the horizontal pass (§4.6): all
                       work-items iterate the enclosing loop together.
    """

    barrier: str                # barrier block this region starts after
    rid: int                    # region id in the schedule order
    wi_parallel: bool
    uniform_exits: bool
    lockstep: bool
    n_blocks: int

    def describe(self) -> str:
        tags = [t for t, on in (("wi-parallel", self.wi_parallel),
                                ("uniform-exits", self.uniform_exits),
                                ("lockstep", self.lockstep)) if on]
        return (f"region[{self.rid}] @{self.barrier}: "
                f"{self.n_blocks} block(s), {', '.join(tags) or '-'}")


def _region_md(fn: Function, wg: WGInfo, uni) -> Dict[str, ParallelRegionMD]:
    md: Dict[str, ParallelRegionMD] = {}
    rid_of = {b: i for i, b in enumerate(wg.order)}
    for bar in wg.order:
        region = wg.regions[bar]
        uniform = True
        for bname in region.blocks:
            term = fn.blocks[bname].terminator
            if not isinstance(term, CondBranch):
                continue
            # a branch with a region-exit (barrier) successor decides the
            # schedule; it must be WG-uniform for the peeled-WI rule
            if any(s not in region.blocks for s in term.successors()):
                if not uni.value_uniform(term.cond):
                    uniform = False
        bar_instr = next(i for i in fn.blocks[bar].instrs
                         if i.op == "barrier")
        implicit = str(bar_instr.attrs.get("implicit", ""))
        m = ParallelRegionMD(
            barrier=bar, rid=rid_of[bar], wi_parallel=True,
            uniform_exits=uniform,
            lockstep=implicit.startswith("bloop"),
            n_blocks=len(region.blocks))
        md[bar] = m
        region.attrs["md"] = m
    return md


# ---------------------------------------------------------------------------
# Fusibility facts — what the DAG-level fusion optimizer needs per kernel
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BufferFootprint:
    """Static access footprint of one buffer parameter: how many loads
    and stores the kernel body performs on it, and whether every access
    index is the work-item's own ``global_id(0)`` — the property that
    makes per-lane value forwarding between a producer's store and a
    consumer's load legal (:mod:`repro.core.fusion`)."""

    name: str
    space: str
    loads: int
    stores: int
    gid_only: bool


@dataclass(frozen=True)
class KernelFusibility:
    """Per-kernel fusion facts exported by the middle-end.

    ``elementwise`` is the DAG optimizer's admission test: a 1-D,
    loop-free, user-barrier-free kernel with no LOCAL arrays whose every
    global-buffer access indexes at ``global_id(0)`` — i.e. a pure map
    over the NDRange where work-item *i* touches exactly element *i* of
    every buffer.  ``reasons`` names the first facts that broke the
    classification (for ``dag_stats``/debugging); ``footprints`` carries
    the per-parameter access counts the buffer-elision decision reads."""

    elementwise: bool
    reasons: Tuple[str, ...]
    footprints: Tuple[BufferFootprint, ...]

    def footprint(self, name: str) -> Optional[BufferFootprint]:
        for f in self.footprints:
            if f.name == name:
                return f
        return None


def kernel_fusibility(fn: Function) -> KernelFusibility:
    """Compute :class:`KernelFusibility` for ``fn``.

    Works on both the raw builder IR and the post-pipeline CFG: the
    facts it reads (``global_id`` instrs, load/store buffer attrs, user
    barriers, natural loops) survive every pass unchanged."""
    reasons: List[str] = []
    if fn.ndim != 1:
        reasons.append(f"ndim={fn.ndim}")
    if any(a.space == LOCAL for a in fn.buffer_args):
        reasons.append("local-array")
    if fn.natural_loops():
        reasons.append("loop")
    # SSA ids of values that *are* the work-item's global_id(0)
    gid_ids: Set[int] = set()
    for blk in fn.blocks.values():
        for ins in blk.instrs:
            if ins.op == "global_id" and int(ins.attrs.get("dim", 0)) == 0 \
                    and ins.result is not None:
                gid_ids.add(ins.result.id)
            elif ins.op == "barrier" and not ins.attrs.get("implicit"):
                if "user-barrier" not in reasons:
                    reasons.append("user-barrier")
    loads: Dict[str, int] = {}
    stores: Dict[str, int] = {}
    gid_ok: Dict[str, bool] = {}
    for blk in fn.blocks.values():
        for ins in blk.instrs:
            if ins.op not in ("load", "store"):
                continue
            buf = str(ins.attrs.get("buffer"))
            idx = ins.operands[0]
            at_gid = getattr(idx, "id", None) in gid_ids
            gid_ok[buf] = gid_ok.get(buf, True) and at_gid
            if ins.op == "load":
                loads[buf] = loads.get(buf, 0) + 1
            else:
                stores[buf] = stores.get(buf, 0) + 1
    fps = tuple(BufferFootprint(
        name=a.name, space=a.space,
        loads=loads.get(a.name, 0), stores=stores.get(a.name, 0),
        gid_only=gid_ok.get(a.name, True)) for a in fn.buffer_args)
    for f in fps:
        if f.space in (GLOBAL, CONSTANT) and not f.gid_only:
            reasons.append(f"non-gid-access:{f.name}")
    return KernelFusibility(elementwise=not reasons,
                            reasons=tuple(reasons), footprints=fps)


# ---------------------------------------------------------------------------
# WorkGroupPlan — the shared target-independent product
# ---------------------------------------------------------------------------

@dataclass
class WorkGroupPlan:
    """Everything the middle-end knows about a kernel that is independent
    of the execution target (and of the local size — lane counts are bound
    at target-construction time).  One plan is computed per canonical
    kernel IR + plan options and shared by all target mappings; it is the
    unit of stage-level caching (:class:`repro.core.cache.PlanKey`)."""

    fn: Function                            # transformed (phi-free) CFG
    wg: WGInfo                              # regions + schedule (§4.3)
    uni: object                             # Uniformity | AllVarying (§4.6)
    ctx: ContextPlan                        # context slots (§4.7)
    region_plans: Dict[str, List[object]]   # structured region exec plans
    md: Dict[str, ParallelRegionMD]         # §4 parallelism metadata
    options: Tuple[Tuple[str, object], ...]  # (horizontal, merge_uniform)
    pass_times: Dict[str, float] = field(default_factory=dict)
    fusibility: Optional[KernelFusibility] = None   # DAG-fusion facts

    @property
    def order(self) -> List[str]:
        return self.wg.order

    def rid_of(self) -> Dict[str, int]:
        return {b: i for i, b in enumerate(self.wg.order)}

    def describe(self) -> str:
        # slot names for SSA values embed the process-global value counter;
        # rename to the same first-reference indices canonical_ir prints
        # with, so descriptions are stable and match the IR dumps
        from .cache import canonical_value_names
        canon = canonical_value_names(self.fn)
        slots = []
        for s in self.ctx.slots:
            name = canon.get(s.key, s.name) if s.kind == "val" else s.name
            slots.append((name, s.dtype,
                          "uniform" if s.uniform else "per-wi"))
        lines = [f"plan for {self.fn.name!r} "
                 f"({dict(self.options)}):",
                 f"  schedule: {self.wg.order} "
                 f"chain={self.wg.is_chain()}"]
        for bar in self.wg.order:
            lines.append("  " + self.md[bar].describe())
        lines.append(f"  context slots: {slots}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Pass + PassManager
# ---------------------------------------------------------------------------

@dataclass
class PipelineState:
    """Mutable state threaded through the passes: the CFG plus the
    analysis artifacts later passes consume."""

    fn: Function
    options: Dict[str, object]
    props: Set[str] = field(default_factory=set)
    wg: Optional[WGInfo] = None
    uni: Optional[object] = None
    ctx: Optional[ContextPlan] = None
    region_plans: Optional[Dict[str, List[object]]] = None
    md: Optional[Dict[str, ParallelRegionMD]] = None
    fusibility: Optional[KernelFusibility] = None


@dataclass(frozen=True)
class Pass:
    """A named pipeline stage.

    ``requires``     properties that must hold on entry (established by
                     earlier passes) — enforced by the manager.
    ``establishes``  properties guaranteed on exit; the verifier checks
                     the structural ones after every subsequent pass.
    ``invalidates``  properties this pass may break (the manager drops
                     them before running it).
    ``mutates_cfg``  whether the pass rewrites ``state.fn`` (dump hooks
                     re-print the IR only for these).
    """

    name: str
    run: Callable[[PipelineState], None]
    requires: Tuple[str, ...] = ()
    establishes: Tuple[str, ...] = ()
    invalidates: Tuple[str, ...] = ()
    mutates_cfg: bool = True
    paper: str = ""


def _p_normalize(st: PipelineState) -> None:
    normalize(st.fn)


def _p_inject_loop_barriers(st: PipelineState) -> None:
    inject_loop_barriers(st.fn)


def _p_out_of_ssa(st: PipelineState) -> None:
    out_of_ssa(st.fn)


def _p_horizontal(st: PipelineState) -> None:
    if not st.options.get("horizontal", True):
        return
    from .horizontal import horizontal_candidates  # cycle-free import
    cands = horizontal_candidates(st.fn)
    if cands:
        inject_loop_barriers(st.fn, extra_loop_headers=cands)


def _p_tail_duplicate(st: PipelineState) -> None:
    tail_duplicate(st.fn)


def _p_form_regions(st: PipelineState) -> None:
    st.wg = form_regions(st.fn)


def _p_uniformity(st: PipelineState) -> None:
    # the paper's no-uniformity baseline treats everything as varying;
    # options mirror the pre-refactor behaviour where horizontal=False
    # also disabled the analysis
    if st.options.get("horizontal", True):
        st.uni = analyze(st.fn)
    else:
        st.uni = AllVarying()


def _p_fold_constants(st: PipelineState) -> None:
    fold_constants(st.fn)


def _p_context_planning(st: PipelineState) -> None:
    st.ctx = build_context_plan(
        st.wg, st.uni,
        merge_uniform=bool(st.options.get("merge_uniform", True)))


def _p_structure_regions(st: PipelineState) -> None:
    st.region_plans = {
        bar: structure_region(st.fn, r.entry, r.blocks)
        for bar, r in st.wg.regions.items() if r.entry is not None}


def _p_annotate_md(st: PipelineState) -> None:
    st.md = _region_md(st.fn, st.wg, st.uni)


def _p_annotate_fusibility(st: PipelineState) -> None:
    st.fusibility = kernel_fusibility(st.fn)


DEFAULT_PASSES: Tuple[Pass, ...] = (
    Pass("normalize", _p_normalize,
         establishes=("single-exit", "barriers-isolated"),
         paper="§4.3 Alg. 1 step 1"),
    Pass("inject_loop_barriers", _p_inject_loop_barriers,
         requires=("single-exit", "barriers-isolated"),
         paper="§4.5"),
    Pass("out_of_ssa", _p_out_of_ssa,
         requires=("barriers-isolated",),
         establishes=("phi-free",),
         paper="§4.7 prep"),
    Pass("horizontal", _p_horizontal,
         requires=("phi-free",),
         paper="§4.6"),
    # duplicating a tail that reaches the exit duplicates the Return —
    # single-exit legitimately dies here (regions handle multiple exits)
    Pass("tail_duplicate", _p_tail_duplicate,
         requires=("phi-free", "barriers-isolated"),
         establishes=("barrier-tails-unique",),
         invalidates=("single-exit",),
         paper="§4.3 Alg. 2"),
    # analysis products ("regions-formed", "uniformity-known",
    # "context-planned") are modelled as properties too, so a misordered
    # custom pipeline fails the requires check with a VerifierError naming
    # the pass, not an unattributed AttributeError on a missing artifact
    Pass("form_regions", _p_form_regions,
         requires=("barrier-tails-unique",),
         establishes=("regions-formed",),
         mutates_cfg=False, paper="§4.3 Def. 1"),
    Pass("uniformity", _p_uniformity,
         requires=("phi-free",),
         establishes=("uniformity-known",),
         mutates_cfg=False, paper="§4.6"),
    Pass("fold_constants", _p_fold_constants,
         requires=("phi-free",),
         paper="§4.7 (constant rematerialization)"),
    Pass("context_planning", _p_context_planning,
         requires=("phi-free", "regions-formed", "uniformity-known"),
         establishes=("context-planned",),
         mutates_cfg=False, paper="§4.7"),
    Pass("structure_regions", _p_structure_regions,
         requires=("regions-formed",),
         mutates_cfg=False, paper="§4.4 (region scheduling prep)"),
    Pass("annotate_parallel_md", _p_annotate_md,
         requires=("regions-formed", "uniformity-known"),
         mutates_cfg=False,
         paper="§4 (llvm.mem.parallel_loop_access analogue)"),
    Pass("annotate_fusibility", _p_annotate_fusibility,
         requires=("regions-formed",),
         mutates_cfg=False,
         paper="§4 (parallelism facts consumed by later generic passes)"),
)


def _env_verify() -> bool:
    return os.environ.get("REPRO_VERIFY_IR", "") not in ("", "0", "false")


class PassManager:
    """Runs a pass pipeline over a kernel CFG and assembles the
    :class:`WorkGroupPlan`.

    ``verify``   run :func:`verify_ir` after every pass, checking all
                 properties established so far (default: the
                 ``REPRO_VERIFY_IR`` environment variable).
    ``on_pass``  hook called as ``on_pass(pass_obj, state)`` after each
                 pass — the dump/golden-test surface.
    ``timings``  per-pass wall-clock seconds of the last ``run``.
    """

    def __init__(self, passes: Sequence[Pass] = DEFAULT_PASSES,
                 verify: Optional[bool] = None,
                 on_pass: Optional[Callable[[Pass, PipelineState],
                                            None]] = None):
        self.passes: Tuple[Pass, ...] = tuple(passes)
        self.verify = _env_verify() if verify is None else bool(verify)
        self.on_pass = on_pass
        self.timings: Dict[str, float] = {}

    def pass_names(self) -> List[str]:
        return [p.name for p in self.passes]

    def run(self, fn: Function, horizontal: bool = True,
            merge_uniform: bool = True) -> WorkGroupPlan:
        global _plans_built
        with _plans_lock:
            _plans_built += 1
        st = PipelineState(fn, {"horizontal": bool(horizontal),
                                "merge_uniform": bool(merge_uniform)})
        self.timings = {}
        for p in self.passes:
            missing = [r for r in p.requires if r not in st.props]
            if missing:
                raise VerifierError(
                    p.name, f"pass requires {missing} but only "
                            f"{sorted(st.props)} are established")
            for prop in p.invalidates:
                st.props.discard(prop)
            t0 = time.perf_counter()
            p.run(st)
            self.timings[p.name] = time.perf_counter() - t0
            st.props.update(p.establishes)
            if self.verify:
                verify_ir(st.fn, sorted(st.props), pass_name=p.name)
            if self.on_pass is not None:
                self.on_pass(p, st)
        assert st.wg is not None and st.uni is not None \
            and st.ctx is not None and st.region_plans is not None \
            and st.md is not None, "pipeline did not produce a full plan"
        return WorkGroupPlan(
            fn=st.fn, wg=st.wg, uni=st.uni, ctx=st.ctx,
            region_plans=st.region_plans, md=st.md,
            options=(("horizontal", bool(horizontal)),
                     ("merge_uniform", bool(merge_uniform))),
            pass_times=dict(self.timings),
            fusibility=st.fusibility)


def build_plan(fn: Function, horizontal: bool = True,
               merge_uniform: bool = True,
               verify: Optional[bool] = None,
               on_pass: Optional[Callable] = None) -> WorkGroupPlan:
    """Run the default pipeline on ``fn`` (mutating it) and return the
    shared target-independent :class:`WorkGroupPlan`."""
    pm = PassManager(verify=verify, on_pass=on_pass)
    return pm.run(fn, horizontal=horizontal, merge_uniform=merge_uniform)
