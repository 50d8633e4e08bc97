"""SSA-flavoured CFG IR for SPMD kernels (the pocl kernel-compiler IR).

The paper (pocl, §4.2) represents kernels as SSA control-flow graphs of LLVM
IR.  We rebuild the same abstraction natively: a ``Function`` is a graph of
``BasicBlock``s holding typed ``Instr``s and a single ``Terminator`` each.
The properties the paper relies on hold here too:

* instructions have at most one result,
* a basic block is a branchless instruction sequence,
* edges are defined by the terminator of the *source* block (so replicating a
  block replicates its out-edges, exactly as Section 4.2 requires),
* multiple exit blocks are allowed.

Helper functions ``create_subgraph`` (CreateSubgraph in the paper) and
``replicate_cfg`` (ReplicateCFG) are provided for the tail-duplication pass.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

# --------------------------------------------------------------------------
# Address spaces (OpenCL memory model, §2)
# --------------------------------------------------------------------------
GLOBAL = "global"
LOCAL = "local"
PRIVATE = "private"
CONSTANT = "constant"

ADDRESS_SPACES = (GLOBAL, LOCAL, PRIVATE, CONSTANT)

# --------------------------------------------------------------------------
# Opcodes
# --------------------------------------------------------------------------
BINOPS = {
    "add", "sub", "mul", "div", "rem", "min", "max", "pow",
    "and", "or", "xor", "shl", "shr",
}
CMPOPS = {"lt", "le", "gt", "ge", "eq", "ne"}
UNOPS = {
    "neg", "not", "abs", "exp", "log", "sin", "cos", "tanh", "erf",
    "sqrt", "rsqrt", "floor", "ceil", "rint",
}
# builtins returning work-item identity (OpenCL §2): dim attr in attrs["dim"]
ID_OPS = {"local_id", "global_id", "group_id", "local_size", "num_groups",
          "global_size"}

_value_counter = itertools.count()


@dataclass(eq=False)
class Value:
    """An SSA value. ``dtype`` is a numpy dtype string ('float32', ...)."""

    dtype: str
    name: str = ""

    def __post_init__(self) -> None:
        self.id = next(_value_counter)
        if not self.name:
            self.name = f"v{self.id}"

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"%{self.name}:{self.dtype}"


@dataclass(eq=False)
class Instr:
    """op(operands) -> result.  Operands are Values or python constants."""

    op: str
    operands: List[object]
    result: Optional[Value] = None
    attrs: Dict[str, object] = field(default_factory=dict)

    def value_operands(self) -> List[Value]:
        return [o for o in self.operands if isinstance(o, Value)]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        res = f"{self.result!r} = " if self.result is not None else ""
        return f"{res}{self.op} {self.operands} {self.attrs or ''}"


# Terminators ---------------------------------------------------------------


@dataclass(eq=False)
class Jump:
    target: str

    def successors(self) -> List[str]:
        return [self.target]

    def replace(self, mapping: Dict[str, str]) -> "Jump":
        return Jump(mapping.get(self.target, self.target))


@dataclass(eq=False)
class CondBranch:
    cond: Value
    if_true: str
    if_false: str

    def successors(self) -> List[str]:
        return [self.if_true, self.if_false]

    def replace(self, mapping: Dict[str, str]) -> "CondBranch":
        return CondBranch(self.cond, mapping.get(self.if_true, self.if_true),
                          mapping.get(self.if_false, self.if_false))


@dataclass(eq=False)
class Return:
    def successors(self) -> List[str]:
        return []

    def replace(self, mapping: Dict[str, str]) -> "Return":
        return Return()


Terminator = object  # Jump | CondBranch | Return


@dataclass(eq=False)
class Phi:
    """Phi node: result selects ``incomings[pred_block]`` on entry from pred."""

    result: Value
    incomings: Dict[str, object]  # pred block name -> Value | const

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self.result!r} = phi {self.incomings}"


@dataclass(eq=False)
class BasicBlock:
    name: str
    phis: List[Phi] = field(default_factory=list)
    instrs: List[Instr] = field(default_factory=list)
    terminator: Optional[Terminator] = None

    def successors(self) -> List[str]:
        return [] if self.terminator is None else self.terminator.successors()

    def has_barrier(self) -> bool:
        return any(i.op == "barrier" for i in self.instrs)


@dataclass
class BufferArg:
    """A kernel buffer argument (pointer in OpenCL terms)."""

    name: str
    dtype: str
    space: str  # GLOBAL | LOCAL | CONSTANT
    size: Optional[int] = None  # local buffers have a static size


@dataclass
class ScalarArg:
    name: str
    dtype: str


class Function:
    """A kernel function: CFG + argument list."""

    def __init__(self, name: str, ndim: int = 1):
        self.name = name
        self.ndim = ndim
        self.blocks: Dict[str, BasicBlock] = {}
        self.entry: str = "entry"
        self.buffer_args: List[BufferArg] = []
        self.scalar_args: List[ScalarArg] = []
        self.arg_values: Dict[str, Value] = {}
        self._name_counter = itertools.count()

    # -- construction helpers ------------------------------------------------
    def new_block(self, hint: str = "bb") -> BasicBlock:
        name = f"{hint}{next(self._name_counter)}"
        blk = BasicBlock(name)
        self.blocks[name] = blk
        return blk

    def add_block(self, blk: BasicBlock) -> None:
        assert blk.name not in self.blocks
        self.blocks[blk.name] = blk

    # -- graph queries --------------------------------------------------------
    def predecessors(self) -> Dict[str, List[str]]:
        preds: Dict[str, List[str]] = {n: [] for n in self.blocks}
        for name, blk in self.blocks.items():
            for s in blk.successors():
                preds[s].append(name)
        return preds

    def exit_blocks(self) -> List[str]:
        return [n for n, b in self.blocks.items()
                if isinstance(b.terminator, Return)]

    def rpo(self) -> List[str]:
        """Reverse post-order from entry (unreachable blocks excluded)."""
        seen: Set[str] = set()
        order: List[str] = []

        def visit(n: str) -> None:
            stack = [(n, iter(self.blocks[n].successors()))]
            seen.add(n)
            while stack:
                cur, it = stack[-1]
                advanced = False
                for s in it:
                    if s not in seen:
                        seen.add(s)
                        stack.append((s, iter(self.blocks[s].successors())))
                        advanced = True
                        break
                if not advanced:
                    order.append(cur)
                    stack.pop()

        visit(self.entry)
        return list(reversed(order))

    def prune_unreachable(self) -> None:
        reachable = set(self.rpo())
        dead = [n for n in self.blocks if n not in reachable]
        for n in dead:
            del self.blocks[n]
        # drop phi incomings from removed blocks
        for blk in self.blocks.values():
            for phi in blk.phis:
                phi.incomings = {p: v for p, v in phi.incomings.items()
                                 if p in self.blocks}

    # -- analyses --------------------------------------------------------------
    def dominators(self) -> Dict[str, Set[str]]:
        """Classic iterative dominator sets (small graphs; clarity > speed)."""
        order = self.rpo()
        preds = self.predecessors()
        allb = set(order)
        dom: Dict[str, Set[str]] = {n: set(allb) for n in order}
        dom[self.entry] = {self.entry}
        changed = True
        while changed:
            changed = False
            for n in order:
                if n == self.entry:
                    continue
                ps = [p for p in preds[n] if p in dom]
                new = set(allb)
                for p in ps:
                    new &= dom[p]
                new |= {n}
                if new != dom[n]:
                    dom[n] = new
                    changed = True
        return dom

    def natural_loops(self) -> List[Tuple[str, Set[str]]]:
        """Return [(header, loop_blocks)] via back-edge detection."""
        dom = self.dominators()
        preds = self.predecessors()
        loops: Dict[str, Set[str]] = {}
        for name, blk in self.blocks.items():
            for s in blk.successors():
                if s in dom.get(name, set()):  # back edge name -> s
                    body = loops.setdefault(s, {s})
                    # all blocks that reach `name` without passing s
                    stack = [name]
                    while stack:
                        n = stack.pop()
                        if n in body:
                            continue
                        body.add(n)
                        stack.extend(p for p in preds[n] if p not in body)
        return [(h, b) for h, b in loops.items()]

    def verify(self) -> None:
        for name, blk in self.blocks.items():
            assert blk.terminator is not None, f"block {name} unterminated"
            for s in blk.successors():
                assert s in self.blocks, f"{name} -> missing {s}"


# --------------------------------------------------------------------------
# CreateSubgraph / ReplicateCFG  (paper §4.2 helper functions)
# --------------------------------------------------------------------------

def create_subgraph(fn: Function, a: str, b_set: Set[str]) -> Set[str]:
    """All nodes potentially visited when traversing from ``a`` to any node in
    ``b_set`` — depth-first search recording every node on paths to the exits,
    ignoring edges back to visited nodes (paper: CreateSubgraph).

    Returns the set of block names, *excluding* ``a`` itself and the targets.
    """
    # nodes reachable from a (without revisiting)
    fwd: Set[str] = set()
    stack = [s for s in fn.blocks[a].successors()]
    while stack:
        n = stack.pop()
        if n in fwd or n in b_set:
            if n in b_set:
                fwd.add(n)
            continue
        fwd.add(n)
        stack.extend(fn.blocks[n].successors())
    return fwd - b_set - {a}


def replicate_cfg(fn: Function, nodes: Set[str], suffix: str) -> Dict[str, str]:
    """Copy ``nodes`` (blocks + their edges) into ``fn`` with fresh names.

    Edges leaving the subgraph keep their original targets (the defining
    property of sub-CFG replication in §4.2).  Returns old->new name map.
    """
    mapping = {n: f"{n}.{suffix}" for n in nodes}
    # 1:1 copy of instructions; fresh result Values, remapped operands.
    val_map: Dict[int, Value] = {}

    def copy_val(v: object) -> object:
        if isinstance(v, Value) and v.id in val_map:
            return val_map[v.id]
        return v

    # First pass: allocate fresh result values for every instr/phi result.
    for n in nodes:
        blk = fn.blocks[n]
        for phi in blk.phis:
            nv = Value(phi.result.dtype, phi.result.name + "." + suffix)
            val_map[phi.result.id] = nv
        for ins in blk.instrs:
            if ins.result is not None:
                nv = Value(ins.result.dtype, ins.result.name + "." + suffix)
                val_map[ins.result.id] = nv

    for n in nodes:
        blk = fn.blocks[n]
        nb = BasicBlock(mapping[n])
        for phi in blk.phis:
            inc = {}
            for pred, v in phi.incomings.items():
                # predecessors inside the subgraph are remapped; outside preds
                # keep their names (the copy may be unreachable from them; the
                # caller rewires edges and must clean up phis afterwards).
                inc[mapping.get(pred, pred)] = copy_val(v)
            nb.phis.append(Phi(val_map[phi.result.id], inc))
        for ins in blk.instrs:
            nops = [copy_val(o) for o in ins.operands]
            res = val_map[ins.result.id] if ins.result is not None else None
            nb.instrs.append(Instr(ins.op, nops, res, dict(ins.attrs)))
        term = blk.terminator
        if isinstance(term, CondBranch):
            nb.terminator = CondBranch(copy_val(term.cond),
                                       mapping.get(term.if_true, term.if_true),
                                       mapping.get(term.if_false, term.if_false))
        elif isinstance(term, Jump):
            nb.terminator = Jump(mapping.get(term.target, term.target))
        else:
            nb.terminator = Return()
        fn.add_block(nb)

    # Uses of replicated values *inside* the copies were remapped above.  Uses
    # outside the subgraph still refer to the originals, which is correct:
    # the originals remain on their own paths.
    return mapping


def remap_phi_preds(fn: Function) -> None:
    """Drop phi incomings whose predecessor edge no longer exists."""
    preds = fn.predecessors()
    for name, blk in fn.blocks.items():
        for phi in blk.phis:
            phi.incomings = {p: v for p, v in phi.incomings.items()
                             if p in preds[name]}


def split_at_barriers(fn: Function) -> None:
    """Rewrite the CFG so each ``barrier`` instr sits alone in its own block.

    After this pass a block either contains exactly one barrier (and nothing
    else), or no barrier at all; region formation then treats barrier blocks
    as graph nodes directly (paper Def. 1 preparation).
    """
    work = list(fn.blocks.keys())
    for name in work:
        blk = fn.blocks[name]
        if len(blk.instrs) == 1 and blk.instrs[0].op == "barrier" \
                and not blk.phis and isinstance(blk.terminator, Jump):
            continue  # already isolated
        idx = next((i for i, ins in enumerate(blk.instrs)
                    if ins.op == "barrier"), None)
        while idx is not None:
            # head: instrs[:idx] stays in blk; barrier alone; tail gets rest.
            bar_blk = fn.new_block(f"{name}.bar")
            tail_blk = fn.new_block(f"{name}.cont")
            bar_blk.instrs = [blk.instrs[idx]]
            bar_blk.terminator = Jump(tail_blk.name)
            tail_blk.instrs = blk.instrs[idx + 1:]
            tail_blk.terminator = blk.terminator
            blk.instrs = blk.instrs[:idx]
            blk.terminator = Jump(bar_blk.name)
            # phi predecessors of blk's old successors must be renamed
            for s in tail_blk.successors():
                for phi in fn.blocks[s].phis:
                    if name in phi.incomings:
                        phi.incomings[tail_blk.name] = phi.incomings.pop(name)
            blk = tail_blk
            name = tail_blk.name
            idx = next((i for i, ins in enumerate(blk.instrs)
                        if ins.op == "barrier"), None)


def ensure_single_exit(fn: Function) -> str:
    """Merge multiple Return blocks into one unified exit block."""
    exits = fn.exit_blocks()
    if len(exits) == 1:
        return exits[0]
    unified = fn.new_block("exit")
    unified.terminator = Return()
    for e in exits:
        fn.blocks[e].terminator = Jump(unified.name)
    return unified.name


def infer_binop_dtype(op: str, a_dtype: str, b_dtype: str) -> str:
    if op in CMPOPS:
        return "bool"
    return str(np.result_type(a_dtype, b_dtype))
