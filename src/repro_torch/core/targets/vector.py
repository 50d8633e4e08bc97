"""Vector target over torch tensors: work-items on lanes, divergence
if-converted.

The port of ``repro.core.targets.vector``: the target-specific *parallel
mapping* stage of the pocl pipeline (paper Fig. 3).  Every varying SSA
value is a lane vector (one work-item per lane, the SIMD mapping of
§4.1), uniform values stay 0-d tensors (the §4.7 merge), and divergent
control flow inside a region runs fully predicated (if-conversion).  The
next region is read from each work-group's lane 0, the peeled first
work-item of §4.4.  A linear schedule runs as a chain of region calls;
any other schedule as a loop over a switch of regions.

One departure from the reference: the reference runs one work-group at
a time (``lax.fori_loop`` over groups); this target runs a whole range
of groups at once, as ``groups x local_size`` lanes.  ``LOCAL`` arrays
get one zeroed copy per group, and each group keeps its own region id,
so groups whose schedules diverge run their regions under an entry
predicate.  Results equal the reference's for every kernel whose
work-groups do not depend on each other, which is OpenCL's contract.  It
is what makes this target usable as the plain version of the ``cuda``
target at real problem sizes.

Reference semantics kept explicitly, since torch's differ:

* loads clamp their index to ``[0, n-1]``;
* stores wrap an index in ``[-n, -1]`` to ``idx + n`` and drop every
  other out-of-range or masked-off index;
* integer ``div``/``rem`` truncate toward zero, ``x / 0 == -1``,
  ``x % 0 == x`` and ``INT_MIN / -1 == INT_MIN``;
* shifts by an amount outside ``[0, 31]`` give 0 (``shl``) or the sign
  fill (``shr``);
* float-to-integer ``convert`` saturates and maps NaN to 0;
* JAX runs with 64-bit types disabled, so 64-bit IR dtypes compute at
  32 bits here too.

Every operand is cast to the instruction's dtype before the op: torch's
type promotion differs from JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .. import ir
from ..context import ContextPlan
from ..errors import InvalidArgError
from ..ir import CondBranch, Function, Instr, Jump, Value
from ..passes import BlockNode, LoopNode, WorkGroupPlan, build_plan
from ..regions import Region, WGInfo

# value dtypes as the reference computes them (JAX without x64)
_VALUE_DTYPES = {"float32": torch.float32, "float64": torch.float32,
                 "int32": torch.int32, "int64": torch.int32,
                 "bool": torch.bool}
# buffer element dtypes a launch accepts
BUFFER_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                 "int32": torch.int32, "int64": torch.int64,
                 "bool": torch.bool}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype a value of IR dtype ``dtype`` computes in."""
    name = np.dtype(dtype).name
    try:
        return _VALUE_DTYPES[name]
    except KeyError:
        raise InvalidArgError(
            f"IR dtype {name!r} is not supported by the torch targets "
            f"(supported: {sorted(_VALUE_DTYPES)})") from None


# ---------------------------------------------------------------------------
# Reference arithmetic on torch tensors
# ---------------------------------------------------------------------------

def convert(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``x.astype(dt)`` with XLA's rules: float-to-integer saturates and
    maps NaN to 0 (torch leaves both undefined)."""
    if x.dtype == dt:
        return x
    if x.dtype.is_floating_point and not dt.is_floating_point \
            and dt != torch.bool:
        info = torch.iinfo(dt)
        hi = x >= float(info.max) + 1.0
        lo = x < float(info.min)
        bad = hi | lo | torch.isnan(x)
        r = torch.where(bad, torch.zeros_like(x), x).to(dt)
        r = torch.where(hi, torch.full_like(r, info.max), r)
        return torch.where(lo, torch.full_like(r, info.min), r)
    return x.to(dt)


def _div(a, b):
    if a.dtype.is_floating_point:
        return a / b
    special = (b == 0) | (b == -1)
    q = torch.div(a, torch.where(special, torch.ones_like(b), b),
                  rounding_mode="trunc")
    q = torch.where(b == -1, torch.neg(a), q)
    return torch.where(b == 0, torch.full_like(q, -1), q)


def _rem(a, b):
    if a.dtype.is_floating_point:
        return torch.fmod(a, b)
    special = (b == 0) | (b == -1)
    r = torch.fmod(a, torch.where(special, torch.ones_like(b), b))
    r = torch.where(b == -1, torch.zeros_like(r), r)
    return torch.where(b == 0, a, r)


def _shift_out(a, b):
    return (b < 0) | (b >= torch.iinfo(a.dtype).bits)


def _shl(a, b):
    out = _shift_out(a, b)
    r = torch.bitwise_left_shift(a, torch.where(out, torch.zeros_like(b), b))
    return torch.where(out, torch.zeros_like(r), r)


def _shr(a, b):
    out = _shift_out(a, b)
    r = torch.bitwise_right_shift(a, torch.where(out, torch.zeros_like(b), b))
    fill = torch.where(a < 0, torch.full_like(a, -1), torch.zeros_like(a))
    return torch.where(out, fill, r)


_BIN = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul,
    "div": _div, "rem": _rem,
    "min": torch.minimum, "max": torch.maximum, "pow": torch.pow,
    "and": torch.bitwise_and, "or": torch.bitwise_or,
    "xor": torch.bitwise_xor,
    "shl": _shl, "shr": _shr,
    "lt": torch.lt, "le": torch.le, "gt": torch.gt,
    "ge": torch.ge, "eq": torch.eq, "ne": torch.ne,
}

_UN = {
    "neg": torch.neg,
    "not": lambda a: torch.logical_not(a) if a.dtype == torch.bool
    else torch.bitwise_not(a),
    "abs": torch.abs, "exp": torch.exp, "log": torch.log, "sin": torch.sin,
    "cos": torch.cos, "tanh": torch.tanh, "erf": torch.erf,
    "sqrt": torch.sqrt, "rsqrt": torch.rsqrt, "floor": torch.floor,
    "ceil": torch.ceil, "rint": torch.round,   # half to even, as jnp.round
}

# ops served by Vecmathlib (§5) when use_vml=True
_VML_OPS = {"exp": "exp", "log": "log", "sin": "sin", "cos": "cos",
            "tanh": "tanh", "erf": "erf", "sqrt": "sqrt", "rsqrt": "rsqrt"}


# ---------------------------------------------------------------------------
# Predicates: None means "all lanes true"
# ---------------------------------------------------------------------------

def _pand(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return torch.logical_and(a, b)


def _pnot_and(a, c):
    """a AND NOT c."""
    nc = torch.logical_not(c)
    return nc if a is None else torch.logical_and(a, nc)


def _por(preds: List[object]):
    if any(p is None for p in preds):
        return None
    if not preds:
        return None  # unreachable block; treated as never-executed by caller
    out = preds[0]
    for p in preds[1:]:
        out = torch.logical_or(out, p)
    return out


def _as_lanes(p, n: int, device: torch.device):
    if p is None:
        return torch.ones((n,), dtype=torch.bool, device=device)
    if p.dim() == 0:
        return p.expand(n)
    return p


# ---------------------------------------------------------------------------
# Per-launch state
# ---------------------------------------------------------------------------

@dataclass
class Launch:
    """A validated NDRange launch: the device the buffers live on, the
    group counts, the range ``[lo, hi)`` of linear group ids to run, the
    scalar arguments (as given, and as 0-d tensors once a torch target
    binds them), the ``LOCAL`` arrays materialized per group (name ->
    elements), and a cache of literal tensors on the device."""

    device: torch.device
    ngrp: Tuple[int, int, int]
    lo: int
    hi: int
    scalars: Dict[str, object]
    locals: Dict[str, int]
    values: Dict[str, torch.Tensor] = field(default_factory=dict)
    lits: Dict[tuple, torch.Tensor] = field(default_factory=dict)

    def lit(self, o) -> torch.Tensor:
        a = np.asarray(o)
        key = (a.dtype.name, a.tobytes())
        t = self.lits.get(key)
        if t is None:
            t = torch.tensor(a.item(), dtype=torch_dtype(a.dtype),
                             device=self.device)
            self.lits[key] = t
        return t


@dataclass
class Lanes:
    """The lanes a :class:`LaneExec` runs: ``groups`` work-groups of
    ``per_group`` work-items each, laid out group-major.  ``lids`` are
    the linear local ids, ``gl`` the linear group ids and ``gslot`` the
    group's index within the batch (it offsets ``LOCAL`` arrays)."""

    lids: torch.Tensor
    gl: torch.Tensor
    gslot: torch.Tensor
    groups: int
    per_group: int

    @property
    def n(self) -> int:
        return int(self.lids.shape[0])


# ---------------------------------------------------------------------------
# The lane executor
# ---------------------------------------------------------------------------

class LaneExec:
    """Executes parallel regions for a batch of lanes (work-items)."""

    def __init__(self, prog: "WGProgram", launch: Launch, lanes: Lanes,
                 buffers: Dict[str, torch.Tensor],
                 vregs: Dict[str, torch.Tensor],
                 env: Optional[Dict[int, torch.Tensor]] = None):
        self.prog = prog
        self.fn = prog.wg.fn
        self.launch = launch
        self.lanes = lanes
        self.N = lanes.n
        self.buffers = dict(buffers)
        self.vregs = dict(vregs)
        self.env: Dict[int, torch.Tensor] = dict(env or {})
        for nm, v in self.fn.arg_values.items():
            self.env[v.id] = launch.values[nm]

    # -- value plumbing ------------------------------------------------------
    def val(self, o) -> torch.Tensor:
        if isinstance(o, Value):
            return self.env[o.id]
        return self.launch.lit(o)  # numpy literal folded by fold_constants

    def _varying(self, name: str) -> bool:
        return not self.prog.uni.vreg_uniform(name)

    def _bcast_vreg(self, name: str, x):
        if self._varying(name) and x.dim() == 0:
            return x.expand(self.N)
        return x

    # -- ids -------------------------------------------------------------------
    def _id_op(self, op: str, dim: int):
        lsz = self.prog.lsz
        ngrp = self.launch.ngrp
        if op == "local_size":
            return self.launch.lit(np.int32(lsz[dim]))
        if op == "num_groups":
            return self.launch.lit(np.int32(ngrp[dim]))
        if op == "global_size":
            return self.launch.lit(np.int32(lsz[dim] * ngrp[dim]))
        if op == "local_id":
            return self._local_id(dim)
        if op == "group_id":
            return self._group_id(dim)
        if op == "global_id":
            return self._group_id(dim) * lsz[dim] + self._local_id(dim)
        raise AssertionError(op)

    def _local_id(self, dim: int):
        lsz = self.prog.lsz
        lin = self.lanes.lids
        if dim == 0:
            return lin % lsz[0]
        if dim == 1:
            return (lin // lsz[0]) % lsz[1]
        return lin // (lsz[0] * lsz[1])

    def _group_id(self, dim: int):
        ngrp = self.launch.ngrp
        g = self.lanes.gl
        if dim == 0:
            return g % ngrp[0]
        if dim == 1:
            return (g // ngrp[0]) % ngrp[1]
        return g // (ngrp[0] * ngrp[1])

    # -- memory -----------------------------------------------------------------
    def _extent(self, name: str) -> Tuple[int, Optional[torch.Tensor]]:
        """(elements one group sees, per-lane element offset or None)."""
        size = self.launch.locals.get(name)
        if size is None:
            return int(self.buffers[name].shape[0]), None
        if self.lanes.groups == 1:
            return size, None
        return size, self.lanes.gslot.long() * size

    def _load(self, name: str, idx) -> torch.Tensor:
        size, off = self._extent(name)
        i = convert(idx, torch.int32).long().clamp(0, size - 1)
        if off is not None:
            i = i + off
        return self.buffers[name][i]

    def _store(self, name: str, idx, v, pred) -> None:
        buf = self.buffers[name]
        size, off = self._extent(name)
        i = convert(idx, torch.int32).long()
        i = torch.where(i < 0, i + size, i)
        ok = (i >= 0) & (i < size)
        if pred is not None:
            ok = ok & pred
        if off is not None:
            i = i + off
        v = convert(v, buf.dtype)
        i, v, ok = torch.broadcast_tensors(i, v, ok)
        buf.index_put_((i[ok],), v[ok])

    # -- instruction execution --------------------------------------------------
    def exec_instr(self, ins: Instr, pred) -> None:
        op = ins.op
        if op == "vreg_read":
            name = ins.attrs["vreg"]
            if name not in self.vregs:
                shape = (self.N,) if self._varying(name) else ()
                self.vregs[name] = torch.zeros(
                    shape, dtype=torch_dtype(ins.attrs["dtype"]),
                    device=self.launch.device)
            r = self.vregs[name]
        elif op == "vreg_write":
            name = ins.attrs["vreg"]
            v = convert(self.val(ins.operands[0]),
                        torch_dtype(ins.attrs["dtype"]))
            old = self.vregs.get(name)
            if pred is None or old is None:
                nv = v if pred is None else \
                    torch.where(pred, v, torch.zeros_like(v))
            else:
                nv = torch.where(pred, v, old)
            self.vregs[name] = self._bcast_vreg(name, nv)
            return
        elif op == "convert":
            r = convert(self.val(ins.operands[0]),
                        torch_dtype(ins.result.dtype))
        elif op in ir.BINOPS or op in ir.CMPOPS:
            a = self.val(ins.operands[0])
            b = self.val(ins.operands[1])
            dt = torch.promote_types(a.dtype, b.dtype) if op in ir.CMPOPS \
                else torch_dtype(ins.result.dtype)
            r = _BIN[op](convert(a, dt), convert(b, dt))
        elif op in ir.UNOPS:
            a = self.val(ins.operands[0])
            r = convert(self._unop(op, a), torch_dtype(ins.result.dtype))
        elif op == "select":
            c, a, b = (self.val(o) for o in ins.operands)
            dt = torch_dtype(ins.result.dtype)
            r = torch.where(convert(c, torch.bool), convert(a, dt),
                            convert(b, dt))
        elif op in ir.ID_OPS:
            r = self._id_op(op, ins.attrs["dim"])
        elif op == "load":
            r = self._load(ins.attrs["buffer"], self.val(ins.operands[0]))
        elif op == "store":
            self._store(ins.attrs["buffer"], self.val(ins.operands[0]),
                        self.val(ins.operands[1]), pred)
            return
        elif op == "barrier":
            raise AssertionError("barrier inside a parallel region")
        else:
            raise NotImplementedError(f"vector target: op {op}")
        if ins.result is not None:
            self.env[ins.result.id] = r

    def _unop(self, op: str, a):
        if self.prog.use_vml and op in _VML_OPS:
            from ... import vml
            return getattr(vml, _VML_OPS[op])(a)
        if a.dtype != torch.bool and not a.dtype.is_floating_point \
                and op not in ("neg", "not", "abs"):
            # jnp computes float math of an integer in float32
            a = a.to(torch.float32)
        return _UN[op](a)

    # -- region execution ---------------------------------------------------------
    def exec_region(self, region: Region, entry_pred=None) -> Dict[str, object]:
        """Run a region; returns {exit barrier -> predicate} ('' for
        Return).  ``entry_pred`` masks the lanes of groups that are not
        scheduled on this region."""
        if region.entry is None:
            return {}
        plan = self.prog.region_plans[region.barrier]
        exits: Dict[str, object] = {}
        self._exec_items(plan, region, entry_pred=entry_pred,
                         entry_block=region.entry, exits=exits)
        return exits

    def _exec_items(self, items: List[object], region: Region, entry_pred,
                    entry_block: str, exits: Dict[str, object]) -> None:
        fn = self.fn
        edge_preds: Dict[Tuple[str, str], object] = {}

        def incoming(name: str, scope_blocks: Set[str]):
            ps = [edge_preds[(p, name)] for p in scope_blocks
                  if (p, name) in edge_preds]
            if name == entry_block:
                if ps:
                    return _por(ps + [entry_pred])
                return entry_pred
            if not ps:
                return "UNREACHED"
            return _por(ps)

        scope_blocks: Set[str] = set()
        for it in items:
            if isinstance(it, BlockNode):
                scope_blocks.add(it.name)
            else:
                scope_blocks |= it.blocks

        for it in items:
            if isinstance(it, BlockNode):
                name = it.name
                pred = incoming(name, scope_blocks)
                if isinstance(pred, str):
                    continue  # unreachable within this execution
                blk = fn.blocks[name]
                for ins in blk.instrs:
                    self.exec_instr(ins, pred)
                term = blk.terminator
                if isinstance(term, Jump):
                    self._route(term.target, pred, region, edge_preds, exits,
                                name)
                elif isinstance(term, CondBranch):
                    c = convert(self.val(term.cond), torch.bool)
                    self._route(term.if_true, _pand(pred, c), region,
                                edge_preds, exits, name)
                    self._route(term.if_false, _pnot_and(pred, c), region,
                                edge_preds, exits, name)
                else:  # Return — terminal region
                    exits[""] = pred
            else:  # LoopNode
                pred_enter = incoming(it.header, scope_blocks)
                if isinstance(pred_enter, str):
                    continue
                self._exec_loop(it, region, pred_enter)
                self._route(it.exit_target, pred_enter, region, edge_preds,
                            exits, it.header)

    def _route(self, target: str, pred, region: Region,
               edge_preds, exits, src: str) -> None:
        if target in region.blocks:
            key = (src, target)
            if key in edge_preds:
                edge_preds[key] = _por([edge_preds[key], pred])
            else:
                edge_preds[key] = pred
        else:
            # region exit: successor barrier
            if target in exits:
                exits[target] = _por([exits[target], pred])
            else:
                exits[target] = pred

    # -- loops ------------------------------------------------------------------
    def _exec_loop(self, node: LoopNode, region: Region, pred_enter) -> None:
        """The reference's ``lax.while_loop``: the carry is the loop's
        vregs and the header's values (buffers are updated in place);
        everything else the body defines dies with the iteration."""
        fn = self.fn
        hdr = fn.blocks[node.header]
        term = hdr.terminator
        assert isinstance(term, CondBranch)
        cond_val = term.cond
        body_first = term.if_true == node.body_entry

        def cond_of(ex):
            c = convert(ex.val(cond_val), torch.bool)
            return c if body_first else torch.logical_not(c)

        # values defined in the header survive the loop (they dominate the
        # exit block); latch them across iterations.
        header_vals = [ins.result for ins in hdr.instrs
                       if ins.result is not None]
        loop_vregs = sorted(self._vregs_written(node.blocks))

        for ins in hdr.instrs:
            self.exec_instr(ins, pred_enter)
        c0 = cond_of(self)
        scalar_path = c0.dim() == 0 and (
            pred_enter is None or pred_enter.dim() == 0)

        # make sure every loop vreg exists before entering the carry
        for nm in loop_vregs:
            if nm not in self.vregs:
                shape = (self.N,) if self._varying(nm) else ()
                self.vregs[nm] = torch.zeros(
                    shape, dtype=torch_dtype(self._vreg_dtype(nm)),
                    device=self.launch.device)

        vr = [self.vregs[n] for n in loop_vregs]
        if scalar_path:
            # Lock-step loop with a scalar trip condition: this is the §4.6
            # horizontally-parallelized form — all work-items iterate together
            # and the body executes fully vectorized with no masks.
            c = c0 if pred_enter is None else torch.logical_and(c0, pred_enter)
            hv = [self.env[v.id] for v in header_vals]
            while bool(c):
                sub = self._fork(vr, loop_vregs, header_vals, hv)
                sub._exec_items(node.body_items, region,
                                entry_pred=pred_enter,
                                entry_block=node.body_entry, exits={})
                for ins in hdr.instrs:
                    sub.exec_instr(ins, pred_enter)
                c = cond_of(sub)
                vr = [sub.vregs[n] for n in loop_vregs]
                hv = [sub.env[v.id] for v in header_vals]
        else:
            it = _pand(_as_lanes(pred_enter, self.N, self.launch.device),
                      _as_lanes(c0, self.N, self.launch.device))
            hv = [torch.where(it, self.env[v.id], self.env[v.id])
                  for v in header_vals]
            while bool(it.any()):
                sub = self._fork(vr, loop_vregs, header_vals, hv)
                sub._exec_items(node.body_items, region, entry_pred=it,
                                entry_block=node.body_entry, exits={})
                for ins in hdr.instrs:
                    sub.exec_instr(ins, it)
                c = cond_of(sub)
                hv = [torch.where(it, sub.env[v.id], old)
                      for v, old in zip(header_vals, hv)]
                vr = [sub.vregs[n] for n in loop_vregs]
                it = torch.logical_and(
                    it, _as_lanes(c, self.N, self.launch.device))

        for n, v in zip(loop_vregs, vr):
            self.vregs[n] = v
        for val, v in zip(header_vals, hv):
            self.env[val.id] = v

    def _fork(self, vr, loop_vregs, header_vals, hv) -> "LaneExec":
        sub = LaneExec.__new__(LaneExec)
        sub.prog = self.prog
        sub.fn = self.fn
        sub.launch = self.launch
        sub.lanes = self.lanes
        sub.N = self.N
        sub.env = dict(self.env)
        sub.vregs = dict(self.vregs)
        sub.buffers = self.buffers
        for n, v in zip(loop_vregs, vr):
            sub.vregs[n] = v
        for val, v in zip(header_vals, hv):
            sub.env[val.id] = v
        return sub

    def _vregs_written(self, blocks: Set[str]) -> Set[str]:
        out: Set[str] = set()
        for b in blocks:
            for ins in self.fn.blocks[b].instrs:
                if ins.op == "vreg_write":
                    out.add(ins.attrs["vreg"])
        return out

    def _vreg_dtype(self, name: str) -> str:
        for blk in self.fn.blocks.values():
            for ins in blk.instrs:
                if ins.op in ("vreg_read", "vreg_write") \
                        and ins.attrs["vreg"] == name:
                    return ins.attrs["dtype"]
        raise KeyError(name)


# ---------------------------------------------------------------------------
# Work-group program
# ---------------------------------------------------------------------------

class WGProgram:
    """A compiled work-group function for a fixed local size (the paper
    compiles one work-group function per local size at enqueue time, §4.1).

    The target-specific *parallel mapping* half of the pipeline: it binds
    a prebuilt, shared :class:`~repro_torch.core.passes.WorkGroupPlan` to a
    lane count.  Passing a raw :class:`Function` builds the plan through
    the pass manager first.  A program holds no device state: the device
    is the one the launch's tensors live on."""

    def __init__(self, plan: "WorkGroupPlan | Function",
                 local_size: Sequence[int],
                 horizontal: bool = True, merge_uniform: bool = True,
                 use_vml: bool = False):
        self.lsz = tuple(int(x) for x in local_size) \
            + (1,) * (3 - len(local_size))
        self.L = int(np.prod(self.lsz))
        self.use_vml = use_vml
        self.horizontal = horizontal

        if not isinstance(plan, WorkGroupPlan):
            plan = build_plan(plan, horizontal=horizontal,
                              merge_uniform=merge_uniform)
        self.wgplan: WorkGroupPlan = plan
        self.wg: WGInfo = plan.wg
        self.uni = plan.uni
        self.plan: ContextPlan = plan.ctx
        self.region_plans = plan.region_plans
        self.md = plan.md
        self.order = self.wg.order
        self.rid_of = {b: i for i, b in enumerate(self.order)}
        self.K = len(self.order)

    # -- launch set-up ------------------------------------------------------------
    def check_launch(self, buffers: Dict[str, torch.Tensor],
                     scalars: Optional[Dict[str, object]],
                     global_size: Sequence[int],
                     group_range: Optional[Tuple[int, int]]) -> Launch:
        """Validate a launch's arguments and grid (shared by every
        target, the ``cuda`` one included)."""
        gsz = tuple(int(g) for g in global_size) \
            + (1,) * (3 - len(global_size))
        for g, l in zip(gsz, self.lsz):
            if g <= 0 or g % l:
                raise InvalidArgError(
                    f"global size {gsz} is not a positive multiple of the "
                    f"local size {self.lsz}")
        ngrp = tuple(g // l for g, l in zip(gsz, self.lsz))
        n_groups = int(np.prod(ngrp))
        lo, hi = (0, n_groups) if group_range is None \
            else (int(group_range[0]), int(group_range[1]))
        if not 0 <= lo <= hi <= n_groups:
            raise InvalidArgError(
                f"group_range {group_range} outside [0, {n_groups}]")
        fn = self.wg.fn
        devices = set()
        for a in fn.buffer_args:
            if a.space == ir.LOCAL and a.name not in buffers:
                continue
            t = buffers.get(a.name)
            if not isinstance(t, torch.Tensor):
                raise InvalidArgError(
                    f"kernel {fn.name!r} buffer {a.name!r}: expected a "
                    f"torch tensor, got {type(t).__name__}")
            if t.dim() != 1 or not t.is_contiguous() or t.numel() == 0:
                raise InvalidArgError(
                    f"kernel {fn.name!r} buffer {a.name!r}: expected a "
                    f"non-empty contiguous 1-D tensor, got shape "
                    f"{tuple(t.shape)}")
            if t.dtype != BUFFER_DTYPES.get(np.dtype(a.dtype).name):
                raise InvalidArgError(
                    f"kernel {fn.name!r} buffer {a.name!r}: expected "
                    f"dtype {a.dtype}, got {t.dtype}")
            devices.add(t.device)
        if len(devices) > 1:
            raise InvalidArgError(
                f"kernel {fn.name!r}: buffers on several devices {devices}")
        scalars = dict(scalars or {})
        missing = [a.name for a in fn.scalar_args if a.name not in scalars]
        if missing:
            raise InvalidArgError(
                f"kernel {fn.name!r}: scalars {missing} not given")
        # a LOCAL array the caller passes as a buffer is shared by the
        # groups, as in the reference
        locals_ = {a.name: int(a.size) for a in fn.buffer_args
                   if a.space == ir.LOCAL and a.name not in buffers}
        device = devices.pop() if devices else torch.device("cpu")
        return Launch(device, ngrp, lo, hi, scalars, locals_)

    # -- context helpers -------------------------------------------------------
    def _ctx_init(self, launch: Launch, n: int):
        out = []
        for s in self.plan.slots:
            shape = () if s.uniform else (n,)
            out.append(torch.zeros(shape, dtype=torch_dtype(s.dtype),
                                   device=launch.device))
        return out

    def _seed(self, ex: LaneExec, ctx) -> None:
        for s, v in zip(self.plan.slots, ctx):
            if s.kind == "val":
                ex.env[s.key] = v
            else:
                ex.vregs[s.key] = v

    def _harvest(self, ex: LaneExec, ctx, mask):
        lanes = ex.lanes
        out = []
        for s, old in zip(self.plan.slots, ctx):
            if s.kind == "val":
                v = ex.env.get(s.key, old)
            else:
                v = ex.vregs.get(s.key, old)
            v = convert(v, torch_dtype(s.dtype))
            if not s.uniform and v.dim() == 0:
                v = v.expand(lanes.n)
            elif s.uniform and v.dim() == 1:
                # the executor may represent a (provably) uniform value
                # lane-broadcast; collapse to each group's lane 0
                if lanes.groups == 1:
                    v = v[0]
                else:
                    v = v.view(lanes.groups, lanes.per_group)[:, :1] \
                        .expand(lanes.groups, lanes.per_group).reshape(-1)
            if mask is not None:
                v = torch.where(mask, v, old)
            out.append(v)
        return out

    def _next_rid(self, exits, lanes: Lanes, launch: Launch) -> torch.Tensor:
        """Each group's next region id, from its lane 0 (peeled first
        work-item, §4.4)."""
        rid = torch.full((lanes.groups,), self.K, dtype=torch.int64,
                         device=launch.device)
        for tgt, pred in exits.items():
            if tgt == "":
                continue
            t = self.rid_of[tgt]
            if pred is None:
                rid = torch.full_like(rid, t)
                continue
            p0 = pred.expand(lanes.groups) if pred.dim() == 0 else \
                pred.view(lanes.groups, lanes.per_group)[:, 0]
            rid = torch.where(p0, torch.full_like(rid, t), rid)
        return rid

    # -- work-group execution -----------------------------------------------------
    def run_groups(self, launch: Launch, buffers: Dict[str, torch.Tensor],
                   lo: int, hi: int) -> None:
        """Execute groups ``[lo, hi)`` together, updating ``buffers`` in
        place."""
        groups, per = hi - lo, self.L
        lane = torch.arange(groups * per, dtype=torch.int32,
                            device=launch.device)
        gslot = lane // per
        lanes = Lanes(lids=lane % per, gl=gslot + lo, gslot=gslot,
                      groups=groups, per_group=per)
        bufs = dict(buffers)
        for a in self.wg.fn.buffer_args:
            if a.name in launch.locals:
                bufs[a.name] = torch.zeros(
                    groups * launch.locals[a.name],
                    dtype=BUFFER_DTYPES[np.dtype(a.dtype).name],
                    device=launch.device)
        ctx = self._ctx_init(launch, lanes.n)

        def run_region(bar, ctx, mask):
            ex = LaneExec(self, launch, lanes, bufs, {})
            self._seed(ex, ctx)
            exits = ex.exec_region(self.wg.regions[bar], entry_pred=mask)
            return exits, self._harvest(ex, ctx, mask)

        if self.wg.is_chain():
            for bar in self.wg.chain():
                _, ctx = run_region(bar, ctx, None)
            return

        # general scheduler: while(switch(rid)), one region id per group
        rid = torch.zeros(groups, dtype=torch.int64, device=launch.device)
        while True:
            live = [r for r in torch.unique(rid).tolist() if r < self.K]
            if not live:
                return
            for r in live:
                on = rid == r
                mask = None if bool(on.all()) else \
                    on.repeat_interleave(per)
                exits, ctx = run_region(self.order[r], ctx, mask)
                rid = torch.where(on, self._next_rid(exits, lanes, launch),
                                  rid)

    # -- NDRange execution ------------------------------------------------------
    def launch_ndrange(self, buffers: Dict[str, torch.Tensor],
                       scalars: Optional[Dict[str, object]],
                       global_size: Sequence[int],
                       group_range: Optional[Tuple[int, int]] = None
                       ) -> Dict[str, torch.Tensor]:
        """Execute the NDRange over ``buffers`` (contiguous 1-D tensors on
        one device), updating them in place.  ``group_range=(lo, hi)``
        runs only that contiguous range of linearized work-groups of the
        full NDRange (group ids still decode against the full grid)."""
        launch = self.check_launch(buffers, scalars, global_size,
                                   group_range)
        launch.values = {a.name: torch.tensor(launch.scalars[a.name],
                                              dtype=torch_dtype(a.dtype),
                                              device=launch.device)
                         for a in self.wg.fn.scalar_args}
        if launch.hi > launch.lo:
            self.run_groups(launch, buffers, launch.lo, launch.hi)
        return buffers
