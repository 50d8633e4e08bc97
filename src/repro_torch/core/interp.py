"""Fiber-based reference executor for SPMD kernels.

This implements OpenCL work-group semantics the way Clover / Twin Peaks do
(paper §7): one light-weight thread ("fiber" = Python generator) per
work-item, yielding at every ``barrier`` and resuming in rounds.  It executes
the *original, untransformed* kernel CFG, so it serves as the ground-truth
oracle against which the pocl-style compiled targets (region-formed,
vectorized) are validated — mirroring how the paper contrasts the fiber
approach with static work-group compilation.

Pure numpy; intentionally slow and simple.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from . import ir
from .ir import CondBranch, Function, Instr, Jump, Return, Value


def _trunc_div(a, b):
    if np.issubdtype(np.asarray(a).dtype, np.integer):
        q = np.floor_divide(a, b)
        r = a - q * b
        # adjust toward-zero for mixed signs (C semantics)
        adj = (r != 0) & ((r < 0) != (b < 0))
        return (q + adj).astype(np.asarray(a).dtype)
    return a / b


def _trunc_rem(a, b):
    if np.issubdtype(np.asarray(a).dtype, np.integer):
        return (a - _trunc_div(a, b) * b).astype(np.asarray(a).dtype)
    return np.fmod(a, b)


_BIN = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": _trunc_div,
    "rem": _trunc_rem,
    "min": np.minimum,
    "max": np.maximum,
    "pow": np.power,
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "xor": lambda a, b: a ^ b,
    "shl": lambda a, b: a << b,
    "shr": lambda a, b: a >> b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
}

_UN = {
    "neg": lambda a: -a,
    "not": lambda a: ~a if np.issubdtype(np.asarray(a).dtype, np.integer)
    else np.logical_not(a),
    "abs": np.abs,
    "exp": np.exp,
    "log": np.log,
    "sin": np.sin,
    "cos": np.cos,
    "tanh": np.tanh,
    "erf": np.vectorize(math.erf),
    "sqrt": np.sqrt,
    "rsqrt": lambda a: 1.0 / np.sqrt(a),
    "floor": np.floor,
    "ceil": np.ceil,
    "rint": np.rint,
}


class _Fiber:
    """Executes one work-item; yields at barriers."""

    def __init__(self, fn: Function, buffers: Dict[str, np.ndarray],
                 scalars: Dict[str, object], ids: Dict[str, Tuple[int, ...]]):
        self.fn = fn
        self.buffers = buffers
        self.scalars = scalars
        self.ids = ids
        self.env: Dict[int, object] = {}
        for nm, v in fn.arg_values.items():
            self.env[v.id] = np.dtype(v.dtype).type(scalars[nm])

    def _val(self, o):
        if isinstance(o, Value):
            return self.env[o.id]
        return o

    def run(self) -> Iterator[None]:
        fn = self.fn
        cur = fn.entry
        prev: Optional[str] = None
        while True:
            blk = fn.blocks[cur]
            # phis evaluate simultaneously on entry
            if blk.phis:
                vals = [self._val(phi.incomings[prev]) for phi in blk.phis]
                for phi, v in zip(blk.phis, vals):
                    self.env[phi.result.id] = np.dtype(phi.result.dtype).type(v)
            for ins in blk.instrs:
                if ins.op == "barrier":
                    yield
                    continue
                self._exec(ins)
            term = blk.terminator
            if isinstance(term, Return):
                return
            if isinstance(term, Jump):
                prev, cur = cur, term.target
            else:
                assert isinstance(term, CondBranch)
                c = bool(self._val(term.cond))
                prev, cur = cur, (term.if_true if c else term.if_false)

    def _exec(self, ins: Instr) -> None:
        op = ins.op
        if op == "const":
            r = np.dtype(ins.result.dtype).type(ins.attrs["value"])
        elif op == "convert":
            r = np.dtype(ins.result.dtype).type(self._val(ins.operands[0]))
        elif op in _BIN:
            a, b = (self._val(o) for o in ins.operands)
            r = _BIN[op](a, b)
            r = np.dtype(ins.result.dtype).type(r)
        elif op in _UN:
            r = _UN[op](self._val(ins.operands[0]))
            r = np.dtype(ins.result.dtype).type(r)
        elif op == "select":
            c, a, b = (self._val(o) for o in ins.operands)
            r = a if bool(c) else b
        elif op in ir.ID_OPS:
            r = np.int32(self.ids[op][ins.attrs["dim"]])
        elif op == "load":
            buf = self.buffers[ins.attrs["buffer"]]
            idx = int(self._val(ins.operands[0]))
            r = buf[idx]
        elif op == "store":
            buf = self.buffers[ins.attrs["buffer"]]
            idx = int(self._val(ins.operands[0]))
            buf[idx] = self._val(ins.operands[1])
            return
        else:
            raise NotImplementedError(f"interp: op {op}")
        if ins.result is not None:
            self.env[ins.result.id] = r


def run_ndrange(fn: Function, global_size: Sequence[int],
                local_size: Sequence[int],
                buffers: Dict[str, np.ndarray],
                scalars: Optional[Dict[str, object]] = None) -> Dict[str, np.ndarray]:
    """Execute an NDRange with fiber semantics.  Returns the buffers dict
    (global buffers mutated in place on copies)."""
    scalars = scalars or {}
    gsz = tuple(global_size) + (1,) * (3 - len(global_size))
    lsz = tuple(local_size) + (1,) * (3 - len(local_size))
    for g, l in zip(gsz, lsz):
        assert g % l == 0, "global size must be divisible by local size"
    ngrp = tuple(g // l for g, l in zip(gsz, lsz))

    out = {k: np.array(v, copy=True) for k, v in buffers.items()}
    local_defs = [a for a in fn.buffer_args if a.space == ir.LOCAL]

    for gz in range(ngrp[2]):
        for gy in range(ngrp[1]):
            for gx in range(ngrp[0]):
                grp = (gx, gy, gz)
                bufs = dict(out)
                for la in local_defs:
                    if la.name not in buffers:
                        bufs[la.name] = np.zeros(la.size, dtype=la.dtype)
                fibers = []
                for lz in range(lsz[2]):
                    for ly in range(lsz[1]):
                        for lx in range(lsz[0]):
                            lid = (lx, ly, lz)
                            ids = {
                                "local_id": lid,
                                "group_id": grp,
                                "global_id": tuple(
                                    g * l + i for g, l, i in zip(grp, lsz, lid)),
                                "local_size": lsz,
                                "num_groups": ngrp,
                                "global_size": gsz,
                            }
                            fibers.append(
                                _Fiber(fn, bufs, scalars, ids).run())
                # round-robin between barriers
                live = list(fibers)
                while live:
                    nxt = []
                    for f in live:
                        try:
                            next(f)
                            nxt.append(f)
                        except StopIteration:
                            pass
                    live = nxt
                for k in out:
                    out[k] = bufs[k]
    return out
