"""Kernel builder DSL: the OpenCL-C analogue for authoring SPMD kernels.

Users write per-work-item kernels against :class:`KernelBuilder`, with
structured control flow (``if_``/``else_``/``while_loop``/``for_range``),
address-space-qualified buffers, and explicit ``barrier()`` calls — a Python
rendering of the OpenCL C kernel language (paper §2, Fig. 1).  The builder
lowers to the plain CFG IR in :mod:`repro.core.ir`; downstream passes recover
structure from the graph (dominators, natural loops) exactly as pocl does on
LLVM IR, so no pass trusts the builder's nesting.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Union


from . import ir
from .ir import (BufferArg, CondBranch, Function, Instr, Jump, Phi, Return,
                 ScalarArg, Value)

Number = Union[int, float, bool]


def _const_dtype(x: Number) -> str:
    if isinstance(x, bool):
        return "bool"
    if isinstance(x, int):
        return "int32"
    return "float32"


class Expr:
    """Operator-overloading wrapper around an SSA Value (or constant)."""

    __array_priority__ = 100

    def __init__(self, builder: "KernelBuilder", value: Value):
        self.b = builder
        self.value = value

    @property
    def dtype(self) -> str:
        return self.value.dtype

    # arithmetic ------------------------------------------------------------
    def _bin(self, op: str, other, rev: bool = False) -> "Expr":
        o = self.b._as_value(other)
        a, c = (o, self.value) if rev else (self.value, o)
        dt = ir.infer_binop_dtype(op, a.dtype, c.dtype)
        return self.b._emit(op, [a, c], dt)

    def __add__(self, o): return self._bin("add", o)
    def __radd__(self, o): return self._bin("add", o, True)
    def __sub__(self, o): return self._bin("sub", o)
    def __rsub__(self, o): return self._bin("sub", o, True)
    def __mul__(self, o): return self._bin("mul", o)
    def __rmul__(self, o): return self._bin("mul", o, True)
    def __truediv__(self, o): return self._bin("div", o)
    def __rtruediv__(self, o): return self._bin("div", o, True)
    def __floordiv__(self, o):
        d = self._bin("div", o)
        return d if d.dtype.startswith("int") else self.b.floor(d)
    def __mod__(self, o): return self._bin("rem", o)
    def __rmod__(self, o): return self._bin("rem", o, True)
    def __pow__(self, o): return self._bin("pow", o)
    def __and__(self, o): return self._bin("and", o)
    def __or__(self, o): return self._bin("or", o)
    def __xor__(self, o): return self._bin("xor", o)
    def __lshift__(self, o): return self._bin("shl", o)
    def __rshift__(self, o): return self._bin("shr", o)
    def __neg__(self): return self.b._emit("neg", [self.value], self.dtype)
    def __invert__(self): return self.b._emit("not", [self.value], self.dtype)

    # comparisons -----------------------------------------------------------
    def __lt__(self, o): return self._bin("lt", o)
    def __le__(self, o): return self._bin("le", o)
    def __gt__(self, o): return self._bin("gt", o)
    def __ge__(self, o): return self._bin("ge", o)
    def __eq__(self, o): return self._bin("eq", o)  # type: ignore[override]
    def __ne__(self, o): return self._bin("ne", o)  # type: ignore[override]
    __hash__ = None  # type: ignore[assignment]

    def astype(self, dtype: str) -> "Expr":
        return self.b._emit("convert", [self.value], dtype)


class Var:
    """A mutable variable handle (lowered to SSA with phis at joins)."""

    def __init__(self, builder: "KernelBuilder", name: str, init: Value):
        self.b = builder
        self.name = name
        builder._env[name] = init

    def get(self) -> Expr:
        return Expr(self.b, self.b._env[self.name])

    def set(self, v) -> None:
        self.b._env[self.name] = self.b._as_value(v)

    # sugar
    def __iadd__(self, o):
        self.set(self.get() + o)
        return self


class Buf:
    """A buffer handle: ``buf[idx]`` loads, ``buf[idx] = v`` stores."""

    def __init__(self, builder: "KernelBuilder", arg: BufferArg):
        self.b = builder
        self.arg = arg

    def __getitem__(self, idx) -> Expr:
        iv = self.b._as_value(idx, "int32")
        return self.b._emit("load", [iv], self.arg.dtype,
                            attrs={"buffer": self.arg.name,
                                   "space": self.arg.space})

    def __setitem__(self, idx, val) -> None:
        iv = self.b._as_value(idx, "int32")
        vv = self.b._as_value(val, self.arg.dtype)
        self.b._emit("store", [iv, vv], None,
                     attrs={"buffer": self.arg.name,
                            "space": self.arg.space})


class TileView:
    """Row-major 2-D indexing view over a flat :class:`Buf`.

    ``view[i, j]`` loads / ``view[i, j] = v`` stores ``buf[i*ld + j]``;
    ``ld`` (the leading dimension) may be a Python int or a uniform
    scalar ``Expr``.  This is the DSL's local-memory *tile* abstraction:
    OpenCL kernels address 2-D tiles of ``__local`` (and row-major
    global matrices) through exactly this flattening, and the suite's
    tiled-GEMM/stencil kernels want it spelled once, not at every
    index expression (docs/scoreboard.md §Authoring)."""

    def __init__(self, buf: Buf, ld):
        self.buf = buf
        self.ld = ld

    def _flat(self, idx):
        i, j = idx
        return i * self.ld + j

    def __getitem__(self, idx) -> Expr:
        return self.buf[self._flat(idx)]

    def __setitem__(self, idx, val) -> None:
        self.buf[self._flat(idx)] = val


class _LoopCtx:
    def __init__(self, builder: "KernelBuilder"):
        self.b = builder
        self.header: Optional[str] = None
        self.body: Optional[str] = None
        self.exit: Optional[str] = None
        self._cond_set = False
        self.header_phis: Dict[str, Phi] = {}
        self.preheader_env: Dict[str, Value] = {}

    def cond(self, c) -> None:
        """End the loop header: branch to body if ``c`` else to exit."""
        assert not self._cond_set, "loop cond() called twice"
        self._cond_set = True
        b = self.b
        cv = b._as_value(c, "bool")
        body = b.fn.new_block("body")
        exitb = b.fn.new_block("loopexit")
        self.body, self.exit = body.name, exitb.name
        b._cur.terminator = CondBranch(cv, body.name, exitb.name)
        b._cur = body


class KernelBuilder:
    """Builds a :class:`repro.core.ir.Function` from structured Python code."""

    def __init__(self, name: str, ndim: int = 1):
        self.fn = Function(name, ndim)
        entry = self.fn.new_block("entry")
        self.fn.entry = entry.name
        self._cur = entry
        self._env: Dict[str, Value] = {}
        self._var_counter = 0
        self._pending_else: Optional[tuple] = None

    # -- argument declaration -------------------------------------------------
    def arg_buffer(self, name: str, dtype: str = "float32",
                   space: str = ir.GLOBAL) -> Buf:
        arg = BufferArg(name, dtype, space)
        self.fn.buffer_args.append(arg)
        return Buf(self, arg)

    def local_array(self, name: str, dtype: str, size: int) -> Buf:
        """Automatic local array — converted to an extra buffer argument with a
        fixed allocation size, exactly as pocl §4.7 converts automatic locals
        to work-group-function arguments."""
        arg = BufferArg(name, dtype, ir.LOCAL, size=size)
        self.fn.buffer_args.append(arg)
        return Buf(self, arg)

    def local_tile(self, name: str, dtype: str,
                   shape: "tuple[int, int]") -> TileView:
        """A 2-D local-memory tile: a flat automatic local array of
        ``shape[0] * shape[1]`` elements wrapped in a row-major
        :class:`TileView` (``tile[i, j]``).  The flat array follows the
        pocl §4.7 automatic-local rule (:meth:`local_array`)."""
        h, w = int(shape[0]), int(shape[1])
        flat = self.local_array(name, dtype, h * w)
        return TileView(flat, w)

    def strided(self, buf: Buf, ld) -> TileView:
        """View a flat (row-major) global buffer as 2-D: ``v[i, j]``
        addresses ``buf[i*ld + j]``.  ``ld`` is the leading dimension —
        a Python int or a uniform scalar ``Expr`` (e.g. a matrix width
        argument)."""
        return TileView(buf, ld)

    def range_unrolled(self, stop: int, unroll: int = 1):
        """Iterate ``0 .. stop`` with build-time unrolling: an IR loop of
        stride ``unroll`` whose body is replicated ``unroll`` times, or —
        when ``unroll >= stop`` — pure straight-line code (no IR loop at
        all).  This is the suite kernels' *unroll* tuning axis: the same
        per-iteration body lowers to materially different CFGs, which is
        exactly what the per-target sweep measures.

        ``stop`` and ``unroll`` must be Python ints with
        ``stop % unroll == 0`` (callers pad their trip counts).  The
        generator must be consumed to exhaustion (a plain ``for`` does),
        because the IR loop closes when the final index is yielded."""
        stop, unroll = int(stop), int(unroll)
        assert stop >= 0 and unroll >= 1, (stop, unroll)
        if unroll >= stop:
            for k in range(stop):
                yield self.const(k, "int32")
            return
        assert stop % unroll == 0, \
            f"range_unrolled: {unroll} does not divide {stop}"
        with self.for_range(0, stop, step=unroll) as i:
            if unroll == 1:
                yield i
            else:
                for u in range(unroll):
                    yield i + u

    def arg_scalar(self, name: str, dtype: str = "int32") -> Expr:
        self.fn.scalar_args.append(ScalarArg(name, dtype))
        v = Value(dtype, name)
        self.fn.arg_values[name] = v
        return Expr(self, v)

    # -- value plumbing --------------------------------------------------------
    def _as_value(self, x, dtype: Optional[str] = None) -> Value:
        if isinstance(x, Expr):
            v = x.value
        elif isinstance(x, Var):
            v = x.get().value
        elif isinstance(x, Value):
            v = x
        else:
            dt = dtype or _const_dtype(x)
            e = self._emit("const", [], dt, attrs={"value": x})
            v = e.value
        if dtype is not None and v.dtype != dtype and dtype != "any":
            v = self._emit("convert", [v], dtype).value
        return v

    def _emit(self, op: str, operands: List[object], dtype: Optional[str],
              attrs: Optional[dict] = None) -> Optional[Expr]:
        res = Value(dtype) if dtype is not None else None
        self._cur.instrs.append(Instr(op, operands, res, attrs or {}))
        return Expr(self, res) if res is not None else None

    def const(self, x: Number, dtype: Optional[str] = None) -> Expr:
        return Expr(self, self._as_value(x, dtype or _const_dtype(x)))

    # -- builtins ----------------------------------------------------------------
    def _id(self, op: str, dim: int) -> Expr:
        return self._emit(op, [], "int32", attrs={"dim": dim})

    def local_id(self, dim: int = 0) -> Expr: return self._id("local_id", dim)
    def global_id(self, dim: int = 0) -> Expr: return self._id("global_id", dim)
    def group_id(self, dim: int = 0) -> Expr: return self._id("group_id", dim)
    def local_size(self, dim: int = 0) -> Expr: return self._id("local_size", dim)
    def num_groups(self, dim: int = 0) -> Expr: return self._id("num_groups", dim)
    def global_size(self, dim: int = 0) -> Expr: return self._id("global_size", dim)

    def barrier(self) -> None:
        self._emit("barrier", [], None)

    # -- math -----------------------------------------------------------------
    def _un(self, op: str, x, dtype: Optional[str] = None) -> Expr:
        v = self._as_value(x)
        return self._emit(op, [v], dtype or v.dtype)

    def exp(self, x): return self._un("exp", x)
    def log(self, x): return self._un("log", x)
    def sin(self, x): return self._un("sin", x)
    def cos(self, x): return self._un("cos", x)
    def tanh(self, x): return self._un("tanh", x)
    def erf(self, x): return self._un("erf", x)
    def sqrt(self, x): return self._un("sqrt", x)
    def rsqrt(self, x): return self._un("rsqrt", x)
    def floor(self, x): return self._un("floor", x)
    def abs(self, x): return self._un("abs", x)

    def minimum(self, a, b):
        av = self._as_value(a)
        bv = self._as_value(b)
        return self._emit("min", [av, bv],
                          ir.infer_binop_dtype("min", av.dtype, bv.dtype))

    def maximum(self, a, b):
        av = self._as_value(a)
        bv = self._as_value(b)
        return self._emit("max", [av, bv],
                          ir.infer_binop_dtype("max", av.dtype, bv.dtype))

    def select(self, c, a, b) -> Expr:
        cv = self._as_value(c, "bool")
        av = self._as_value(a)
        bv = self._as_value(b, av.dtype)
        return self._emit("select", [cv, av, bv], av.dtype)

    # -- variables -----------------------------------------------------------
    def var(self, init, name: Optional[str] = None) -> Var:
        self._var_counter += 1
        nm = name or f"var{self._var_counter}"
        return Var(self, nm, self._as_value(init))

    # -- structured control flow ------------------------------------------------
    @contextlib.contextmanager
    def if_(self, cond):
        self._pending_else = None
        cv = self._as_value(cond, "bool")
        then_blk = self.fn.new_block("then")
        join_blk = self.fn.new_block("join")
        branch_blk = self._cur
        snapshot = dict(self._env)
        self._cur.terminator = CondBranch(cv, then_blk.name, join_blk.name)
        self._cur = then_blk
        yield
        then_end = self._cur
        then_env = dict(self._env)
        then_end.terminator = Jump(join_blk.name)
        # stash state so an immediately-following else_() can rewire
        self._pending_else = (branch_blk, then_end.name, then_env,
                              snapshot, join_blk)
        self._env = snapshot
        self._cur = join_blk
        self._insert_join_phis(join_blk, [(then_end.name, then_env),
                                          (branch_blk.name, snapshot)])

    @contextlib.contextmanager
    def else_(self):
        assert self._pending_else is not None, "else_ without preceding if_"
        branch_blk, then_end_name, then_env, snapshot, join_blk = \
            self._pending_else
        self._pending_else = None
        # undo the phis/else-edge wiring done at if_ exit
        join_blk.phis = []
        else_blk = self.fn.new_block("else")
        term = branch_blk.terminator
        assert isinstance(term, CondBranch)
        branch_blk.terminator = CondBranch(term.cond, term.if_true,
                                           else_blk.name)
        self._env = dict(snapshot)
        self._cur = else_blk
        yield
        else_end = self._cur
        else_env = dict(self._env)
        else_end.terminator = Jump(join_blk.name)
        self._cur = join_blk
        self._env = dict(snapshot)
        self._insert_join_phis(join_blk, [(then_end_name, then_env),
                                          (else_end.name, else_env)])

    def _insert_join_phis(self, join_blk, incomings) -> None:
        """incomings: [(pred_block_name, env_at_pred_end)]"""
        names = set()
        for _, env in incomings:
            names |= set(env)
        for nm in sorted(names):
            vals = [env.get(nm) for _, env in incomings]
            if any(v is None for v in vals):
                continue  # defined on one path only: dead past the join
            if all(v is vals[0] for v in vals):
                self._env[nm] = vals[0]
                continue
            phi_res = Value(vals[0].dtype, f"{nm}.phi")
            join_blk.phis.append(
                Phi(phi_res, {pred: env[nm] for pred, env in incomings}))
            self._env[nm] = phi_res

    @contextlib.contextmanager
    def while_loop(self):
        self._pending_else = None
        pre = self._cur
        header = self.fn.new_block("header")
        pre.terminator = Jump(header.name)
        ctx = _LoopCtx(self)
        ctx.header = header.name
        ctx.preheader_env = dict(self._env)
        # Eager header phis for every live variable; trivial ones are
        # simplified away in finish() (standard SSA construction for loops).
        for nm, val in sorted(self._env.items()):
            phi_res = Value(val.dtype, f"{nm}.loop")
            header.phis.append(Phi(phi_res, {pre.name: val}))
            ctx.header_phis[nm] = header.phis[-1]
            self._env[nm] = phi_res
        self._cur = header
        yield ctx
        assert ctx._cond_set, "while_loop body must call ctx.cond(...)"
        latch = self._cur
        latch.terminator = Jump(ctx.header)
        for nm, phi in ctx.header_phis.items():
            phi.incomings[latch.name] = self._env[nm]
        # continue at the exit block; only preheader-visible vars survive the
        # loop (body-local vars do not dominate the exit block).
        self._env = {nm: phi.result for nm, phi in ctx.header_phis.items()}
        self._cur = self.fn.blocks[ctx.exit]

    @contextlib.contextmanager
    def for_range(self, start, stop, step=1):
        i = self.var(self._as_value(start, "int32"), name=f"i{self._var_counter}")
        with self.while_loop() as loop:
            loop.cond(i.get() < stop)
            yield i.get()
            i.set(i.get() + step)

    # -- finish ------------------------------------------------------------------
    def finish(self) -> Function:
        if self._cur.terminator is None:
            self._cur.terminator = Return()
        self.fn.prune_unreachable()
        simplify_phis(self.fn)
        self.fn.verify()
        return self.fn


def simplify_phis(fn: Function) -> None:
    """Remove trivial phis (all non-self incomings identical)."""
    changed = True
    while changed:
        changed = False
        replace: Dict[int, Value] = {}
        for blk in fn.blocks.values():
            keep = []
            for phi in blk.phis:
                ops = {v.id if isinstance(v, Value) else ("c", repr(v))
                       for v in phi.incomings.values()
                       if not (isinstance(v, Value) and v.id == phi.result.id)}
                vals = [v for v in phi.incomings.values()
                        if not (isinstance(v, Value) and v.id == phi.result.id)]
                if len(ops) == 1:
                    tgt = vals[0]
                    if isinstance(tgt, Value):
                        replace[phi.result.id] = tgt
                        changed = True
                        continue
                keep.append(phi)
            blk.phis = keep
        if not replace:
            break

        def sub(v):
            while isinstance(v, Value) and v.id in replace:
                v = replace[v.id]
            return v

        for blk in fn.blocks.values():
            for phi in blk.phis:
                phi.incomings = {p: sub(v) for p, v in phi.incomings.items()}
            for ins in blk.instrs:
                ins.operands = [sub(o) for o in ins.operands]
            term = blk.terminator
            if isinstance(term, CondBranch):
                term.cond = sub(term.cond)
