"""CUDA target: one thread block per work-group.

Replaces ``repro/core/targets/pallas_target.py:PallasWGProgram.run_ndrange``
(the Pallas grid target, one work-group per grid cell over the lane
mapping).  CUDA's natural mapping of OpenCL is different, so this target
turns the shared :class:`~repro_torch.core.passes.WorkGroupPlan` plus a
local size into CUDA C for Hopper (``sm_90a``), built with ``nvcc`` into a
shared library with a plain C launcher and bound with ``ctypes``.
:mod:`.cuda_mapping` takes the mapping's three decisions from the plan;
the emitted kernel:

* runs linear group ``blockIdx.x + lo`` in each block (``group_range``
  gives a grid of ``hi - lo`` blocks), one thread per work-item; group
  and local ids decode as the vector target's do;
* turns each region's CFG blocks into labels and ``goto``\\ s.  The plan's
  regions stay the unit of mapping.  Where every region's successor is
  work-group uniform, each thread jumps to the next region's label
  itself; otherwise the kernel keeps ``while (rid < K) switch (rid)``,
  where work-item 0 publishes the next region id through shared memory
  before the barrier (the peeled first work-item of paper §4.4);
* emits a ``__syncthreads()`` for every explicit barrier and for each
  implicit one whose removal could reorder memory accesses of different
  work-items (every region boundary of a ``while (switch)`` kernel);
* keeps every SSA value and virtual register in a per-thread local
  declared at function scope and set to zero there (the vector target's "unwritten
  vregs read zero").  Values that cross a barrier therefore stay in
  registers, and the §4.7 context arrays are not needed on this target —
  a deliberate departure from the other mappings;
* places ``LOCAL`` arrays in dynamic shared memory, zeroed by the block
  before region 0 (the reference zeroes them per group); a launch whose
  arrays exceed the device's opt-in limit is refused with a typed error;
* takes scalar arguments as kernel parameters, so a new value needs no
  rebuild (the Pallas target embedded them as literals);
* with ``use_vml=True``, calls Vecmathlib's functions in
  ``csrc/vml.cuh`` for exp, log, sin, cos, tanh, erf, sqrt and rsqrt, as
  the reference's Pallas kernel computed ``repro.vml`` in its body;
  without it, CUDA's libm;
* reproduces the reference's clamped loads, dropped stores and integer
  and conversion rules through ``csrc/wg_runtime.cuh``, and is built with
  ``-fmad=false`` so that each IR operation rounds once, as the IR says.
  That also makes each multiply-add two instructions, so no kernel of
  this target passes half of the FP32 peak.

One semantic difference remains: CUDA blocks run concurrently, while the
Pallas grid and the reference's loop over groups run them in order.
Results agree for kernels with no dependency between work-groups, which
is OpenCL's contract; every compiler case and suite kernel keeps it (the
histogram writes per-group partials).

What bounds it on the H100: device-memory bytes for the stencils, the
scan, the histogram and SpMV, and FP32 CUDA-core FMAs for GEMM.
Tensor cores, ``cp.async`` and TMA are later work.

Each library is cached under ``build/repro_torch/`` by the SHA-256 of its
source, the headers and the compiler flags, and is built at first
launch; :func:`build_many` builds many at once, one ``nvcc`` each.
``tests/test_torch_cuda_emit.py`` runs the emitted source on the CPU
against a stand-in for the CUDA runtime.
"""

from __future__ import annotations

import ctypes
import hashlib
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from .. import ir
from ..cache import canonical_value_names
from ..errors import InvalidArgError, ReproError, register_error
from ..ir import CondBranch, Jump, Return, Value
from ..nvcc import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, NvccJob, build_parallel
from .cuda_mapping import (CudaMapping, barrier_kind, literal_int, map_plan,
                           operand_range)
from .vector import _VML_OPS, WGProgram

MAX_THREADS = 1024          # CUDA's limit on threads per block
_STATIC_SMEM = 48 * 1024    # above this, dynamic shared memory needs opt-in
# the headers an emitted source may include; each library's digest hashes
# them all, so an edit to either rebuilds it
HEADERS = ("wg_runtime.cuh", "vml.cuh")


@register_error
class LaunchError(ReproError, RuntimeError):
    """The CUDA runtime refused or failed a kernel launch
    (CL_OUT_OF_RESOURCES)."""

    code = -5
    code_name = "CL_OUT_OF_RESOURCES"


# ---------------------------------------------------------------------------
# Types and literals
# ---------------------------------------------------------------------------

# values compute at the reference's precision (JAX without x64)
_CANON = {"float32": "float32", "float64": "float32", "int32": "int32",
          "int64": "int32", "bool": "bool"}
_CTYPE = {"float32": "float", "float64": "double", "int32": "int",
          "int64": "long long", "bool": "bool"}
_CTYPES_ARG = {"float32": ctypes.c_float, "int32": ctypes.c_int,
               "bool": ctypes.c_bool}


def _canon(dtype) -> str:
    name = np.dtype(dtype).name
    try:
        return _CANON[name]
    except KeyError:
        raise InvalidArgError(
            f"IR dtype {name!r} is not supported by the cuda target") \
            from None


def _is_float(t: str) -> bool:
    return t in ("float32", "float64")


def _cvt(e: str, src: str, dst: str) -> str:
    """C expression converting ``e`` from dtype ``src`` to ``dst`` with
    the reference's rules (float-to-int saturates, NaN -> 0)."""
    if src == dst:
        return e
    if dst == "bool":
        return f"({e} != 0)"
    if src == "bool":
        return f"(({_CTYPE[dst]})({e} ? 1 : 0))"
    if _is_float(src) and not _is_float(dst):
        return f"(({_CTYPE[dst]})wg_f2i((float)({e})))"
    return f"(({_CTYPE[dst]})({e}))"


def _literal(o) -> Tuple[str, str]:
    a = np.asarray(o)
    t = _canon(a.dtype)
    if t == "bool":
        return ("true" if bool(a) else "false"), t
    if t == "int32":
        v = literal_int(a)
        return ("(-2147483647 - 1)" if v == -(1 << 31) else f"({v})"), t
    f = np.float32(a.astype(np.float32))
    if np.isfinite(f):
        return f"({float(f).hex()}f)", t
    return f"__int_as_float(0x{int(f.view(np.uint32)):08x})", t


def _promote(a: str, b: str) -> str:
    if a == b:
        return a
    if "float32" in (a, b):
        return "float32"
    return "int32"


_FLOAT_BIN = {"add": "({a} + {b})", "sub": "({a} - {b})",
              "mul": "({a} * {b})", "div": "({a} / {b})",
              "rem": "fmodf({a}, {b})", "min": "wg_fmin({a}, {b})",
              "max": "wg_fmax({a}, {b})", "pow": "powf({a}, {b})"}
_INT_BIN = {"add": "wg_iadd({a}, {b})", "sub": "wg_isub({a}, {b})",
            "mul": "wg_imul({a}, {b})", "div": "wg_idiv({a}, {b})",
            "rem": "wg_irem({a}, {b})", "min": "min({a}, {b})",
            "max": "max({a}, {b})", "pow": "wg_ipow({a}, {b})",
            "and": "({a} & {b})", "or": "({a} | {b})", "xor": "({a} ^ {b})",
            "shl": "wg_shl({a}, {b})", "shr": "wg_shr({a}, {b})"}
_BOOL_BIN = {"and": "({a} && {b})", "or": "({a} || {b})",
             "xor": "({a} != {b})", "min": "({a} && {b})",
             "max": "({a} || {b})"}
_CMP = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}
_FLOAT_UN = {"neg": "(-{a})", "abs": "fabsf({a})", "exp": "expf({a})",
             "log": "logf({a})", "sin": "sinf({a})", "cos": "cosf({a})",
             "tanh": "tanhf({a})", "erf": "erff({a})", "sqrt": "sqrtf({a})",
             "rsqrt": "rsqrtf({a})", "floor": "floorf({a})",
             "ceil": "ceilf({a})", "rint": "rintf({a})"}


# int32 arithmetic whose bounds fit int32 (cuda_mapping.int_ranges) cannot
# wrap; written plainly, nvcc folds and vectorizes the addresses it forms
_NO_WRAP = {**_INT_BIN, "add": "({a} + {b})", "sub": "({a} - {b})",
            "mul": "({a} * {b})"}


def _binexpr(op: str, a: str, b: str, t: str, int_table=None) -> str:
    if op in _CMP:
        return f"({a} {_CMP[op]} {b})"
    table = {"float32": _FLOAT_BIN, "int32": int_table or _INT_BIN,
             "bool": _BOOL_BIN}[t]
    if op not in table:
        raise InvalidArgError(f"cuda target: no {op!r} on {t}")
    return table[op].format(a=a, b=b)


def _unexpr(op: str, a: str, t: str, use_vml: bool = False
            ) -> Tuple[str, str]:
    """(C expression, its dtype) of unary ``op`` on ``a`` of dtype ``t``;
    float math of an integer computes in float32, as jnp does.  With
    ``use_vml``, the ops Vecmathlib serves call ``csrc/vml.cuh``'s
    ``vml_<op>`` in place of CUDA's libm."""
    if op == "not":
        if t == "float32":
            raise InvalidArgError("cuda target: no 'not' on float32")
        return (f"(!{a})" if t == "bool" else f"(~{a})"), t
    if t == "int32" and op in ("neg", "abs"):
        return f"wg_i{op}({a})", t
    if t == "bool":
        raise InvalidArgError(f"cuda target: no {op!r} on bool")
    if t == "int32":
        a, t = f"((float){a})", "float32"
    if use_vml and op in _VML_OPS:
        return f"vml_{_VML_OPS[op]}({a})", t
    return _FLOAT_UN[op].format(a=a), t


# ---------------------------------------------------------------------------
# The emitter
# ---------------------------------------------------------------------------

@dataclass
class _Sig:
    """The kernel's C signature: global buffers and scalar arguments, in
    IR declaration order."""

    globals: List[ir.BufferArg]
    scalars: List[ir.ScalarArg]


class _Emitter:
    def __init__(self, prog: "CudaWGProgram"):
        self.prog = prog
        self.fn = prog.wg.fn
        self.map: CudaMapping = prog.mapping
        self.names = canonical_value_names(self.fn)
        self.bidx = {n: i for i, n in enumerate(self.fn.rpo())}
        vregs: Dict[str, str] = {}
        for blk in self.fn.blocks.values():
            for ins in blk.instrs:
                if ins.op in ("vreg_read", "vreg_write"):
                    vregs[ins.attrs["vreg"]] = ins.attrs["dtype"]
        self.vregs = {n: (f"q{i}", _canon(vregs[n]))
                      for i, n in enumerate(sorted(vregs))}
        self.buf_index = {a.name: i for i, a in
                          enumerate(self.fn.buffer_args)}
        self.locals = [a for a in self.fn.buffer_args if a.space == ir.LOCAL]
        self.local_off: Dict[str, int] = {}
        off = 0
        for a in self.locals:
            self.local_off[a.name] = off
            nbytes = int(a.size) * np.dtype(a.dtype).itemsize
            off += -(-nbytes // 16) * 16
        self.smem_bytes = off

    # -- operands --------------------------------------------------------------
    def vname(self, v: Value) -> str:
        if v.id not in self.names:
            self.names[v.id] = f"v{len(self.names)}"
        return self.names[v.id]

    def opnd(self, o) -> Tuple[str, str]:
        if isinstance(o, Value):
            return self.vname(o), _canon(o.dtype)
        return _literal(o)

    def buf(self, name: str) -> Tuple[str, str, str]:
        """(pointer expression, element count expression, IR dtype)."""
        a = self.fn.buffer_args[self.buf_index[name]]
        i = self.buf_index[name]
        if a.space == ir.LOCAL:
            return f"l{i}", str(int(a.size)), np.dtype(a.dtype).name
        return f"b{i}", f"n{i}", np.dtype(a.dtype).name

    # -- instructions ----------------------------------------------------------
    def instr(self, ins: ir.Instr) -> str:
        op = ins.op
        res = ins.result
        if op == "vreg_read":
            q, _ = self.vregs[ins.attrs["vreg"]]
            return f"{self.vname(res)} = {q};"
        if op == "vreg_write":
            q, qt = self.vregs[ins.attrs["vreg"]]
            e, t = self.opnd(ins.operands[0])
            return f"{q} = {_cvt(e, t, qt)};"
        if op == "store":
            ptr, n, bt = self.buf(ins.attrs["buffer"])
            ie, it = self.opnd(ins.operands[0])
            ve, vt = self.opnd(ins.operands[1])
            val = _cvt(_cvt(ve, vt, _canon(bt)), _canon(bt), bt)
            if self.in_bounds(ins):
                return f"{ptr}[{ie}] = {val};"
            return (f"wg_st<{_CTYPE[bt]}>({ptr}, {n}, "
                    f"(long long){_cvt(ie, it, 'int32')}, {val});")
        if op == "barrier":
            raise AssertionError("barrier inside a parallel region")
        rt = _canon(res.dtype)
        if op == "convert":
            e, t = self.opnd(ins.operands[0])
            expr = _cvt(e, t, rt)
        elif op in ir.BINOPS or op in ir.CMPOPS:
            (ea, ta), (eb, tb) = (self.opnd(o) for o in ins.operands)
            t = _promote(ta, tb) if op in ir.CMPOPS else rt
            table = _NO_WRAP if res.id in self.map.ranges else None
            expr = _binexpr(op, _cvt(ea, ta, t), _cvt(eb, tb, t), t, table)
        elif op in ir.UNOPS:
            e, t = self.opnd(ins.operands[0])
            expr, et = _unexpr(op, e, t, self.prog.use_vml)
            expr = _cvt(expr, et, rt)
        elif op == "select":
            (ec, tc), (ea, ta), (eb, tb) = (self.opnd(o)
                                            for o in ins.operands)
            expr = (f"({_cvt(ec, tc, 'bool')} ? {_cvt(ea, ta, rt)} : "
                    f"{_cvt(eb, tb, rt)})")
        elif op in ir.ID_OPS:
            expr = self.id_op(op, int(ins.attrs["dim"]))
        elif op == "load":
            ptr, n, bt = self.buf(ins.attrs["buffer"])
            ie, it = self.opnd(ins.operands[0])
            ld = f"{ptr}[{ie}]" if self.in_bounds(ins) else \
                (f"wg_ld<{_CTYPE[bt]}>({ptr}, {n}, "
                 f"(long long){_cvt(ie, it, 'int32')})")
            expr = _cvt(ld, bt, rt)
        else:
            raise InvalidArgError(f"cuda target: op {op!r}")
        return f"{self.vname(res)} = {expr};"

    def in_bounds(self, ins: ir.Instr) -> bool:
        """A ``LOCAL`` access whose int32 index provably lies within the
        array: no clamp, no range test."""
        a = self.fn.buffer_args[self.buf_index[ins.attrs["buffer"]]]
        idx = ins.operands[0]
        if a.space != ir.LOCAL or (isinstance(idx, Value)
                                   and _canon(idx.dtype) != "int32"):
            return False
        b = operand_range(self.map.ranges, idx)
        return b is not None and 0 <= b[0] and b[1] < int(a.size)

    def id_op(self, op: str, d: int) -> str:
        lsz = self.prog.lsz
        if op == "local_size":
            return f"({lsz[d]})"
        if op == "num_groups":
            return f"wg_ng{d}"
        if op == "global_size":
            return f"wg_imul({lsz[d]}, wg_ng{d})"
        if op == "local_id":
            return f"wg_lid{d}"
        if op == "group_id":
            return f"wg_gid{d}"
        return f"wg_iadd(wg_imul(wg_gid{d}, {lsz[d]}), wg_lid{d})"

    # -- regions ---------------------------------------------------------------
    def label(self, i: int, b: str) -> str:
        return f"R{i}_b{self.bidx[b]}"

    def region(self, i: int, bar: str) -> List[str]:
        """Region ``i``: its barrier, then its blocks."""
        region = self.prog.wg.regions[bar]
        K, direct = self.prog.K, self.map.direct
        kept = bar in self.map.kept
        out = [f"  // region {i} (after barrier block b{self.bidx[bar]}, "
               f"{barrier_kind(self.fn, bar)}"
               f"{'' if kept or not direct else ', dropped'})"]
        if direct:
            out.append(f"wg_r{i}:;")
            if kept:
                out.append("  __syncthreads();")
        if region.entry is None:
            return out + ["  goto wg_done;" if direct else f"  wg_nx = {K};"]
        rid_of = self.prog.rid_of

        def edge(t) -> str:      # t: a block, or None for Return
            if t is not None and t in region.blocks:
                return f"goto {self.label(i, t)};"
            nx = K if t is None else rid_of[t]
            if direct:
                return "goto wg_done;" if t is None else f"goto wg_r{nx};"
            # work-item 0 decides (paper §4.4)
            return f"{{ wg_nx = {nx}; goto R{i}_end; }}"

        blocks = [region.entry] + sorted(region.blocks - {region.entry},
                                         key=self.bidx.__getitem__)
        for b in blocks:
            blk = self.fn.blocks[b]
            out.append(f"{self.label(i, b)}:;")
            out += ["  " + self.instr(ins) for ins in blk.instrs]
            term = blk.terminator
            if isinstance(term, Jump):
                out.append("  " + edge(term.target))
            elif isinstance(term, CondBranch):
                cnd, ct = self.opnd(term.cond)
                out.append(f"  if ({_cvt(cnd, ct, 'bool')}) "
                           f"{edge(term.if_true)} else "
                           f"{edge(term.if_false)}")
            else:
                assert isinstance(term, Return)
                out.append("  " + edge(None))
        if not direct:
            out.append(f"R{i}_end:;")
        return out

    # -- the whole translation unit ----------------------------------------------
    def signature(self) -> _Sig:
        return _Sig([a for a in self.fn.buffer_args if a.space != ir.LOCAL],
                    list(self.fn.scalar_args))

    def source(self) -> str:
        prog, fn, m = self.prog, self.fn, self.map
        sig = self.signature()
        lsz, K, T = prog.lsz, prog.K, prog.L
        params, call = [], []
        for a in sig.globals:
            i = self.buf_index[a.name]
            ct = _CTYPE[np.dtype(a.dtype).name]
            params.append(f"{ct}* b{i}, long long n{i}")
            call.append(f"({ct}*)b{i}, n{i}")
        for a in sig.scalars:
            t = _canon(a.dtype)
            nm = self.vname(fn.arg_values[a.name])
            params.append(f"{_CTYPE[t]} {nm}")
            call.append(nm)
        grid_params = "int wg_lo, int wg_ng0, int wg_ng1, int wg_ng2"
        kparams = ", ".join(params + [grid_params])

        body = self.schedule()    # names every value before declaring them
        arg_ids = {v.id for v in fn.arg_values.values()}
        decls = []
        seen = set()
        for bname in fn.rpo():
            for ins in fn.blocks[bname].instrs:
                v = ins.result
                if v is not None and v.id not in arg_ids and v.id not in seen:
                    seen.add(v.id)
                    decls.append(f"  {_CTYPE[_canon(v.dtype)]} "
                                 f"{self.vname(v)} = 0;")
        for name, (q, t) in self.vregs.items():
            decls.append(f"  {_CTYPE[t]} {q} = 0;  // vreg {name}")

        n_bars = len(prog.order)
        lines = [
            f"// kernel {fn.name!r}, local size {lsz}: one thread block of "
            f"{T} threads per work-group, one thread per work-item",
            "// region transitions: " + (
                "direct, every successor is work-group uniform" if m.direct
                else "while (switch), work-item 0 decides (paper §4.4)"),
            f"// barriers: {len(m.kept)} of {n_bars} kept as "
            f"__syncthreads()",
            f"// emitted by repro_torch/core/targets/cuda_target.py",
            '#include "wg_runtime.cuh"',
            *(['#include "vml.cuh"'] if prog.use_vml else []),
            "",
            f"extern \"C\" __global__ void __launch_bounds__({T}) "
            f"wg_kernel({kparams}) {{",
            "  extern __shared__ __align__(16) unsigned char wg_smem[];",
        ]
        if not m.direct:
            lines.append("  __shared__ int wg_next[2];")
        lines += [
            "  const int wg_lin = (int)threadIdx.x;",
            "  const int wg_grp = (int)blockIdx.x + wg_lo;",
            f"  const int wg_lid0 = wg_lin % {lsz[0]};",
            f"  const int wg_lid1 = (wg_lin / {lsz[0]}) % {lsz[1]};",
            f"  const int wg_lid2 = wg_lin / {lsz[0] * lsz[1]};",
            "  const int wg_gid0 = wg_grp % wg_ng0;",
            "  const int wg_gid1 = (wg_grp / wg_ng0) % wg_ng1;",
            "  const int wg_gid2 = wg_grp / (wg_ng0 * wg_ng1);",
        ]
        if not m.direct:
            lines.append(f"  int wg_nx = {K};")
        for a in self.locals:
            i = self.buf_index[a.name]
            ct = _CTYPE[np.dtype(a.dtype).name]
            lines.append(f"  {ct}* l{i} = ({ct}*)(wg_smem + "
                         f"{self.local_off[a.name]});  // local {a.name}")
        lines += decls
        if self.smem_bytes:
            lines += [
                "  // LOCAL arrays start zeroed in every work-group",
                f"  for (int i = wg_lin; i < {self.smem_bytes // 4}; "
                f"i += {T}) ((int*)wg_smem)[i] = 0;",
                "  __syncthreads();",
            ]
        lines += body
        if not m.direct:
            lines.append("  (void)wg_nx; (void)wg_next;")
        lines += [
            "}",
            "",
            f"extern \"C\" int wg_launch({', '.join(params)}, "
            f"int wg_lo, int wg_groups, int wg_ng0, int wg_ng1, int wg_ng2, "
            f"int wg_device, void* wg_stream) {{",
            "  if (wg_groups <= 0) return 0;",
            "  cudaError_t e = cudaSetDevice(wg_device);",
            "  if (e != cudaSuccess) return (int)e;",
        ]
        if self.smem_bytes > _STATIC_SMEM:
            lines += [
                "  e = cudaFuncSetAttribute(wg_kernel, "
                "cudaFuncAttributeMaxDynamicSharedMemorySize, "
                f"{self.smem_bytes});",
                "  if (e != cudaSuccess) return (int)e;",
            ]
        lines += [
            f"  wg_kernel<<<wg_groups, {T}, {self.smem_bytes}, "
            f"(cudaStream_t)wg_stream>>>({', '.join(call + ['wg_lo', 'wg_ng0', 'wg_ng1', 'wg_ng2'])});",
            "  return (int)cudaGetLastError();",
            "}",
            "",
            "extern \"C\" const char* wg_error_string(int e) {",
            "  return cudaGetErrorString((cudaError_t)e);",
            "}",
            "",
        ]
        return "\n".join(lines)

    def schedule(self) -> List[str]:
        prog = self.prog
        if self.map.direct:
            out = []
            for i, bar in enumerate(prog.order):
                out += self.region(i, bar)
            return out + ["wg_done:;"]
        out = ["  int wg_rid = 0;", "  int wg_it = 0;",
               f"  while (wg_rid < {prog.K}) {{",
               f"  wg_nx = {prog.K};",
               "  switch (wg_rid) {"]
        for i, bar in enumerate(prog.order):
            out.append(f"  case {i}: {{")
            out += self.region(i, bar)
            out.append("  } break;")
        out += ["  default: break;",
                "  }",
                "  // work-item 0 decides the next region (paper §4.4)",
                "  if (wg_lin == 0) wg_next[wg_it & 1] = wg_nx;",
                "  __syncthreads();",
                "  wg_rid = wg_next[wg_it & 1];",
                "  ++wg_it;",
                "  }"]
        return out


def emit_cuda(prog: "CudaWGProgram") -> Tuple[str, int, _Sig]:
    """(CUDA source, dynamic shared-memory bytes, C signature) of
    ``prog``'s work-group function."""
    em = _Emitter(prog)
    return em.source(), em.smem_bytes, em.signature()


# ---------------------------------------------------------------------------
# Building and loading
# ---------------------------------------------------------------------------

def _lib_path(digest: str) -> Path:
    return BUILD_DIR / f"wg_{digest[:40]}.so"


def build_many(progs: Iterable["CudaWGProgram"]) -> Dict[str, float]:
    """Build every program whose library is not in ``build/repro_torch/``
    yet: one ``nvcc`` per source, all started together
    (:func:`~repro_torch.core.nvcc.build_parallel`).  Returns the
    wall-clock build seconds by digest; raises
    :class:`~repro_torch.core.errors.BuildError` with the compiler's
    output if any build fails."""
    progs = {p.digest: p for p in progs}
    secs = build_parallel(p.nvcc_job() for p in progs.values())
    return {d: secs[_lib_path(d)] for d in progs if _lib_path(d) in secs}


@dataclass(frozen=True)
class _Limits:
    max_threads: int
    smem_optin: int


def device_limits(device: torch.device) -> _Limits:
    """Threads per block and opt-in shared memory per block of a CUDA
    device (``torch.cuda.get_device_properties``; a field this torch does
    not report falls back to the CUDA-wide limit)."""
    props = torch.cuda.get_device_properties(device)
    return _Limits(
        int(getattr(props, "max_threads_per_block", MAX_THREADS)),
        int(getattr(props, "shared_memory_per_block_optin", _STATIC_SMEM)))


class CudaWGProgram(WGProgram):
    """The ``cuda`` target's compiled work-group function.  ``launches``
    counts the kernel launches this program made."""

    def __init__(self, plan, local_size: Sequence[int],
                 horizontal: bool = True, merge_uniform: bool = True,
                 use_vml: bool = False):
        super().__init__(plan, local_size, horizontal=horizontal,
                         merge_uniform=merge_uniform, use_vml=use_vml)
        if self.L > MAX_THREADS:
            raise InvalidArgError(
                f"local size {self.lsz} has {self.L} work-items; a CUDA "
                f"thread block holds at most {MAX_THREADS}")
        self.mapping = map_plan(self.wgplan, self.lsz)
        self.source, self.smem_bytes, self.sig = emit_cuda(self)
        self.local_names = [a.name for a in self.wg.fn.buffer_args
                        if a.space == ir.LOCAL]
        h = hashlib.sha256(self.source.encode())
        for header in HEADERS:
            h.update((CSRC_DIR / header).read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        self.digest = h.hexdigest()
        self.launches = 0
        self._fn = None
        self._err = None

    # the ctypes handles are process-local: a pickled program (the
    # compilation cache's disk tier) reloads its library from build/ by
    # digest at its first launch
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_fn"] = state["_err"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)

    def nvcc_job(self) -> NvccJob:
        """The build of this program's library (for a parallel wave)."""
        return NvccJob(f"{self.wg.fn.name} ({self.digest[:12]})",
                       self.source, _lib_path(self.digest))

    def load(self):
        """The library's launcher, loaded with ``ctypes`` (and built
        first if it is not in ``build/repro_torch/`` yet)."""
        if self._fn is None:
            path = _lib_path(self.digest)
            if not path.exists():
                build_many([self])
            lib = ctypes.CDLL(str(path))
            fn = lib.wg_launch
            fn.restype = ctypes.c_int
            args = []
            for _ in self.sig.globals:
                args += [ctypes.c_void_p, ctypes.c_longlong]
            args += [_CTYPES_ARG[_canon(a.dtype)] for a in self.sig.scalars]
            args += [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.argtypes = args
            err = lib.wg_error_string
            err.restype = ctypes.c_char_p
            err.argtypes = [ctypes.c_int]
            self._fn, self._err = fn, err
        return self._fn

    def launch_ndrange(self, buffers: Dict[str, torch.Tensor],
                       scalars, global_size: Sequence[int],
                       group_range=None) -> Dict[str, torch.Tensor]:
        """Launch the kernel over ``buffers`` (contiguous 1-D CUDA tensors)
        on the current stream, updating them in place.  Returns without
        synchronizing."""
        launch = self.check_launch(buffers, scalars, global_size, group_range)
        dev = launch.device
        if len(launch.locals) != len(self.local_names):
            raise InvalidArgError(
                f"the cuda target keeps LOCAL arrays in shared memory; "
                f"kernel {self.wg.fn.name!r} got "
                f"{sorted(set(self.local_names) - set(launch.locals))} as "
                f"buffers")
        if dev.type != "cuda":
            raise InvalidArgError(
                f"the cuda target launches on CUDA tensors; kernel "
                f"{self.wg.fn.name!r} got tensors on {dev}")
        lim = device_limits(dev)
        if self.L > lim.max_threads:
            raise InvalidArgError(
                f"local size {self.lsz} needs {self.L} threads; the "
                f"device allows {lim.max_threads} per block")
        if self.smem_bytes > lim.smem_optin:
            raise InvalidArgError(
                f"kernel {self.wg.fn.name!r} needs {self.smem_bytes} bytes "
                f"of LOCAL memory; the device allows {lim.smem_optin}")
        groups = launch.hi - launch.lo
        if groups == 0:
            return buffers
        if groups >= 1 << 31:
            raise InvalidArgError(f"{groups} work-groups exceed the grid")
        fn = self.load()
        args: List[object] = []
        for a in self.sig.globals:
            t = buffers[a.name]
            args += [t.data_ptr(), t.numel()]
        for a in self.sig.scalars:
            v = launch.scalars[a.name]
            t = _canon(a.dtype)
            args.append(float(v) if t == "float32" else
                        bool(v) if t == "bool" else int(v))
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, launch.lo, groups, *launch.ngrp, dev.index, stream)
        if rc != 0:
            raise LaunchError(
                f"kernel {self.wg.fn.name!r} launch failed: "
                f"{self._err(rc).decode()} (cudaError {rc})")
        self.launches += 1
        return buffers


__all__ = ["CudaWGProgram", "LaunchError", "build_many", "emit_cuda",
           "device_limits", "BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS"]
