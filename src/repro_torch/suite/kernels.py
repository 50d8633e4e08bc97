"""The DSL linear-algebra/irregular kernel suite (docs/scoreboard.md).

Six kernels spanning the workload classes of the paper's evaluation
(§4, Figs. 12-14) and the Rupp-et-al. linear-algebra portability study:

========== ==================================================== ==========
name       pattern                                              tuning axes
========== ==================================================== ==========
gemm       tiled matmul, local-memory A/B tiles + barriers      ts, unroll
spmv       CSR sparse matvec, predicated ragged-row loop        lsz, unroll
stencil1d  3-point stencil, optional local-memory staging       lsz, use_local
stencil2d  5-point stencil, 2-D NDRange                         tx, ty
scan       work-group Hillis-Steele inclusive prefix sum        unroll
hist       privatized histogram + tree reduction (no atomics)   lsz, ipt
========== ==================================================== ==========

Every kernel is authored once in the :class:`~repro.core.KernelBuilder`
DSL and runs unchanged on the loop / vector / pallas targets and under
multi-device co-execution — tuning parameters are *build-time* constants
(tile sizes shape local arrays, unroll factors shape the CFG), so each
swept configuration is a distinct program.

Ragged-edge convention: the runtime requires ``global_size`` to be a
multiple of ``local_size`` (pocl's uniform work-group model), so
:func:`SuiteKernel.launch_dims` pads the global size up and the kernels
guard stores with ``if gid < n`` and clamp *every* potentially
out-of-range load index — ``select`` evaluates both arms, and a clamped
load is safe on all targets (the fiber interpreter would raise on a raw
out-of-bounds index; vector/pallas would silently wrap or clamp).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..core.dsl import KernelBuilder

from typing import Callable, Dict, Mapping, Tuple

from . import oracles
from .oracles import ceil_to

Shape = Mapping[str, int]
Params = Mapping[str, int]


def param_key(params: Params) -> str:
    """Canonical string for one tuning-space point: ``"ts=8,unroll=8"``.
    Sorted so the same dict always names the same sweep column."""
    return ",".join(f"{k}={params[k]}" for k in sorted(params))


@dataclasses.dataclass(frozen=True)
class SuiteKernel:
    """One suite entry: DSL builder + tuning space + bitwise oracle.

    ``build(shape, params)`` returns a zero-arg IR builder suitable for
    ``Context.create_program``; ``make_inputs``/``oracle`` share the
    conventions documented in :mod:`repro.suite.oracles`; ``flops`` /
    ``bytes_moved`` are the *analytic useful* work of one launch (the
    roofline numerator — independent of tuning parameters, which only
    change how the same work is scheduled)."""
    name: str
    description: str
    shapes: Mapping[str, Shape]          # "full" and "ci" problem sizes
    space: Callable[[Shape], Tuple[Params, ...]]
    build: Callable[[Shape, Params], Callable]
    make_inputs: Callable[[Shape, Params], Dict[str, np.ndarray]]
    oracle: Callable[[Dict[str, np.ndarray], Shape, Params],
                     Dict[str, np.ndarray]]
    launch_dims: Callable[[Shape, Params],
                          Tuple[Tuple[int, ...], Tuple[int, ...]]]
    flops: Callable[[Shape], float]
    bytes_moved: Callable[[Shape], float]
    outputs: Tuple[str, ...]


# -- tiled GEMM ---------------------------------------------------------------

def _build_gemm(shape: Shape, params: Params):
    m, n, k = shape["m"], shape["n"], shape["k"]
    ts, unroll = params["ts"], params["unroll"]

    def build():
        b = KernelBuilder(f"suite_gemm_ts{ts}_u{unroll}", ndim=2)
        a_ = b.arg_buffer("A", "float32")
        b_ = b.arg_buffer("B", "float32")
        c_ = b.arg_buffer("C", "float32")
        asub = b.local_tile("As", "float32", (ts, ts))
        bsub = b.local_tile("Bs", "float32", (ts, ts))
        av, bv, cv = b.strided(a_, k), b.strided(b_, n), b.strided(c_, n)
        col, row = b.global_id(0), b.global_id(1)
        lx, ly = b.local_id(0), b.local_id(1)
        acc = b.var(0.0, name="acc")
        with b.for_range(0, ceil_to(k, ts) // ts) as t:
            ka = t * ts + lx
            asub[ly, lx] = b.select(
                (row < m) & (ka < k),
                av[b.minimum(row, m - 1), b.minimum(ka, k - 1)], 0.0)
            kb = t * ts + ly
            bsub[ly, lx] = b.select(
                (kb < k) & (col < n),
                bv[b.minimum(kb, k - 1), b.minimum(col, n - 1)], 0.0)
            b.barrier()
            for kk in b.range_unrolled(ts, unroll):
                acc.set(acc.get() + asub[ly, kk] * bsub[kk, lx])
            b.barrier()
        with b.if_((row < m) & (col < n)):
            cv[b.minimum(row, m - 1), b.minimum(col, n - 1)] = acc.get()
        return b.finish()
    return build


def _gemm_space(shape: Shape):
    return tuple({"ts": ts, "unroll": u}
                 for ts in (4, 8) for u in (1, ts))


def _gemm_dims(shape: Shape, params: Params):
    ts = params["ts"]
    return ((ceil_to(shape["n"], ts), ceil_to(shape["m"], ts)), (ts, ts))


# -- SpMV over CSR ------------------------------------------------------------

def _spmv_nnz(shape: Shape) -> int:
    return int(((np.arange(shape["m"]) % shape["max_nnz"]) + 1).sum())


def _build_spmv(shape: Shape, params: Params):
    m, n, max_nnz = shape["m"], shape["n"], shape["max_nnz"]
    unroll = params["unroll"]
    nnz_total = _spmv_nnz(shape)

    def build():
        b = KernelBuilder(f"suite_spmv_l{params['lsz']}_u{unroll}")
        rowptr = b.arg_buffer("rowptr", "int32")
        cols = b.arg_buffer("cols", "int32")
        vals = b.arg_buffer("vals", "float32")
        x = b.arg_buffer("x", "float32")
        y = b.arg_buffer("y", "float32")
        r = b.global_id(0)
        rc = b.minimum(r, m - 1)
        start, end = rowptr[rc], rowptr[rc + 1]
        acc = b.var(0.0, name="acc")
        # uniform trip count over the max row length with predication:
        # ragged rows cost a select, not a divergent loop
        for j in b.range_unrolled(max_nnz, unroll):
            idx = b.minimum(start + j, nnz_total - 1)
            contrib = vals[idx] * x[b.minimum(cols[idx], n - 1)]
            acc.set(acc.get() + b.select(start + j < end, contrib, 0.0))
        with b.if_(r < m):
            y[rc] = acc.get()
        return b.finish()
    return build


def _spmv_space(shape: Shape):
    return tuple({"lsz": lsz, "unroll": u}
                 for lsz in (32, 64) for u in (1, shape["max_nnz"]))


def _spmv_dims(shape: Shape, params: Params):
    return ((ceil_to(shape["m"], params["lsz"]),), (params["lsz"],))


# -- 1-D three-point stencil --------------------------------------------------

def _build_stencil1d(shape: Shape, params: Params):
    n = shape["n"]
    lsz, use_local = params["lsz"], params["use_local"]

    def build():
        b = KernelBuilder(f"suite_stencil1d_l{lsz}_s{use_local}")
        x = b.arg_buffer("x", "float32")
        y = b.arg_buffer("y", "float32")
        gid = b.global_id(0)
        if use_local:
            tile = b.local_array("tile", "float32", lsz + 2)
            lid = b.local_id(0)
            tile[lid + 1] = x[b.minimum(gid, n - 1)]
            with b.if_(lid < 1):
                tile[0] = x[b.minimum(b.maximum(gid - 1, 0), n - 1)]
            with b.if_(lid >= lsz - 1):
                tile[lsz + 1] = x[b.minimum(gid + 1, n - 1)]
            b.barrier()
            left, center, right = tile[lid], tile[lid + 1], tile[lid + 2]
        else:
            center = x[b.minimum(gid, n - 1)]
            left = x[b.minimum(b.maximum(gid - 1, 0), n - 1)]
            right = x[b.minimum(gid + 1, n - 1)]
        with b.if_(gid < n):
            y[b.minimum(gid, n - 1)] = \
                (0.25 * left + 0.5 * center) + 0.25 * right
        return b.finish()
    return build


def _stencil1d_space(shape: Shape):
    return tuple({"lsz": lsz, "use_local": s}
                 for lsz in (32, 64) for s in (0, 1))


def _stencil1d_dims(shape: Shape, params: Params):
    return ((ceil_to(shape["n"], params["lsz"]),), (params["lsz"],))


# -- 2-D five-point stencil ---------------------------------------------------

def _build_stencil2d(shape: Shape, params: Params):
    h, w = shape["h"], shape["w"]
    tx, ty = params["tx"], params["ty"]

    def build():
        b = KernelBuilder(f"suite_stencil2d_t{tx}x{ty}", ndim=2)
        x = b.arg_buffer("x", "float32")
        y = b.arg_buffer("y", "float32")
        xv, yv = b.strided(x, w), b.strided(y, w)
        gx, gy = b.global_id(0), b.global_id(1)
        cx, cy = b.minimum(gx, w - 1), b.minimum(gy, h - 1)
        left = xv[cy, b.minimum(b.maximum(gx - 1, 0), w - 1)]
        right = xv[cy, b.minimum(gx + 1, w - 1)]
        up = xv[b.minimum(b.maximum(gy - 1, 0), h - 1), cx]
        down = xv[b.minimum(gy + 1, h - 1), cx]
        center = xv[cy, cx]
        with b.if_((gx < w) & (gy < h)):
            yv[cy, cx] = 0.5 * center + \
                0.125 * ((left + right) + (up + down))
        return b.finish()
    return build


def _stencil2d_space(shape: Shape):
    return ({"tx": 8, "ty": 8}, {"tx": 16, "ty": 4}, {"tx": 4, "ty": 16})


def _stencil2d_dims(shape: Shape, params: Params):
    tx, ty = params["tx"], params["ty"]
    return ((ceil_to(shape["w"], tx), ceil_to(shape["h"], ty)), (tx, ty))


# -- work-group inclusive prefix scan -----------------------------------------

def _build_scan(shape: Shape, params: Params):
    seg = shape["seg"]
    unroll = params["unroll"]

    def build():
        b = KernelBuilder(f"suite_scan_s{seg}_u{unroll}")
        x = b.arg_buffer("x", "float32")
        y = b.arg_buffer("y", "float32")
        # ping-pong halves of one local buffer: Hillis-Steele reads the
        # previous round while writing the next, no second barrier needed
        buf = b.local_array("buf", "float32", 2 * seg)
        lid, gid = b.local_id(0), b.global_id(0)
        buf[lid] = x[gid]
        b.barrier()
        if unroll:
            pin, pout, off = 0, 1, 1
            while off < seg:
                with b.if_(lid >= off):
                    buf[pout * seg + lid] = \
                        buf[pin * seg + lid] + buf[pin * seg + lid - off]
                with b.if_(lid < off):
                    buf[pout * seg + lid] = buf[pin * seg + lid]
                b.barrier()
                pin, pout = pout, pin
                off *= 2
            y[gid] = buf[pin * seg + lid]
        else:
            pin = b.var(b.const(0), name="pin")
            off = b.var(b.const(1), name="off")
            with b.while_loop() as loop:
                loop.cond(off.get() < seg)
                pout = 1 - pin.get()
                with b.if_(lid >= off.get()):
                    buf[pout * seg + lid] = buf[pin.get() * seg + lid] + \
                        buf[pin.get() * seg + lid - off.get()]
                with b.if_(lid < off.get()):
                    buf[pout * seg + lid] = buf[pin.get() * seg + lid]
                b.barrier()
                pin.set(pout)
                off.set(off.get() * 2)
            y[gid] = buf[pin.get() * seg + lid]
        return b.finish()
    return build


def _scan_space(shape: Shape):
    return ({"unroll": 0}, {"unroll": 1})


def _scan_dims(shape: Shape, params: Params):
    return ((shape["n"],), (shape["seg"],))


# -- histogram ----------------------------------------------------------------

def _build_hist(shape: Shape, params: Params):
    n, bins = shape["n"], shape["bins"]
    lsz, ipt = params["lsz"], params["ipt"]

    def build():
        b = KernelBuilder(f"suite_hist_l{lsz}_i{ipt}")
        x = b.arg_buffer("x", "float32")
        out = b.arg_buffer("out", "int32")
        # per-work-item privatized counts: no atomics on any target
        priv = b.local_array("priv", "int32", lsz * bins)
        lid, grp = b.local_id(0), b.group_id(0)
        for t in range(bins):
            priv[lid * bins + t] = 0
        base = grp * (lsz * ipt)
        for t in range(ipt):
            i = base + t * lsz + lid
            with b.if_(i < n):
                v = x[b.minimum(i, n - 1)]
                slot = b.maximum(
                    b.minimum((v * float(bins)).astype("int32"), bins - 1),
                    0)
                priv[lid * bins + slot] = priv[lid * bins + slot] + 1
        b.barrier()
        s = b.var(b.const(lsz // 2), name="s")
        with b.while_loop() as loop:
            loop.cond(s.get() > 0)
            with b.if_(lid < s.get()):
                for t in range(bins):
                    priv[lid * bins + t] = priv[lid * bins + t] + \
                        priv[(lid + s.get()) * bins + t]
            b.barrier()
            s.set(s.get() / 2)
        with b.if_(lid < bins):
            out[grp * bins + lid] = priv[lid]
        return b.finish()
    return build


def _hist_space(shape: Shape):
    # lsz must be a power of two (tree reduction) and >= bins (store)
    return tuple({"lsz": lsz, "ipt": ipt}
                 for lsz in (16, 32) for ipt in (1, 4))


def _hist_dims(shape: Shape, params: Params):
    return ((oracles.hist_groups(shape, params) * params["lsz"],),
            (params["lsz"],))


# -- registry -----------------------------------------------------------------

SUITE: Dict[str, SuiteKernel] = {k.name: k for k in (
    SuiteKernel(
        name="gemm",
        description="tiled dense matmul, local-memory tiles + barriers",
        shapes={"full": {"m": 45, "n": 48, "k": 40},
                "ci": {"m": 13, "n": 17, "k": 9}},
        space=_gemm_space, build=_build_gemm,
        make_inputs=oracles.gemm_inputs, oracle=oracles.gemm_oracle,
        launch_dims=_gemm_dims,
        flops=lambda s: 2.0 * s["m"] * s["n"] * s["k"],
        bytes_moved=lambda s: 4.0 * (s["m"] * s["k"] + s["k"] * s["n"]
                                     + s["m"] * s["n"]),
        outputs=("C",)),
    SuiteKernel(
        name="spmv",
        description="CSR sparse matvec, predicated ragged-row loop",
        shapes={"full": {"m": 300, "n": 256, "max_nnz": 8},
                "ci": {"m": 70, "n": 64, "max_nnz": 4}},
        space=_spmv_space, build=_build_spmv,
        make_inputs=oracles.spmv_inputs, oracle=oracles.spmv_oracle,
        launch_dims=_spmv_dims,
        flops=lambda s: 2.0 * _spmv_nnz(s),
        bytes_moved=lambda s: 4.0 * (2 * _spmv_nnz(s) + s["m"] + 1
                                     + s["n"] + s["m"]),
        outputs=("y",)),
    SuiteKernel(
        name="stencil1d",
        description="3-point stencil, optional local-memory staging",
        shapes={"full": {"n": 4000}, "ci": {"n": 150}},
        space=_stencil1d_space, build=_build_stencil1d,
        make_inputs=oracles.stencil1d_inputs,
        oracle=oracles.stencil1d_oracle,
        launch_dims=_stencil1d_dims,
        flops=lambda s: 5.0 * s["n"],
        bytes_moved=lambda s: 8.0 * s["n"],
        outputs=("y",)),
    SuiteKernel(
        name="stencil2d",
        description="5-point stencil over a 2-D NDRange",
        shapes={"full": {"h": 60, "w": 76}, "ci": {"h": 13, "w": 19}},
        space=_stencil2d_space, build=_build_stencil2d,
        make_inputs=oracles.stencil2d_inputs,
        oracle=oracles.stencil2d_oracle,
        launch_dims=_stencil2d_dims,
        flops=lambda s: 6.0 * s["h"] * s["w"],
        bytes_moved=lambda s: 8.0 * s["h"] * s["w"],
        outputs=("y",)),
    SuiteKernel(
        name="scan",
        description="work-group Hillis-Steele inclusive prefix sum",
        shapes={"full": {"n": 4096, "seg": 64},
                "ci": {"n": 256, "seg": 32}},
        space=_scan_space, build=_build_scan,
        make_inputs=oracles.scan_inputs, oracle=oracles.scan_oracle,
        launch_dims=_scan_dims,
        flops=lambda s: float(s["n"]) * max(math.log2(s["seg"]), 1.0),
        bytes_moved=lambda s: 8.0 * s["n"],
        outputs=("y",)),
    SuiteKernel(
        name="hist",
        description="privatized histogram + tree reduction, no atomics",
        shapes={"full": {"n": 5000, "bins": 16},
                "ci": {"n": 300, "bins": 8}},
        space=_hist_space, build=_build_hist,
        make_inputs=oracles.hist_inputs, oracle=oracles.hist_oracle,
        launch_dims=_hist_dims,
        flops=lambda s: 4.0 * s["n"],
        bytes_moved=lambda s: 4.0 * s["n"] + 4.0 * s["bins"],
        outputs=("out",)),
)}


def suite_kernels() -> Tuple[SuiteKernel, ...]:
    """All suite kernels in registry order."""
    return tuple(SUITE.values())
