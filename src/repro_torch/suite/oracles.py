"""Input generators and NumPy oracles for the suite kernels.

Every oracle is *bitwise* — the scoreboard and the conformance tests
compare ``tobytes()``, not allclose.  Two conventions make that
well-defined across the loop/vector/pallas targets:

* **FMA-safe data.**  OpenCL (and XLA) may contract ``a*b + c`` into a
  fused multiply-add, which rounds once where NumPy's mul-then-add
  rounds twice.  Rather than forbid the contraction (and measure a
  de-optimized kernel), every multiply-accumulate kernel gets small
  *integer-valued* float32 inputs and dyadic stencil weights, so every
  intermediate is exactly representable and FMA vs mul+add cannot
  differ.  Add-only kernels (scan) keep real-valued data — addition
  order is fixed by the algorithm and reproduced by the oracle.
* **Matched association.**  Each oracle reproduces the kernel's exact
  accumulation order (padded-K tile loop for GEMM, ascending-slot
  predicated loop for SpMV, doubling steps for the scan), not the
  mathematically-equal NumPy one-liner.

Inputs are deterministic per (kernel, shape, params): generators seed
from a stable hash so every sweep configuration of one kernel sees the
same operand values (outputs whose *shape* depends on params, e.g. the
histogram's per-group partials, still differ where they must).
"""

from __future__ import annotations

import zlib

import numpy as np

from typing import Dict, Mapping


def ceil_to(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x``."""
    return -(-int(x) // int(m)) * int(m)


def _rng(name: str, shape: Mapping[str, int]) -> np.random.Generator:
    desc = name + "|" + ",".join(f"{k}={v}" for k, v in sorted(shape.items()))
    return np.random.default_rng(zlib.crc32(desc.encode()))


def _int_f32(rng: np.random.Generator, n: int, lo: int = -4,
             hi: int = 5) -> np.ndarray:
    """Small integer-valued float32 data: exact under FMA contraction."""
    return rng.integers(lo, hi, size=n).astype(np.float32)


# -- tiled GEMM ---------------------------------------------------------------

def gemm_inputs(shape, params) -> Dict[str, np.ndarray]:
    m, n, k = shape["m"], shape["n"], shape["k"]
    rng = _rng("gemm", shape)
    return {"A": _int_f32(rng, m * k), "B": _int_f32(rng, k * n),
            "C": np.zeros(m * n, np.float32)}


def gemm_oracle(inputs, shape, params) -> Dict[str, np.ndarray]:
    """Padded-K accumulation in ascending-k order — the tile loop's exact
    association (each tile contributes its k slots in order; zero-padding
    the ragged last tile adds exact zeros, as the kernel's guarded loads
    do)."""
    m, n, k = shape["m"], shape["n"], shape["k"]
    ts = params["ts"]
    kp = ceil_to(k, ts)
    ap = np.zeros((m, kp), np.float32)
    ap[:, :k] = inputs["A"].reshape(m, k)
    bp = np.zeros((kp, n), np.float32)
    bp[:k, :] = inputs["B"].reshape(k, n)
    acc = np.zeros((m, n), np.float32)
    for kk in range(kp):
        acc = acc + ap[:, kk:kk + 1] * bp[kk:kk + 1, :]
    return {"C": acc.reshape(-1)}


# -- SpMV over CSR ------------------------------------------------------------

def spmv_structure(shape):
    """Deterministic CSR structure: row ``r`` holds ``(r % max_nnz) + 1``
    entries at columns ``(r*3 + j*7) % n`` — ragged rows (every nnz count
    from 1 to max_nnz occurs) without a data-dependent build step."""
    m, n, max_nnz = shape["m"], shape["n"], shape["max_nnz"]
    counts = (np.arange(m) % max_nnz) + 1
    rowptr = np.zeros(m + 1, np.int32)
    rowptr[1:] = np.cumsum(counts)
    cols = np.concatenate(
        [(r * 3 + np.arange(c) * 7) % n for r, c in enumerate(counts)]
    ).astype(np.int32) if m else np.zeros(0, np.int32)
    return rowptr, cols


def spmv_inputs(shape, params) -> Dict[str, np.ndarray]:
    rowptr, cols = spmv_structure(shape)
    rng = _rng("spmv", shape)
    return {"rowptr": rowptr, "cols": cols,
            "vals": _int_f32(rng, len(cols)),
            "x": _int_f32(rng, shape["n"]),
            "y": np.zeros(shape["m"], np.float32)}


def spmv_oracle(inputs, shape, params) -> Dict[str, np.ndarray]:
    """Ascending-slot accumulation with the kernel's clamped-index
    predication: slot j of every row in order, rows vectorized."""
    m, max_nnz = shape["m"], shape["max_nnz"]
    rowptr, cols, vals, x = (inputs["rowptr"], inputs["cols"],
                             inputs["vals"], inputs["x"])
    nnz = np.diff(rowptr)
    last = max(len(vals) - 1, 0)
    acc = np.zeros(m, np.float32)
    for j in range(max_nnz):
        idx = np.minimum(rowptr[:-1] + j, last)
        contrib = vals[idx] * x[cols[idx]]
        acc = np.where(j < nnz, acc + contrib, acc).astype(np.float32)
    return {"y": acc}


# -- 1-D three-point stencil --------------------------------------------------

def stencil1d_inputs(shape, params) -> Dict[str, np.ndarray]:
    rng = _rng("stencil1d", shape)
    n = shape["n"]
    return {"x": _int_f32(rng, n), "y": np.zeros(n, np.float32)}


def stencil1d_oracle(inputs, shape, params) -> Dict[str, np.ndarray]:
    x = inputs["x"]
    left = np.concatenate([x[:1], x[:-1]])
    right = np.concatenate([x[1:], x[-1:]])
    q, h = np.float32(0.25), np.float32(0.5)
    return {"y": ((q * left + h * x) + q * right).astype(np.float32)}


# -- 2-D five-point stencil ---------------------------------------------------

def stencil2d_inputs(shape, params) -> Dict[str, np.ndarray]:
    rng = _rng("stencil2d", shape)
    h, w = shape["h"], shape["w"]
    return {"x": _int_f32(rng, h * w), "y": np.zeros(h * w, np.float32)}


def stencil2d_oracle(inputs, shape, params) -> Dict[str, np.ndarray]:
    h, w = shape["h"], shape["w"]
    a = inputs["x"].reshape(h, w)
    p = np.pad(a, 1, mode="edge")
    left, right = p[1:-1, :-2], p[1:-1, 2:]
    up, down = p[:-2, 1:-1], p[2:, 1:-1]
    res = np.float32(0.5) * a + \
        np.float32(0.125) * ((left + right) + (up + down))
    return {"y": res.astype(np.float32).reshape(-1)}


# -- work-group inclusive prefix scan -----------------------------------------

def scan_inputs(shape, params) -> Dict[str, np.ndarray]:
    rng = _rng("scan", shape)
    n = shape["n"]
    x = rng.standard_normal(n).astype(np.float32)
    return {"x": x, "y": np.zeros(n, np.float32)}


def scan_oracle(inputs, shape, params) -> Dict[str, np.ndarray]:
    """Hillis-Steele doubling steps per segment — NOT cumsum, whose
    left-to-right association differs in float32."""
    seg = shape["seg"]
    a = inputs["x"].reshape(-1, seg).copy()
    off = 1
    while off < seg:
        nxt = a.copy()
        nxt[:, off:] = a[:, off:] + a[:, :-off]
        a = nxt
        off *= 2
    return {"y": a.reshape(-1)}


# -- histogram (privatized, atomics-free) -------------------------------------

def hist_groups(shape, params) -> int:
    return -(-shape["n"] // (params["lsz"] * params["ipt"]))


def hist_inputs(shape, params) -> Dict[str, np.ndarray]:
    rng = _rng("hist", shape)
    n, bins = shape["n"], shape["bins"]
    x = rng.random(n).astype(np.float32)
    return {"x": x,
            "out": np.zeros(hist_groups(shape, params) * bins, np.int32)}


def hist_oracle(inputs, shape, params) -> Dict[str, np.ndarray]:
    """Per-work-group partial histograms (one group's block of
    ``lsz*ipt`` items -> ``bins`` counts); the host sums partials."""
    n, bins = shape["n"], shape["bins"]
    block = params["lsz"] * params["ipt"]
    x = inputs["x"]
    ngrp = hist_groups(shape, params)
    out = np.zeros(ngrp * bins, np.int32)
    for g in range(ngrp):
        blk = x[g * block: min((g + 1) * block, n)]
        b = np.clip((blk * bins).astype(np.int32), 0, bins - 1)
        out[g * bins: (g + 1) * bins] = np.bincount(b, minlength=bins)[:bins]
    return {"out": out}
