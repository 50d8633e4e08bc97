"""The compiler's conformance kernels, written once for any KernelBuilder.

A copy of the ``CASES`` table of the reference's compiler tests
(``tests/test_core_compiler.py``), with every builder taking the
``KernelBuilder`` class as its argument: ``builder(build_vecadd, KB)``
returns the zero-argument IR builder ``Program`` expects.  The same
source thereby builds the reference package's IR and this package's, so
tests can hold the two compilers against each other, and the card's
smoke run drives the very kernels the tests check.

Each case is ``(build, make_inputs(rng), global_size, local_size,
scalars)``; ``make_inputs`` draws from a numpy ``Generator``.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np


def builder(build: Callable, kb) -> Callable:
    """The zero-argument IR builder of ``build`` over builder class
    ``kb``."""
    return functools.partial(build, kb)


def build_vecadd(KB):
    b = KB("vecadd")
    A, B, C = (b.arg_buffer(n, "float32") for n in "ABC")
    gid = b.global_id(0)
    C[gid] = A[gid] + B[gid]
    return b.finish()


def build_unconditional_barrier(KB):
    b = KB("uncond")
    x = b.arg_buffer("x", "float32")
    tmp = b.local_array("tmp", "float32", 8)
    lid = b.local_id(0)
    tmp[lid] = x[lid] * 2.0
    b.barrier()
    x[lid] = tmp[(lid + 1) % b.local_size(0)]
    return b.finish()


def build_reduction(KB):
    b = KB("reduce")
    inp = b.arg_buffer("inp", "float32")
    out = b.arg_buffer("out", "float32")
    scratch = b.local_array("scratch", "float32", 8)
    lid, gid, grp = b.local_id(0), b.global_id(0), b.group_id(0)
    scratch[lid] = inp[gid]
    b.barrier()
    s = b.var(b.const(4), name="s")
    with b.while_loop() as loop:
        loop.cond(s.get() > 0)
        with b.if_(lid < s.get()):
            scratch[lid] = scratch[lid] + scratch[lid + s.get()]
        b.barrier()
        s.set(s.get() / 2)
    with b.if_(lid == 0):
        out[grp] = scratch[0]
    return b.finish()


def build_conditional_barrier(KB):
    b = KB("condbar")
    x = b.arg_buffer("x", "float32")
    flag = b.arg_scalar("flag", "int32")
    lid = b.local_id(0)
    with b.if_(flag > 0):
        x[lid] = x[lid] * 2.0
        b.barrier()
        t = b.var(x[(lid + 1) % b.local_size(0)], name="t")
        b.barrier()
        x[lid] = x[lid] + t.get()
    x[lid] = x[lid] + 1.0
    return b.finish()


def build_bloop(KB):
    """Barrier inside a kernel loop (paper §4.5 b-loops)."""
    b = KB("bloop")
    x = b.arg_buffer("x", "float32")
    n = b.arg_scalar("n", "int32")
    lid = b.local_id(0)
    i = b.var(b.const(0), name="i")
    with b.while_loop() as loop:
        loop.cond(i.get() < n)
        t = b.var(x[lid] + x[(lid + 1) % b.local_size(0)], name="t")
        b.barrier()
        x[lid] = t.get()
        b.barrier()
        i.set(i.get() + 1)
    return b.finish()


def build_dct_like(KB):
    """Uniform-trip-count inner loop (paper §4.6 / Fig. 9 DCT pattern)."""
    b = KB("dct")
    inp = b.arg_buffer("inp", "float32")
    coef = b.arg_buffer("coef", "float32")
    out = b.arg_buffer("out", "float32")
    width = b.arg_scalar("width", "int32")
    lid = b.local_id(0)
    acc = b.var(0.0, name="acc")
    k = b.var(b.const(0), name="k")
    with b.while_loop() as loop:
        loop.cond(k.get() < width)
        acc.set(acc.get() + coef[k.get()] * inp[lid * width + k.get()])
        k.set(k.get() + 1)
    out[lid] = acc.get()
    return b.finish()


def build_divergent(KB):
    b = KB("div")
    x = b.arg_buffer("x", "float32")
    lid = b.global_id(0)
    acc = b.var(0.0, name="acc")
    i = b.var(b.const(0), name="i")
    with b.while_loop() as loop:
        loop.cond(i.get() < lid)         # work-item-dependent trip count
        acc.set(acc.get() + 1.0)
        i.set(i.get() + 1)
    with b.if_(lid % 2 == 0):
        acc.set(acc.get() * 10.0)
    x[lid] = acc.get()
    return b.finish()


def build_dot_product(KB):
    """The paper's Fig. 1 float4 dot product: each work-item reduces 4
    adjacent lanes (``examples/quickstart.py``)."""
    b = KB("dot_product")
    a_ = b.arg_buffer("a", "float32")
    b_ = b.arg_buffer("b", "float32")
    c_ = b.arg_buffer("c", "float32")
    gid = b.global_id(0)
    acc = b.var(0.0, name="acc")
    i = b.var(b.const(0), name="i")
    with b.while_loop() as loop:
        loop.cond(i.get() < 4)
        acc.set(acc.get() + a_[gid * 4 + i.get()] * b_[gid * 4 + i.get()])
        i.set(i.get() + 1)
    c_[gid] = acc.get()
    return b.finish()


def _normal(rng, n):
    return rng.normal(size=n).astype(np.float32)


CASES = {
    "vecadd": (build_vecadd,
               lambda rng: {"A": _normal(rng, 16), "B": _normal(rng, 16),
                            "C": np.zeros(16, np.float32)},
               (16,), (8,), None),
    "uncond": (build_unconditional_barrier,
               lambda rng: {"x": _normal(rng, 8)},
               (8,), (8,), None),
    "reduce": (build_reduction,
               lambda rng: {"inp": _normal(rng, 16),
                            "out": np.zeros(2, np.float32)},
               (16,), (8,), None),
    "condbar_taken": (build_conditional_barrier,
                      lambda rng: {"x": _normal(rng, 8)},
                      (8,), (8,), {"flag": 1}),
    "condbar_nottaken": (build_conditional_barrier,
                         lambda rng: {"x": _normal(rng, 8)},
                         (8,), (8,), {"flag": 0}),
    "bloop": (build_bloop,
              lambda rng: {"x": _normal(rng, 8)},
              (8,), (8,), {"n": 3}),
    "dct": (build_dct_like,
            lambda rng: {"inp": _normal(rng, 8 * 4),
                         "coef": _normal(rng, 4),
                         "out": np.zeros(8, np.float32)},
            (8,), (8,), {"width": 4}),
    "divergent": (build_divergent,
                  lambda rng: {"x": np.zeros(8, np.float32)},
                  (8,), (8,), None),
}

# the elemental ops Vecmathlib serves when a program is built with
# use_vml=True (paper §5)
VML_OPS = ("exp", "log", "sin", "cos", "tanh", "erf", "sqrt", "rsqrt")


def build_unary(KB, op):
    """``y[g] = op(x[g])``: one elemental op per work-item, the kernel
    that drives a target's ``use_vml=True`` path."""
    b = KB(f"unary_{op}")
    x = b.arg_buffer("x", "float32")
    y = b.arg_buffer("y", "float32")
    g = b.global_id(0)
    y[g] = getattr(b, op)(x[g])
    return b.finish()


_VML_SPECIAL = np.array(
    [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 1e-39, -1e-39,
     1.1754942e-38, 1.17549435e-38, 3.4028235e38, -3.4028235e38,
     88.72, 88.7, -87.3, -87.2, 200.0, -200.0, 9.0, -9.0, 1.0, -1.0, 0.5,
     -0.7853982, -0.7853981, -2.3561945, -3.9269908, -5.497787,
     3e9, -3e9, 1e10, -1e10], np.float32)


def vml_inputs(rng, n: int) -> np.ndarray:
    """``n`` float32 inputs over the vml functions' domains: ±0, ±inf,
    NaN, denormals and the clamp thresholds first, then equal shares of
    [-50, 50] (every quadrant of sin and cos, negative ones included),
    20 · N(0, 1), ±[88, 200] (where exp saturates), log-uniform positive
    values over [1e-37, 1e37] (log, sqrt, rsqrt) and their negatives."""
    k = len(_VML_SPECIAL)
    m = max(n - k, 0)
    q = -(-m // 6)
    mag = np.exp(rng.uniform(np.log(1e-37), np.log(1e37), 2 * q))
    parts = [_VML_SPECIAL,
             rng.uniform(-50.0, 50.0, q),
             rng.standard_normal(q) * 20.0,
             rng.uniform(88.0, 200.0, q) * rng.choice([-1.0, 1.0], q),
             mag, -mag[:q]]
    return np.concatenate(parts).astype(np.float32)[:n]


__all__ = ["CASES", "VML_OPS", "builder", "build_dot_product",
           "build_unary", "vml_inputs"]
