"""Canonical exemplar kernels for the compiler pipeline.

One definition shared by the dump tool (``tools/dump_pipeline.py`` →
docs/compiler.md), the golden-IR snapshot tests
(``tests/test_passes.py`` + ``tests/golden/``), and
``benchmarks/bench_compile.py`` — so the kernel the docs walk through is
*provably* the kernel the goldens pin.  Each builder is deterministic:
calling it twice yields structurally identical CFGs (equal canonical IR).
"""

from __future__ import annotations

from .dsl import KernelBuilder


def build_reduce2():
    """2-wide tree reduction with an in-loop barrier (the paper's
    canonical barrier kernel shape): exercises normalize, §4.5 b-loop
    barriers, out-of-SSA, region formation, and context slots."""
    b = KernelBuilder("reduce2")
    inp = b.arg_buffer("inp", "float32")
    out = b.arg_buffer("out", "float32")
    scratch = b.local_array("scratch", "float32", 2)
    lid, gid, grp = b.local_id(0), b.global_id(0), b.group_id(0)
    scratch[lid] = inp[gid]
    b.barrier()
    s = b.var(b.const(1), name="s")
    with b.while_loop() as loop:
        loop.cond(s.get() > 0)
        with b.if_(lid < s.get()):
            scratch[lid] = scratch[lid] + scratch[lid + s.get()]
        b.barrier()
        s.set(s.get() / 2)
    with b.if_(lid == 0):
        out[grp] = scratch[0]
    return b.finish()


def build_condbar():
    """Loop-free conditional barrier (work-group-uniform condition): the
    §4.3 Algorithm 2 tail-duplication case."""
    b = KernelBuilder("condbar")
    x = b.arg_buffer("x", "float32")
    n = b.arg_scalar("n", "int32")
    gid = b.global_id(0)
    zero = b.const(0)
    with b.if_(n > zero):
        b.barrier()
    x[gid] = x[gid] + 1.0
    return b.finish()


def build_rmsnorm_ew():
    """Elementwise RMSNorm apply (the normalization half of a decode
    step, with ``1/rms`` precomputed on the host): the canonical
    *producer* of a fusible chain — one gid-indexed store, no barriers,
    no loops."""
    b = KernelBuilder("rmsnorm_ew")
    x = b.arg_buffer("x", "float32")
    w = b.arg_buffer("w", "float32")
    y = b.arg_buffer("y", "float32")
    inv_rms = b.arg_scalar("inv_rms", "float32")
    gid = b.global_id(0)
    y[gid] = x[gid] * w[gid] * inv_rms
    return b.finish()


def build_residual_add():
    """Elementwise residual connection ``z = y + r`` — the middle link
    of the rmsnorm→residual→quantize chain (both producer and
    consumer)."""
    b = KernelBuilder("residual_add")
    y = b.arg_buffer("y", "float32")
    r = b.arg_buffer("r", "float32")
    z = b.arg_buffer("z", "float32")
    gid = b.global_id(0)
    z[gid] = y[gid] + r[gid]
    return b.finish()


def build_quantize():
    """Elementwise symmetric int8-style quantization (round-to-nearest
    via ``floor(v*scale + 0.5)``, clamped to ±127, kept in float32 —
    the classic chain *consumer*."""
    b = KernelBuilder("quantize")
    z = b.arg_buffer("z", "float32")
    q = b.arg_buffer("q", "float32")
    scale = b.arg_scalar("scale", "float32")
    gid = b.global_id(0)
    v = b.floor(z[gid] * scale + 0.5)
    q[gid] = b.maximum(-127.0, b.minimum(127.0, v))
    return b.finish()


def build_dct():
    """Uniform-trip-count inner loop (the §4.6/Fig. 9 DCT pattern):
    exercises the horizontal parallelization pass."""
    b = KernelBuilder("dct")
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
