"""The ``cuda`` target's emitted source, run on the CPU.

Each kernel's emitted CUDA is compiled with ``g++ -std=c++20`` against a
stand-in for the CUDA runtime (``tests/cuda_standin/cuda_runtime.h``: one
``std::thread`` per CUDA thread, one block at a time, the threads taking
turns between barriers in thread order) and launched through ``ctypes``.
Every compiler case (both horizontal settings), every suite kernel at its
``ci`` shape in every configuration, and the kernels below that give the
mapping's other choices work (256-work-item and 2-D groups, a loop with
a barrier in both schedules, a race across an implicit barrier, LOCAL
accesses with and without proven bounds), and the rmsnorm -> residual ->
quantize chain as the queue's fusion rewrite stitches it, are held
bitwise against the
port's ``vector`` target on the same inputs: the arithmetic is IEEE single precision with no contraction on
both sides (``-ffp-contract=off``, as ``-fmad=false`` on the card).  A
barrier deleted from the source must fail the same check.

Skips without ``g++``.  The builds run in parallel, one ``g++`` each.
"""

import ctypes
import os
import re
import shutil
import subprocess
import time

import numpy as np
import pytest
import torch

from repro_torch.core import KernelBuilder
from repro_torch.core.api import _compile_kernel
from repro_torch.core.cases import CASES, builder
from repro_torch.core.examples import (build_quantize, build_reduce2,
                                       build_residual_add, build_rmsnorm_ew)
from repro_torch.core.fusion import ChainEdge, stitch_functions
from repro_torch.core.nvcc import CSRC_DIR
from repro_torch.core.targets.cuda_mapping import barrier_kind
from repro_torch.suite import SUITE

STANDIN = os.path.join(os.path.dirname(__file__), "cuda_standin")
GXX = shutil.which("g++")
GXX_FLAGS = ["-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
             "-pthread", "-w", "-I", STANDIN, "-I", str(CSRC_DIR)]
_CT = {"float32": ctypes.c_float, "int32": ctypes.c_int,
       "bool": ctypes.c_bool}


# ---------------------------------------------------------------------------
# kernels that give the mapping's other choices work
# ---------------------------------------------------------------------------

def build_race(KB):
    """Each step reads the neighbour's value of the step before and writes
    its own into the other half of ``buf``: a uniform loop with no barrier,
    which the horizontal pass runs in lockstep (§4.6).  The ``cuda`` target
    must keep one of its implicit barriers."""
    b = KB("race")
    x = b.arg_buffer("x", "float32")
    n = b.arg_scalar("n", "int32")
    buf = b.local_array("buf", "float32", 2 * 64)
    lid, gid = b.local_id(0), b.global_id(0)
    buf[lid] = x[gid]
    b.barrier()
    i = b.var(b.const(0), name="i")
    with b.while_loop() as loop:
        loop.cond(i.get() < n)
        src = (i.get() % 2) * 64
        buf[(64 - src) + lid] = buf[src + (lid + 1) % 64] * 2.0 + 1.0
        i.set(i.get() + 1)
    x[gid] = buf[(n % 2) * 64 + lid]
    return b.finish()


def build_tile256(KB):
    """256 work-items: a LOCAL tile read back at indices uniform across
    the group and at each work-item's own, under a divergent branch, and
    in a uniform inner loop (a region loop without the horizontal pass, a
    b-loop with it)."""
    b = KB("tile256")
    x = b.arg_buffer("x", "float32")
    y = b.arg_buffer("y", "float32")
    k = b.arg_scalar("k", "int32")
    tile = b.local_array("tile", "float32", 256)
    lid, gid, grp = b.local_id(0), b.global_id(0), b.group_id(0)
    tile[lid] = x[gid]
    b.barrier()
    acc = b.var(tile[grp % 7] * 2.0, name="acc")
    with b.if_(lid % 3 == 0):
        acc.set(acc.get() + tile[255 - lid])
    j = b.var(b.const(0), name="j")
    with b.while_loop() as loop:
        loop.cond(j.get() < k)
        acc.set(acc.get() + tile[(j.get() * 5) % 256] * tile[(lid + j.get())
                                                              % 256])
        j.set(j.get() + 1)
    b.barrier()
    tile[lid] = acc.get()
    b.barrier()
    y[gid] = tile[(lid + 1) % 256] - tile[3]
    return b.finish()


def build_rows(KB):
    """A 2-D group of 64 x 4: a row sum over a LOCAL tile whose row index
    comes from dimension 1."""
    b = KB("rows", ndim=2)
    x = b.arg_buffer("x", "float32")
    y = b.arg_buffer("y", "float32")
    tile = b.local_array("tile", "float32", 64 * 4)
    lx, ly = b.local_id(0), b.local_id(1)
    gx, gy = b.global_id(0), b.global_id(1)
    row = gy * b.global_size(0)
    tile[ly * 64 + lx] = x[row + gx]
    b.barrier()
    s = b.var(0.0, name="s")
    for t in range(4):
        s.set(s.get() + tile[((ly + t) % 4) * 64] * tile[ly * 64 + lx])
    y[row + gx] = s.get()
    return b.finish()


def build_loop256(KB):
    """256 work-items round a loop with a barrier, whose body is a region
    of its own; without the horizontal pass nothing proves the loop's
    exit uniform, so the kernel keeps the ``while (switch)`` schedule."""
    b = KB("loop256")
    x = b.arg_buffer("x", "float32")
    y = b.arg_buffer("y", "float32")
    n = b.arg_scalar("n", "int32")
    a = b.local_array("a", "float32", 256)
    acc = b.local_array("acc", "float32", 256)
    lid, gid = b.local_id(0), b.global_id(0)
    a[lid] = x[gid]
    b.barrier()
    i = b.var(b.const(0), name="i")
    with b.while_loop() as loop:
        loop.cond(i.get() < n)
        acc[lid] = acc[lid] + a[(i.get() * 7) % 256] * a[(lid + i.get())
                                                          % 256]
        b.barrier()
        i.set(i.get() + 1)
    y[gid] = acc[(lid + 3) % 256]
    return b.finish()


def build_bounds(KB):
    """LOCAL accesses inside their array (no clamp needed) and outside it
    (clamped loads, dropped and wrapped stores) side by side."""
    b = KB("bounds")
    x = b.arg_buffer("x", "float32")
    y = b.arg_buffer("y", "float32")
    t = b.local_array("t", "float32", 16)
    u = b.local_array("u", "float32", 16)
    lid, gid = b.local_id(0), b.global_id(0)
    t[lid] = x[gid]
    u[lid * 2 - 20] = x[gid] + 1.0      # -20..10: wraps, stores, drops
    b.barrier()
    y[gid] = t[(lid * 7) % 16] + t[lid * 3 - 8] * 2.0 + u[lid + 9]
    return b.finish()


def build_fused_chain():
    """The rmsnorm -> residual -> quantize chain stitched as the queue's
    fusion rewrite stitches it, both intermediates elided."""
    fn, _, _ = stitch_functions(
        [build_rmsnorm_ew(), build_residual_add(), build_quantize()],
        [ChainEdge(0, 1, "y", "y", True), ChainEdge(1, 2, "z", "z", True)],
        [[(0, "y"), (1, "y")], [(1, "z"), (2, "z")]])
    return fn


def _normal(rng, n):
    return rng.standard_normal(n).astype(np.float32)


def _ints(rng, n):
    return rng.integers(-8, 8, size=n).astype(np.float32)


GEMM_SHAPE = {"m": 20, "n": 33, "k": 40}

# name -> (build, make_inputs(rng), global size, local size, scalars, hz)
EXTRA = {
    "race": (builder(build_race, KernelBuilder),
             lambda rng: {"x": _ints(rng, 128)}, (128,), (64,), {"n": 5},
             True),
    **{f"tile256-hz{int(hz)}": (builder(build_tile256, KernelBuilder),
                                lambda rng: {"x": _ints(rng, 512),
                                             "y": np.zeros(512, np.float32)},
                                (512,), (256,), {"k": 6}, hz)
       for hz in (True, False)},
    "rows": (builder(build_rows, KernelBuilder),
             lambda rng: {"x": _ints(rng, 128 * 8),
                          "y": np.zeros(128 * 8, np.float32)},
             (128, 8), (64, 4), None, True),
    **{f"loop256-hz{int(hz)}": (builder(build_loop256, KernelBuilder),
                                lambda rng: {"x": _ints(rng, 512),
                                             "y": np.zeros(512, np.float32)},
                                (512,), (256,), {"n": 5}, hz)
       for hz in (True, False)},
    **{f"gemm-ts16-u{u}-hz{int(hz)}": (
        SUITE["gemm"].build(GEMM_SHAPE, {"ts": 16, "unroll": u}),
        lambda rng: SUITE["gemm"].make_inputs(GEMM_SHAPE,
                                              {"ts": 16, "unroll": 16}),
        *SUITE["gemm"].launch_dims(GEMM_SHAPE, {"ts": 16, "unroll": u}),
        None, hz)
       for u, hz in ((16, True), (16, False), (1, True))},
    "bounds": (builder(build_bounds, KernelBuilder),
               lambda rng: {"x": _ints(rng, 32),
                            "y": np.zeros(32, np.float32)},
               (32,), (16,), None, True),
    "fused-chain": (build_fused_chain,
                    lambda rng: {"k0_x": _normal(rng, 1024),
                                 "k0_w": _normal(rng, 1024),
                                 "k1_r": _normal(rng, 1024),
                                 "k2_q": np.zeros(1024, np.float32)},
                    (1024,), (256,), {"k0_inv_rms": 0.75, "k2_scale": 16.0},
                    True),
    "reduce2": (build_reduce2,
                lambda rng: {"inp": _ints(rng, 8),
                             "out": np.zeros(4, np.float32)},
                (8,), (2,), None, True),
}


def all_runs():
    for case, (build, mk, gsz, lsz, sc) in sorted(CASES.items()):
        for hz in (True, False):
            seed = sorted(CASES).index(case)
            yield (f"case-{case}-hz{int(hz)}", builder(build, KernelBuilder),
                   lambda mk=mk, seed=seed: mk(np.random.default_rng(seed)),
                   gsz, lsz, sc, hz)
    for name in sorted(SUITE):
        sk = SUITE[name]
        shape = sk.shapes["ci"]
        for params in sk.space(shape):
            gsz, lsz = sk.launch_dims(shape, params)
            yield (f"{name}-ci-" + ",".join(
                f"{k}={v}" for k, v in sorted(params.items())),
                sk.build(shape, params),
                lambda sk=sk, shape=shape, params=params:
                sk.make_inputs(shape, params), gsz, lsz, None, True)
    for seed, (name, (build, mk, gsz, lsz, sc, hz)) in \
            enumerate(sorted(EXTRA.items())):
        yield (name, build, lambda mk=mk, seed=seed:
               mk(np.random.default_rng(100 + seed)), gsz, lsz, sc, hz)


RUNS = {r[0]: r for r in all_runs()}


# ---------------------------------------------------------------------------
# building and launching
# ---------------------------------------------------------------------------

def standin_source(src: str) -> str:
    """The emitted source as the stand-in compiles it: dynamic shared
    memory from the stand-in, and the ``<<<>>>`` launch as a call."""
    src = src.replace(
        "extern __shared__ __align__(16) unsigned char wg_smem[];",
        "unsigned char* const wg_smem = wg_standin::smem();")
    src, n = re.subn(
        r"(\w+)<<<([^,]+), ([^,]+), ([^,]+), [^>]*>>>\((.*)\);",
        r"wg_standin::launch(\2, \3, \4, [&] { \1(\5); });", src)
    assert n == 1, "no kernel launch found in the emitted source"
    return src


def build_all(sources: dict, out_dir) -> dict:
    """Compile every source at once (at most one ``g++`` per core);
    returns name -> library path, or raises with the compiler's output."""
    pending = list(sources.items())
    running, libs, errors = [], {}, []
    width = max(1, os.cpu_count() or 1)
    while pending or running:
        while pending and len(running) < width:
            name, src = pending.pop()
            stem = re.sub(r"[^\w.-]", "_", name)
            cpp = os.path.join(out_dir, f"{stem}.cpp")
            lib = os.path.join(out_dir, f"{stem}.so")
            with open(cpp, "w") as f:
                f.write(standin_source(src))
            proc = subprocess.Popen([GXX, *GXX_FLAGS, "-o", lib, cpp],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            running.append((name, lib, proc))
        for r in list(running):
            name, lib, proc = r
            if proc.poll() is None:
                continue
            running.remove(r)
            text = proc.stdout.read()
            if proc.returncode:
                errors.append(f"--- {name}\n{text[:3000]}")
            else:
                libs[name] = lib
        time.sleep(0.01)
    assert not errors, "\n".join(errors)
    return libs


def cuda_prog(build, lsz, hz):
    return _compile_kernel(build, lsz, target="cuda", horizontal=hz,
                           cache=False).prog


def launch_standin(lib_path, prog, bufs, gsz, scalars):
    """Run the library on copies of ``bufs``; returns (rc, outputs)."""
    lib = ctypes.CDLL(lib_path)
    fn = lib.wg_launch
    fn.restype = ctypes.c_int
    argtypes, args = [], []
    out = {n: np.array(v, copy=True) for n, v in bufs.items()}
    for a in prog.sig.globals:
        argtypes += [ctypes.c_void_p, ctypes.c_longlong]
        args += [out[a.name].ctypes.data, out[a.name].size]
    for a in prog.sig.scalars:
        t = np.dtype(a.dtype).name
        t = {"float64": "float32", "int64": "int32"}.get(t, t)
        argtypes.append(_CT[t])
        args.append((scalars or {})[a.name])
    argtypes += [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.argtypes = argtypes
    gsz3 = tuple(gsz) + (1,) * (3 - len(gsz))
    ngrp = [g // l for g, l in zip(gsz3, prog.lsz)]
    rc = fn(*args, 0, int(np.prod(ngrp)), *ngrp, 0, None)
    return rc, out


def vector_result(build, lsz, hz, bufs, gsz, scalars):
    k = _compile_kernel(build, lsz, target="vector", horizontal=hz)
    got = k({n: v.copy() for n, v in bufs.items()}, gsz, scalars)
    return {n: t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
            for n, t in got.items()}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    if GXX is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("cuda_emit")
    progs = {name: cuda_prog(build, lsz, hz)
             for name, build, mk, gsz, lsz, sc, hz in RUNS.values()}
    sources = {name: p.source for name, p in progs.items()}
    for name, bar in FAULTS.items():
        sources[f"fault-{name}"] = drop_barrier(progs[name].source, bar)
    return progs, build_all(sources, str(out))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def check(built, name, lib_name=None):
    progs, libs = built
    _, build, mk, gsz, lsz, sc, hz = RUNS[name]
    bufs = mk()
    prog = progs[name]
    rc, got = launch_standin(libs[lib_name or name], prog, bufs, gsz, sc)
    want = vector_result(build, lsz, hz, bufs, gsz, sc)
    return rc, got, want


@pytest.mark.parametrize("name", sorted(RUNS))
def test_emitted_kernel_matches_vector_target(built, name):
    rc, got, want = check(built, name)
    assert rc == 0, f"{name}: the stand-in launch failed ({rc})"
    for n, w in want.items():
        assert got[n].tobytes() == w.tobytes(), f"{name}: {n} not bitwise"


def test_the_extra_kernels_take_the_paths_they_are_for(built):
    progs, _ = built
    m = {n: progs[n].mapping for n in EXTRA}
    assert m["tile256-hz1"].direct and m["rows"].direct
    assert m["loop256-hz1"].direct and not m["loop256-hz0"].direct
    assert m["gemm-ts16-u16-hz1"].direct and not m["gemm-ts16-u16-hz0"].direct
    race = progs["race"]
    kinds = sorted(barrier_kind(race.wg.fn, b) for b in race.mapping.kept)
    assert race.mapping.direct and kinds == ["bloop-header", "explicit"]


def drop_barrier(src: str, which: int) -> str:
    """``src`` with its ``which``-th ``__syncthreads();`` deleted."""
    at = [m.start() for m in re.finditer(r"__syncthreads\(\);", src)]
    i = at[which]
    return src[:i] + "/* deleted barrier */" + src[i + len("__syncthreads();"):]


# kernel -> which __syncthreads() of its source to delete: the scan's
# barrier between rounds (the last), reduce2's after the first stores
# (the second; the first follows the zeroing)
FAULTS = {"scan-ci-unroll=0": -1, "reduce2": 1}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_a_deleted_barrier_fails(built, name):
    progs, _ = built
    assert progs[name].mapping.direct
    rc, got, want = check(built, name)
    assert rc == 0 and all(got[n].tobytes() == w.tobytes()
                           for n, w in want.items())
    rc, got, want = check(built, name, f"fault-{name}")
    same = rc == 0 and all(got[n].tobytes() == w.tobytes()
                           for n, w in want.items())
    assert not same, f"{name} still matches with a barrier deleted"
