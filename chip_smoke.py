#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``src/repro_torch``) on one card.

Drives the kernel compiler's launch path — KernelBuilder DSL -> IR ->
PassManager -> WorkGroupPlan -> the hand-written ``cuda`` work-group
target -> Context / Program / Kernel launch — and checks every result.
Each phase prints one JSON line; any mismatch, build error or launch
error raises and the script exits non-zero.

  1. device: the card, torch/CUDA versions, and one parallel ``nvcc``
     build of every kernel the run launches (seconds per kernel);
  2. quickstart (main path): the paper's Fig. 1 dot product at 1<<22
     work-items through Context -> Program -> Kernel -> launch, against
     numpy (``rtol=1e-5, atol=2e-6``, the quickstart's tolerance) and
     bitwise against the ``vector`` target, and at 256 work-items
     against the fiber oracle;
  3. compiler cases: every case of ``repro_torch.core.cases`` with and
     without the horizontal pass, ``cuda`` against the torch ``vector``
     target (its plain version) on the card, bitwise where the data is
     integer-valued and at ``rtol=1e-5, atol=1e-6`` otherwise;
  4. suite at ``full`` shapes, every tuning configuration: ``cuda``
     bitwise against the ``vector`` target and the numpy oracle;
  5. suite at real sizes (main path): bitwise against the oracle and
     the ``vector`` target, then timed with CUDA events (median of 20
     launches, L2 flushed before each) beside the plain version's time
     (median of 3), the bound and, where one PyTorch call computes the
     same function, that call's time;
  6. the kernels line, then the card's name and power limit, then the
     result line.

Launch counts are set to 0 just before each main-path phase and read
just after it; launches made to compare a kernel with its plain version
do not count.

  python3 chip_smoke.py          # from the repository root, one card
"""

import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

PEAK_FP32_FLOPS = 67e12      # H100 SXM, FP32 on CUDA cores (data sheet)
PEAK_HBM_BYTES = 3.35e12     # H100 SXM HBM3 bytes/s (data sheet)
KERNEL_SOURCE = "src/repro_torch/core/targets/cuda_target.py"
REPLACES = "src/repro/core/targets/pallas_target.py:36"

# phase 5: real problem sizes and the configuration each runs with
REAL = [
    ("gemm", {"m": 2048, "n": 2048, "k": 2048}, {"ts": 16, "unroll": 16}),
    ("spmv", {"m": 1 << 20, "n": 1 << 20, "max_nnz": 8},
     {"lsz": 64, "unroll": 8}),
    ("stencil1d", {"n": 1 << 25}, {"lsz": 64, "use_local": 0}),
    ("stencil1d", {"n": 1 << 25}, {"lsz": 64, "use_local": 1}),
    ("stencil2d", {"h": 8192, "w": 8192}, {"tx": 16, "ty": 16}),
    ("scan", {"n": 1 << 24, "seg": 256}, {"unroll": 0}),
    ("hist", {"n": 1 << 24, "bins": 16}, {"lsz": 32, "ipt": 4}),
]
QS_N, QS_LSZ = 1 << 22, 64


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the repro_torch package is not under {SRC}; "
              f"run from the repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import numpy as np
    from repro_torch.core import KernelBuilder
    from repro_torch.core.cases import CASES, build_dot_product, builder
    from repro_torch.core.interp import run_ndrange
    from repro_torch.core.targets.cuda_target import build_many
    from repro_torch.runtime import Context
    from repro_torch.suite import SUITE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    ctx = Context()
    cuda_dev = ctx.platform.get_devices("cuda")[0]
    vec_dev = ctx.platform.get_devices("vector")[0]
    dev = cuda_dev.torch_device

    # -- every kernel the run launches, compiled up front ----------------------
    dot_prog = ctx.create_program(builder(build_dot_product,
                                          KernelBuilder)).build()
    case_runs = []
    for seed, (case, (build, mk, gsz, lsz, sc)) in enumerate(CASES.items()):
        for hz in (True, False):
            prog = ctx.create_program(builder(build, KernelBuilder),
                                      horizontal=hz).build()
            case_runs.append((case, hz, seed, prog, mk, gsz, lsz, sc or {}))
    full_runs = []
    for name, sk in SUITE.items():
        shape = sk.shapes["full"]
        for params in sk.space(shape):
            full_runs.append((name, sk, shape, params,
                              ctx.create_program(sk.build(shape, params))))
    real_runs = [(name, SUITE[name], shape, params,
                  ctx.create_program(SUITE[name].build(shape, params)))
                 for name, shape, params in REAL]
    binaries = [dot_prog.create_kernel().bind(cuda_dev, (QS_LSZ,))]
    binaries += [r[3].create_kernel().bind(cuda_dev, r[6]) for r in case_runs]
    for runs in (full_runs, real_runs):
        for name, sk, shape, params, prog in runs:
            binaries.append(prog.create_kernel().bind(
                cuda_dev, sk.launch_dims(shape, params)[1]))
    progs = {b.prog.digest: b.prog for b in binaries}
    t0 = time.perf_counter()
    secs = build_many(progs.values())
    props = torch.cuda.get_device_properties(0)
    emit(1, gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         sms=props.multi_processor_count,
         smem_optin=getattr(props, "shared_memory_per_block_optin", None),
         kernels=len(progs), build_wall_s=time.perf_counter() - t0,
         nvcc_s={f"{p.wg.fn.name}@{p.lsz[:p.wg.fn.ndim]}": secs.get(d)
                 for d, p in progs.items()})

    def reset_counts():
        for p in progs.values():
            p.launches = 0

    # -- 2. quickstart through the host API (main path) --------------------------
    rng = np.random.default_rng(0)
    a = rng.standard_normal(QS_N * 4).astype(np.float32)
    b = rng.standard_normal(QS_N * 4).astype(np.float32)
    dot = dot_prog.create_kernel()
    dot.set_args(a=a, b=b, c=np.zeros(QS_N, np.float32))
    reset_counts()
    out = ctx.launch(dot, (QS_N,), (QS_LSZ,), target="cuda")
    torch.cuda.synchronize()
    dot_bin = dot.bind(cuda_dev, (QS_LSZ,))
    dot_launches = dot_bin.prog.launches
    expect = (a.reshape(-1, 4).astype(np.float64)
              * b.reshape(-1, 4)).sum(1).astype(np.float32)
    np.testing.assert_allclose(out["c"].cpu().numpy(), expect, rtol=1e-5,
                               atol=2e-6)
    small = {"a": a[:1024].copy(), "b": b[:1024].copy(),
             "c": np.zeros(256, np.float32)}
    fiber = run_ndrange(build_dot_product(KernelBuilder), (256,), (QS_LSZ,),
                        {k: v.copy() for k, v in small.items()})
    dot.set_args(**small)
    got = ctx.launch(dot, (256,), (QS_LSZ,))["c"].cpu().numpy()
    np.testing.assert_allclose(got, fiber["c"], rtol=1e-5, atol=2e-6)
    dot.set_args(a=a, b=b, c=np.zeros(QS_N, np.float32))
    plain = ctx.launch(dot, (QS_N,), (QS_LSZ,), device=vec_dev)
    dot_err = float((out["c"] - plain["c"]).abs().max())
    assert dot_err == 0.0, ("dot_product", "cuda vs vector", dot_err)
    emit(2, kernel="dot_product", work_items=QS_N, local_size=QS_LSZ,
         launches=dot_launches, numpy_rtol=1e-5, numpy_atol=2e-6,
         fiber_n=256, max_abs_err_vs_plain=dot_err)

    # -- 3. compiler cases: cuda against the vector target on the card ----------
    worst = 0.0
    for case, hz, seed, prog, mk, gsz, lsz, sc in case_runs:
        bufs = mk(np.random.default_rng(seed))
        k = prog.create_kernel()
        k.set_args(**bufs, **sc)
        got = ctx.launch(k, gsz, lsz)
        ref = ctx.launch(k, gsz, lsz, device=vec_dev)
        for name in bufs:
            g, r = got[name].cpu().numpy(), ref[name].cpu().numpy()
            exact = all(np.array_equal(v, np.round(v)) for v in bufs.values())
            if exact:
                assert g.tobytes() == r.tobytes(), (case, hz, name)
            else:
                np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{case} hz={hz} {name}")
            worst = max(worst, float(np.abs(g - r).max()))
    emit(3, cases=len(case_runs), rtol=1e-5, atol=1e-6,
         max_abs_err_vs_plain=worst)

    # -- 4. suite at full shapes, every configuration ---------------------------
    for name, sk, shape, params, prog in full_runs:
        inputs = sk.make_inputs(shape, params)
        expected = sk.oracle(inputs, shape, params)
        k = prog.create_kernel()
        k.set_args(**inputs)
        gsz, lsz = sk.launch_dims(shape, params)
        got = ctx.launch(k, gsz, lsz)
        ref = ctx.launch(k, gsz, lsz, device=vec_dev)
        for o in sk.outputs:
            g = got[o].cpu().numpy()
            assert g.tobytes() == ref[o].cpu().numpy().tobytes(), \
                (name, params, o, "cuda vs vector")
            assert g.tobytes() == expected[o].tobytes(), \
                (name, params, o, "cuda vs oracle")
    emit(4, configs=len(full_runs), bitwise=True)

    # -- 5. suite at real sizes (main path), then timing ----------------------------
    prepared = []
    reset_counts()
    for name, sk, shape, params, prog in real_runs:
        t_in = time.perf_counter()
        inputs = sk.make_inputs(shape, params)
        if name == "gemm":
            # every partial sum of the integer-valued operands is an
            # integer below 2**24, so the float64 product is exact and
            # equals the oracle's ordered float32 sum bitwise
            m, n, kk = shape["m"], shape["n"], shape["k"]
            expected = {"C": (inputs["A"].reshape(m, kk).astype(np.float64)
                              @ inputs["B"].reshape(kk, n)
                              .astype(np.float64)).astype(np.float32)
                        .reshape(-1)}
        else:
            expected = sk.oracle(inputs, shape, params)
        k = prog.create_kernel()
        k.set_args(**inputs)
        gsz, lsz = sk.launch_dims(shape, params)
        got = ctx.launch(k, gsz, lsz)
        for o in sk.outputs:
            assert got[o].cpu().numpy().tobytes() == expected[o].tobytes(), \
                (name, shape, params, o)
        prepared.append((name, sk, shape, params, k, inputs, gsz, lsz,
                         time.perf_counter() - t_in))
    torch.cuda.synchronize()
    counts = {id(p): p.launches for p in progs.values()}

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def time_ms(fn, reps=20, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for s, e in ev:
            flush.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        ts = sorted(s.elapsed_time(e) for s, e in ev)
        return ts[len(ts) // 2]

    entries = []
    qs_bytes = 4.0 * (4 * QS_N * 2 + QS_N)
    dev_qs = {"a": torch.tensor(a, device=dev), "b": torch.tensor(b, device=dev),
              "c": torch.zeros(QS_N, device=dev)}
    vec_dot = dot.bind(vec_dev, (QS_LSZ,))
    ms = time_ms(lambda: dot_bin.launch_ndrange(dev_qs, (QS_N,)))
    plain_ms = time_ms(lambda: vec_dot.launch_ndrange(dev_qs, (QS_N,)),
                       reps=3, warmup=1)
    a2, b2 = dev_qs["a"].view(-1, 4), dev_qs["b"].view(-1, 4)
    lib_ms = time_ms(lambda: torch.linalg.vecdot(a2, b2))
    bms, by = bound(8.0 * QS_N, qs_bytes)
    entries.append({"name": "cuda_target/dot_product", "launches": dot_launches,
                    "max_abs_err": dot_err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bms, "bound_by": by, "library_ms": lib_ms})

    for name, sk, shape, params, k, inputs, gsz, lsz, setup_s in prepared:
        binary = k.bind(cuda_dev, lsz)
        plain_bin = k.bind(vec_dev, lsz)
        dbufs = {n: torch.tensor(v, device=dev) for n, v in inputs.items()}
        pbufs = {n: t.clone() for n, t in dbufs.items()}
        binary.launch_ndrange(dbufs, gsz)
        plain_bin.launch_ndrange(pbufs, gsz)
        err = max(float((dbufs[o].double() - pbufs[o].double()).abs().max())
                  for o in sk.outputs)
        assert err == 0.0, (name, params, "cuda vs vector", err)
        ms = time_ms(lambda: binary.launch_ndrange(dbufs, gsz))
        plain_ms = time_ms(lambda: plain_bin.launch_ndrange(pbufs, gsz),
                           reps=3, warmup=0)
        lib_ms = None
        if name == "gemm":
            A = dbufs["A"].view(shape["m"], shape["k"])
            B = dbufs["B"].view(shape["k"], shape["n"])
            lib_ms = time_ms(lambda: torch.matmul(A, B))
        elif name == "scan":
            x = dbufs["x"].view(-1, shape["seg"])
            lib_ms = time_ms(lambda: x.cumsum(1))
        elif name == "spmv":
            with warnings.catch_warnings():   # "CSR support is in beta"
                warnings.simplefilter("ignore", UserWarning)
                csr = torch.sparse_csr_tensor(
                    dbufs["rowptr"], dbufs["cols"], dbufs["vals"],
                    (shape["m"], shape["n"]))
            xv = dbufs["x"].view(-1, 1)
            lib_ms = time_ms(lambda: torch.sparse.mm(csr, xv))
        nbytes = sum(v.nbytes for n, v in inputs.items()
                     if n not in sk.outputs) \
            + sum(inputs[o].nbytes for o in sk.outputs)
        bms, by = bound(sk.flops(shape), nbytes)
        label = f"cuda_target/{name}" + (
            f"_local{params['use_local']}" if name == "stencil1d" else "")
        launches = counts[id(binary.prog)]
        emit(5, kernel=label, shape=shape, params=params, ms=ms,
             plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
             fraction_of_bound=bms / ms, launches=launches,
             inputs_and_oracle_s=setup_s,
             tf32={"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32})
        assert launches > 0, (label, "not launched on the main path")
        entries.append({"name": label, "launches": launches,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bms, "bound_by": by,
                        "library_ms": lib_ms})
        del dbufs, pbufs
        torch.cuda.empty_cache()
    assert dot_launches > 0

    # -- 6. kernels line, card, result ---------------------------------------------
    print(json.dumps({"kernels": [
        {"name": e["name"], "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES, "launches": e["launches"],
         "max_abs_err": e["max_abs_err"], "ms": e["ms"],
         "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
         "bound_by": e["bound_by"], "library_ms": e["library_ms"],
         "held_against_plain": True} for e in entries]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
