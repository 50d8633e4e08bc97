"""The ``cuda`` work-group target of ``repro_torch``.

On the CPU: the emitted CUDA source (golden snapshots, direct region
control flow and a ``__syncthreads()`` only where a barrier orders
memory, zeroed ``__shared__`` memory, every compiler case and suite
kernel emits) and the typed refusals; ``tests/test_torch_cuda_emit.py``
runs the emitted source on the CPU.  On a card (marker ``cuda``,
skipped elsewhere): the kernels against the torch ``vector`` target, its
plain version, on the same device — bitwise, since the suite's data is
integer-valued or dyadic and the kernels are built with
``-fmad=false``, and at ``rtol=1e-5, atol=1e-6`` on random-normal data;
and the host runtime on the card, bitwise: a buffer's round trip through
writes, reads and a map, the fused rmsnorm -> residual -> quantize chain
against the unfused one and the ``vector`` target, and a kernel command's
event completing only once the card has run the kernel; co-execution over
two ``cuda`` devices of the card (bitwise against one launch, each
chunk's event completing after its kernel) and the autotuner's recorded
``cuda`` time covering the kernel's CUDA-event time.

Regenerate the snapshots after an intentional emitter change:

  REPRO_UPDATE_GOLDEN=1 PYTHONPATH=src python -m pytest \
      tests/test_torch_cuda_target.py
"""

import os
import pickle

import numpy as np
import pytest
import torch

from repro_torch.core import KernelBuilder, InvalidArgError
from repro_torch.core.api import _compile_kernel
from repro_torch.core.cases import CASES, builder
from repro_torch.core.errors import BuildError
from repro_torch.core.examples import build_condbar, build_dct, build_reduce2
from repro_torch.core import nvcc
from repro_torch.core.targets import cuda_target
from repro_torch.core.targets.cuda_mapping import barrier_kind
from repro_torch.core.targets.cuda_target import CudaWGProgram, build_many
from repro_torch.runtime import Context, DeviceNotFoundError, Platform
from repro_torch.suite import SUITE

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden", "torch_cuda")
GEMM_REAL = SUITE["gemm"].build({"m": 2048, "n": 2048, "k": 2048},
                                {"ts": 16, "unroll": 16})
GOLDEN = {"reduce2": (build_reduce2, (2,)), "condbar": (build_condbar, (4,)),
          "dct": (build_dct, (8,)), "gemm_ts16": (GEMM_REAL, (16, 16))}


def cuda_program(build, lsz, horizontal=True) -> CudaWGProgram:
    return _compile_kernel(build, lsz, target="cuda", horizontal=horizontal,
                           cache=False).prog


def all_kernels():
    for case, (build, mk, gsz, lsz, sc) in sorted(CASES.items()):
        for hz in (True, False):
            yield f"case-{case}-hz{int(hz)}", builder(build, KernelBuilder), \
                lsz, hz
    for name in sorted(SUITE):
        sk = SUITE[name]
        for which in ("ci", "full"):
            shape = sk.shapes[which]
            for params in sk.space(shape):
                yield (f"{name}-{which}-" + ",".join(
                    f"{k}={v}" for k, v in sorted(params.items())),
                    sk.build(shape, params),
                    sk.launch_dims(shape, params)[1], True)


KERNELS = list(all_kernels())


# ---------------------------------------------------------------------------
# the emitted source (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_emitted_source_golden(name):
    build, lsz = GOLDEN[name]
    got = cuda_program(build, lsz).source
    path = os.path.join(GOLDEN_DIR, f"{name}.cu")
    if os.environ.get("REPRO_UPDATE_GOLDEN"):
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        with open(path, "w") as f:
            f.write(got)
    with open(path) as f:
        want = f.read()
    assert got == want, (
        f"emitted CUDA drifted from {path}; if the emitter change is "
        f"intentional, regenerate with REPRO_UPDATE_GOLDEN=1")


@pytest.mark.parametrize("name,build,lsz,hz", KERNELS,
                         ids=[k[0] for k in KERNELS])
def test_every_kernel_emits_with_one_barrier_per_boundary(name, build, lsz,
                                                          hz):
    prog = cuda_program(build, lsz, hz)
    src, m, fn = prog.source, prog.mapping, prog.wg.fn
    assert "wg_kernel(" in src and "extern \"C\" int wg_launch(" in src
    # one thread per work-item
    assert f"__launch_bounds__({prog.L}) " in src
    assert f"<<<wg_groups, {prog.L}, " in src
    has_locals = prog.smem_bytes > 0
    zeroing = src.count("((int*)wg_smem)[i] = 0;")
    assert zeroing == int(has_locals)
    explicit = {b for b in prog.order if barrier_kind(fn, b) == "explicit"}
    if m.direct:
        # every region's successor uniform: no switch, and a barrier only
        # where one is explicit, or kept to order memory, or after zeroing
        assert "switch (wg_rid)" not in src and "wg_next" not in src
        assert explicit <= m.kept
        assert src.count("__syncthreads();") == \
            len(explicit) + len(m.kept - explicit) + int(has_locals)
    else:
        boundaries = 1      # the one barrier at the bottom of the loop
        assert "switch (wg_rid)" in src
        assert src.count("case ") == prog.K
        assert src.count("__syncthreads();") == boundaries + int(has_locals)
    if prog.wg.is_chain():
        assert m.direct
    if not hz and any(len(r.exits) > 1 for r in prog.wg.regions.values()):
        assert not m.direct     # no uniformity analysis, nothing proven
    # the zeroing runs before region 0
    if has_locals:
        assert src.index("((int*)wg_smem)[i] = 0;") < src.index("region 0")


@pytest.mark.parametrize("name,shape,params,lsz,kloop_barriers", [
    ("gemm", {"m": 2048, "n": 2048, "k": 2048}, {"ts": 16, "unroll": 16},
     (16, 16), 2),
    ("scan", {"n": 1 << 24, "seg": 256}, {"unroll": 0}, (256,), 1),
])
def test_real_size_kernels_take_direct_flow(name, shape, params, lsz,
                                            kloop_barriers):
    """The GEMM and the scan that ``chip_smoke.py`` times: no switch, and
    only the explicit barriers of the loop (two per k-tile, one per scan
    round), one before it for the scan, and the zeroing's."""
    prog = cuda_program(SUITE[name].build(shape, params), lsz)
    src = prog.source
    assert prog.mapping.direct and "switch (wg_rid)" not in src
    before_loop = 1 if name == "scan" else 0
    assert src.count("__syncthreads();") == kloop_barriers + before_loop + 1
    assert {barrier_kind(prog.wg.fn, b) for b in prog.mapping.kept} == \
        {"explicit"}


def test_int_ranges_hold_every_value_the_vector_target_computes():
    """The bounds that let the emitter drop clamps and wrap-arounds
    contain every value of their expressions on every work-item."""
    exprs = [
        lambda b, x, y: x, lambda b, x, y: y, lambda b, x, y: x * 16 + 3,
        lambda b, x, y: (x * 7) % 5, lambda b, x, y: x / 3,
        lambda b, x, y: b.minimum(x, 4) - 2,
        lambda b, x, y: b.maximum(x - 8, 0) * y,
        lambda b, x, y: b.select(x > 2, x * 3, y - 5),
        lambda b, x, y: x & 6, lambda b, x, y: (x + 1) * (x - 3) - y,
        lambda b, x, y: (x * 3 + 20) % 7 - y * 9,
    ]

    def build():
        b = KernelBuilder("ranges", ndim=2)
        out = b.arg_buffer("out", "int32")
        x, y = b.local_id(0), b.local_id(1)
        lin = (b.global_id(1) * 16 + b.global_id(0)) * len(exprs)
        for k, e in enumerate(exprs):
            out[lin + k] = e(b, x, y)
        return b.finish()

    lsz = (8, 2)
    prog = cuda_program(build, lsz)
    stores = [i for blk in prog.wg.fn.blocks.values() for i in blk.instrs
              if i.op == "store"]
    bounds = [prog.mapping.ranges.get(i.operands[1].id) for i in stores]
    assert all(bd is not None for bd in bounds)
    k = _compile_kernel(build, lsz, target="vector", cache=False)
    got = k({"out": np.zeros(16 * 4 * len(exprs), np.int32)}, (16, 4),
            None)["out"].numpy().reshape(-1, len(exprs))
    for col, (lo, hi) in enumerate(bounds):
        assert lo <= got[:, col].min() and got[:, col].max() <= hi, col


def test_emission_is_deterministic_and_digest_tracks_source():
    a = cuda_program(build_reduce2, (2,))
    b = cuda_program(build_reduce2, (2,))
    c = cuda_program(build_reduce2, (4,))
    assert a.source == b.source and a.digest == b.digest
    assert c.digest != a.digest


def test_shared_memory_is_sized_and_aligned():
    sk = SUITE["hist"]
    shape, params = sk.shapes["ci"], {"lsz": 16, "ipt": 1}
    prog = cuda_program(sk.build(shape, params), (16,))
    assert prog.smem_bytes == 16 * shape["bins"] * 4
    gemm = SUITE["gemm"]
    prog = cuda_program(gemm.build(gemm.shapes["ci"], {"ts": 4, "unroll": 1}),
                        (4, 4))
    assert prog.smem_bytes == 2 * 16 * 4     # two 4x4 float tiles


def test_scalars_are_kernel_parameters():
    build, mk, gsz, lsz, sc = CASES["bloop"]
    src = cuda_program(builder(build, KernelBuilder), lsz).source
    head = src[src.index("wg_kernel("):src.index(")", src.index("wg_kernel("))]
    assert "int v" in head          # the trip count ``n`` is an argument


def test_pickle_drops_the_library_handle():
    prog = cuda_program(build_dct, (8,))
    prog._fn = object()             # stands in for a loaded ctypes function
    again = pickle.loads(pickle.dumps(prog))
    assert again._fn is None and again.digest == prog.digest
    assert again.source == prog.source


# ---------------------------------------------------------------------------
# typed refusals (CPU)
# ---------------------------------------------------------------------------

def test_cuda_target_on_a_cpu_device_is_refused():
    ctx = Context(platform=Platform(torch_device="cpu"))
    assert {d.info.driver for d in ctx.devices} == {"vector", "basic",
                                                    "auto"}
    k = ctx.create_program(builder(CASES["vecadd"][0],
                                   KernelBuilder)).create_kernel()
    k.set_args(A=np.ones(16, np.float32), B=np.ones(16, np.float32),
               C=np.zeros(16, np.float32))
    with pytest.raises(InvalidArgError, match="needs a CUDA device"):
        ctx.launch(k, (16,), (8,), target="cuda")


def test_cuda_program_refuses_cpu_tensors():
    prog = cuda_program(builder(CASES["vecadd"][0], KernelBuilder), (8,))
    bufs = {n: torch.zeros(16) for n in "ABC"}
    with pytest.raises(InvalidArgError, match="CUDA tensors"):
        prog.launch_ndrange(bufs, {}, (16,))
    assert prog.launches == 0


def test_more_than_1024_work_items_is_refused():
    def build():
        b = KernelBuilder("wide")
        x = b.arg_buffer("x", "float32")
        x[b.global_id(0)] = 1.0
        return b.finish()
    with pytest.raises(InvalidArgError, match="at most 1024"):
        cuda_program(build, (1025,))
    with pytest.raises(InvalidArgError, match="at most 1024"):
        cuda_program(build, (33, 32))
    assert cuda_program(build, (32, 32)).L == 1024


def test_platform_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceNotFoundError) as e:
        Platform()
    assert e.value.code == -1
    with pytest.raises(DeviceNotFoundError):
        Context()


def test_missing_nvcc_is_a_build_error(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_target, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(nvcc.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed at its default path")
    with pytest.raises(BuildError, match="nvcc not found"):
        build_many([cuda_program(build_dct, (8,))])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    """A context on the first CUDA device; skips without a card or nvcc.
    Builds every kernel of this module at once (one nvcc each)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        nvcc.find_nvcc()
    except BuildError:
        pytest.skip("needs nvcc")
    ctx = Context()
    dev = ctx.platform.get_devices("cuda")[0]
    progs = []
    for name, build, lsz, hz in KERNELS:
        prog = ctx.create_program(build, horizontal=hz)
        progs.append(prog.create_kernel().bind(dev, lsz).prog)
    build_many(progs)
    return ctx


def _launch_both(ctx, build, bufs, gsz, lsz, scalars=None, hz=True,
                 group_range=None):
    cuda_dev = ctx.platform.get_devices("cuda")[0]
    vec_dev = ctx.platform.get_devices("vector")[0]
    k = ctx.create_program(build, horizontal=hz).create_kernel()
    k.set_args(**bufs, **(scalars or {}))
    binary = k.bind(cuda_dev, lsz)
    before = binary.prog.launches
    if group_range is None:
        got = ctx.launch(k, gsz, lsz)
        ref = ctx.launch(k, gsz, lsz, device=vec_dev)
    else:
        got = binary(bufs, gsz, scalars, group_range=group_range,
                     device=cuda_dev.torch_device)
        ref = k.bind(vec_dev, lsz)(bufs, gsz, scalars,
                                   group_range=group_range,
                                   device=vec_dev.torch_device)
    torch.cuda.synchronize()
    assert binary.prog.launches == before + 1
    return ({n: t.cpu().numpy() for n, t in got.items()},
            {n: t.cpu().numpy() for n, t in ref.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("hz", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cases_on_the_card_match_vector_target(card, case, hz):
    build, mk, gsz, lsz, sc = CASES[case]
    bufs = mk(np.random.default_rng(sorted(CASES).index(case)))
    got, ref = _launch_both(card, builder(build, KernelBuilder), bufs, gsz,
                            lsz, sc, hz)
    for n in bufs:
        np.testing.assert_allclose(got[n], ref[n], rtol=1e-5, atol=1e-6,
                                   err_msg=f"{case} hz={hz} {n}")


@pytest.mark.cuda
@pytest.mark.parametrize("grange", [(0, 1), (1, 2)])
def test_group_range_on_the_card(card, grange):
    build, mk, gsz, lsz, sc = CASES["reduce"]
    bufs = {"inp": np.arange(16, dtype=np.float32),
            "out": np.full(2, -1.0, np.float32)}
    got, ref = _launch_both(card, builder(build, KernelBuilder), bufs, gsz,
                            lsz, sc, group_range=grange)
    assert got["out"].tobytes() == ref["out"].tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SUITE))
def test_suite_ci_on_the_card_bitwise(card, name):
    sk = SUITE[name]
    shape = sk.shapes["ci"]
    for params in sk.space(shape):
        inputs = sk.make_inputs(shape, params)
        expected = sk.oracle(inputs, shape, params)
        gsz, lsz = sk.launch_dims(shape, params)
        got, ref = _launch_both(card, sk.build(shape, params), inputs, gsz,
                                lsz)
        for o in sk.outputs:
            assert got[o].tobytes() == ref[o].tobytes(), (name, params, o)
            assert got[o].tobytes() == expected[o].tobytes(), \
                (name, params, o)


# ---------------------------------------------------------------------------
# the host runtime on the card: device buffers, maps, the fused chain
# ---------------------------------------------------------------------------

CHAIN = ("rmsnorm_ew", "residual_add", "quantize")
CHAIN_N, CHAIN_LSZ = 1 << 20, 256
SPIN_N, SPIN_ITERS = 1 << 20, 100_000


def build_spin():
    """x[g] += 1, ``iters`` times: a launch long enough (milliseconds)
    that an event completed at the host call's return would be seen
    completing before the card."""
    b = KernelBuilder("spin")
    x = b.arg_buffer("x", "float32")
    iters = b.arg_scalar("iters", "int32")
    g = b.global_id(0)
    i = b.var(b.const(0), name="i")
    acc = b.var(x[g], name="acc")
    with b.while_loop() as loop:
        loop.cond(i.get() < iters)
        acc.set(acc.get() + 1.0)
        i.set(i.get() + 1)
    x[g] = acc.get()
    return b.finish()


@pytest.fixture(scope="module")
def runtime_card():
    """A context on the first CUDA device with the runtime tests' kernels
    built at once; skips without a card or nvcc."""
    from repro_torch.core.examples import (build_quantize,
                                           build_residual_add,
                                           build_rmsnorm_ew)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        nvcc.find_nvcc()
    except BuildError:
        pytest.skip("needs nvcc")
    ctx = Context()
    dev = ctx.platform.get_devices("cuda")[0]
    chain = ctx.create_program(build_rmsnorm_ew, build_residual_add,
                               build_quantize)
    spin = ctx.create_program(build_spin)
    progs = [chain.create_kernel(n).bind(dev, (CHAIN_LSZ,)).prog
             for n in CHAIN]
    progs.append(spin.create_kernel().bind(dev, (256,)).prog)
    build_many(progs)
    return ctx, chain, spin


@pytest.mark.cuda
def test_buffer_round_trip_through_the_card(runtime_card):
    from repro_torch.runtime import create_sub_buffer
    ctx, _, _ = runtime_card
    dev = ctx.platform.get_devices("cuda")[0]
    host = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    buf = ctx.create_buffer(4096, device=dev)
    sub = create_sub_buffer(buf, 1024 * 4, 2048 * 4)
    q = ctx.create_queue(dev)
    q.enqueue_write_buffer(buf, host)
    whole, part = np.zeros(4096, np.float32), np.zeros(2048, np.float32)
    q.enqueue_read_buffer(buf, whole)
    q.enqueue_read_buffer(sub, part)
    region = q.enqueue_map_buffer(sub, "rw")
    mapped = region.get().copy()
    region.array[:] = -region.array
    q.enqueue_unmap_buffer(region)
    after = np.zeros(4096, np.float32)
    q.enqueue_read_buffer(buf, after)
    q.finish()
    assert buf.data.is_cuda
    assert whole.tobytes() == host.tobytes()
    assert part.tobytes() == host[1024:3072].tobytes()
    assert mapped.tobytes() == host[1024:3072].tobytes()
    flipped = host.copy()
    flipped[1024:3072] = -flipped[1024:3072]
    assert after.tobytes() == flipped.tobytes()
    buf.release()


@pytest.mark.cuda
def test_fused_chain_on_the_card_bitwise(runtime_card):
    """The chain fused (one cuda launch), unfused (three) and on the
    vector target of the same card: bitwise equal."""
    ctx, chain, _ = runtime_card
    dev = ctx.platform.get_devices("cuda")[0]
    vec = ctx.platform.get_devices("vector")[0]
    rng = np.random.default_rng(1)
    xh, wh, rh = (rng.standard_normal(CHAIN_N).astype(np.float32)
                  for _ in range(3))
    outs, stats = {}, {}
    for label, qdev, fusion in (("off", dev, "off"), ("flush", dev, "flush"),
                                ("vector", vec, "off")):
        bufs = {n: ctx.create_buffer(CHAIN_N, device=dev) for n in "xwryzq"}
        queue = ctx.create_queue(qdev, fusion=fusion)
        for n, h in zip("xwr", (xh, wh, rh)):
            queue.enqueue_write_buffer(bufs[n], h)
        k1, k2, k3 = (chain.create_kernel(n) for n in CHAIN)
        k1.set_args(x=bufs["x"], w=bufs["w"], y=bufs["y"], inv_rms=0.75)
        k2.set_args(y=bufs["y"], r=bufs["r"], z=bufs["z"])
        k3.set_args(z=bufs["z"], q=bufs["q"], scale=16.0)
        for k in (k1, k2, k3):
            queue.enqueue_nd_range(k, (CHAIN_N,), (CHAIN_LSZ,))
        outs[label] = np.zeros(CHAIN_N, np.float32)
        queue.enqueue_read_buffer(bufs["q"], outs[label])
        queue.finish()
        stats[label] = (queue.dag_stats()["fused_chains"],
                        queue.stats["launches"],
                        bufs["y"].materialized)
        for b in bufs.values():
            b.release()
    assert stats == {"off": (0, 3, True), "flush": (1, 1, False),
                     "vector": (0, 3, True)}
    assert outs["flush"].tobytes() == outs["off"].tobytes()
    assert outs["flush"].tobytes() == outs["vector"].tobytes()


@pytest.mark.cuda
def test_kernel_event_completes_after_the_card(runtime_card):
    """``Event.wait()`` on a kernel command returns only once the card
    has finished: the stream is idle, and a copy on another stream (which
    does not wait for the default one) reads the kernel's result."""
    ctx, _, spin = runtime_card
    dev = ctx.platform.get_devices("cuda")[0]
    buf = ctx.create_buffer(SPIN_N, device=dev)
    q = ctx.create_queue(dev)
    q.enqueue_write_buffer(buf, np.arange(SPIN_N, dtype=np.float32) % 64)
    k = spin.create_kernel().set_args(x=buf, iters=SPIN_ITERS)
    ev = q.enqueue_nd_range(k, (SPIN_N,), (256,))
    q.flush()
    ev.wait()
    assert torch.cuda.current_stream(dev.torch_device).query()
    side = torch.cuda.Stream(dev.torch_device)
    host = torch.empty(SPIN_N, dtype=torch.float32, pin_memory=True)
    with torch.cuda.stream(side):
        host.copy_(buf.data, non_blocking=True)
    side.synchronize()
    want = np.arange(SPIN_N, dtype=np.float32) % 64 + SPIN_ITERS
    assert host.numpy().tobytes() == want.astype(np.float32).tobytes()
    q.finish()
    buf.release()


# ---------------------------------------------------------------------------
# co-execution and the autotuner on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_two_cuda_devices_static_split_bitwise(runtime_card):
    """Two cuda devices of one card, a static split: each chunk a
    group_range launch of the spin kernel; the merge equals one launch."""
    ctx, _, spin = runtime_card
    host = np.arange(SPIN_N, dtype=np.float32) % 64
    k = spin.create_kernel().set_args(x=host, iters=100)
    single = ctx.launch(k, (SPIN_N,), (256,))["x"].cpu().numpy()
    devs = ctx.platform.co_devices(2, driver="cuda")
    co = ctx.create_co_executor(devs)
    merged = co.launch(k, (SPIN_N,), (256,), mode="static")["x"].numpy()
    st = co.last_stats
    co.finish()
    assert merged.tobytes() == single.tobytes()
    assert merged.tobytes() == (host + 100).astype(np.float32).tobytes()
    assert st.groups_per_device == {d.info.name: SPIN_N // 512
                                    for d in devs}
    assert st.bytes_to_host == 2 * SPIN_N * 4


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["steal", "adaptive"])
def test_two_cuda_devices_self_scheduled_bitwise(runtime_card, mode):
    """Steal and adaptive mode over two cuda devices of one card: every
    launch starts from the host array, the chunks cover every group and
    the merge equals one launch."""
    ctx, _, spin = runtime_card
    host = np.arange(SPIN_N, dtype=np.float32) % 64
    k = spin.create_kernel().set_args(x=host, iters=100)
    single = ctx.launch(k, (SPIN_N,), (256,))["x"].cpu().numpy()
    devs = ctx.platform.co_devices(2, driver="cuda")
    co = ctx.create_co_executor(devs)
    for _ in range(2):
        merged = co.launch(k, (SPIN_N,), (256,), mode=mode)["x"].numpy()
        st = co.last_stats
        co.finish()
        assert merged.tobytes() == single.tobytes()
        reach = 0
        for lo, hi in sorted((lo, hi) for _, lo, hi in st.chunk_spans):
            assert lo <= reach, ("groups left out", reach, lo)
            reach = max(reach, hi)
        assert reach == st.n_groups


@pytest.mark.cuda
def test_chunk_event_completes_after_the_card(runtime_card):
    """A co-executed chunk's event completes only once the card has run
    its kernel: read on another stream from the event's own completion
    callback, the device copy already holds the chunk's result."""
    ctx, _, spin = runtime_card
    devs = ctx.platform.co_devices(2, driver="cuda")
    co = ctx.create_co_executor(devs)
    host = np.arange(SPIN_N, dtype=np.float32) % 64
    x = co.shared_buffer(host, "x")
    k = spin.create_kernel().set_args(x=x, iters=SPIN_ITERS)
    seen = []

    class Sink:
        def on_command(self, ev, deps, queue):
            if ev.kind == "kernel":
                ev.add_callback(lambda e, d=queue.device: read(e, d))

    def read(ev, dev):
        lo, hi = map(int, ev.name.rsplit(":", 1)[1].split("-"))
        side = torch.cuda.Stream(dev.torch_device)
        out = torch.empty(SPIN_N, dtype=torch.float32, pin_memory=True)
        with torch.cuda.stream(side):
            out.copy_(x.resident_tensor(dev), non_blocking=True)
        side.synchronize()
        seen.append(out[lo * 256:hi * 256].numpy().tobytes()
                    == (host[lo * 256:hi * 256] + SPIN_ITERS).tobytes())

    for q in co.queues.values():
        q.trace_sink = Sink()
    merged = co.launch(k, (SPIN_N,), (256,), mode="static")["x"].numpy()
    co.finish()
    assert seen == [True, True]
    assert merged.tobytes() == (host + SPIN_ITERS).tobytes()


@pytest.mark.cuda
def test_autotuned_cuda_time_covers_the_kernel(runtime_card):
    """The tuner's recorded ``cuda`` time (host clock around a launch and
    a synchronize) is at least the kernel's time by CUDA events."""
    from repro_torch.core import AutotunedKernel, TuningTable
    ctx, _, spin = runtime_card
    dev = ctx.platform.get_devices("auto")[0]
    table = TuningTable()
    build = spin.builder("spin")
    k = AutotunedKernel(build(), build, (256,), {}, ("cuda",), table,
                        dev.compile_cache, _compile_kernel,
                        device_key=dev.info.name)
    x = torch.zeros(SPIN_N, device=dev.torch_device)
    k.launch_ndrange({"x": x}, (SPIN_N,), {"iters": SPIN_ITERS})
    torch.cuda.synchronize()
    assert torch.equal(x.cpu(), torch.full((SPIN_N,), float(SPIN_ITERS)))
    (ent,) = table._winners.values()
    binary = k.kernel_for("cuda")
    times = []
    for _ in range(3):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        binary.launch_ndrange({"x": x}, (SPIN_N,), {"iters": SPIN_ITERS})
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) * 1e3)
    assert ent["target"] == "cuda"
    assert ent["timings_us"]["cuda"] >= min(times), (ent, times)
