"""The port's multi-device co-execution (``repro_torch.runtime.scheduler``)
held against the reference's (``repro.runtime.scheduler``) on the same
numpy inputs.

Every co-executed launch here runs on ``Platform(torch_device="cpu")``
devices; its merge is held **bitwise** against the reference's
single-device launch of the same kernel (the kernels compute
integer-valued data, zeros, NaNs and signed zeros, so bitwise is the
tolerance throughout).  The scheduler's own logic — the HGuided
splitter, the throughput model, steal discipline — runs in virtual time
through :class:`SplitDriver` (no devices, threads or sleeps) and through
a hypothesis state machine with ``derandomize=True``, so it can add no
flaky failure of its own.  Lopsided platforms of
:class:`~repro_torch.runtime.platform.ThrottledDevice`\\ s (4 ms and 32 ms
of simulated time per work-group: the reference benchmark's 8x ratio)
pin the end-to-end behaviour: bitwise identity under stalls and steals,
one plan build across N devices, stats consistent with the event
timeline, and warm-table convergence within two launches.

Where the port differs by design, the test pins the difference and
ROADMAP §C names it: the merge compares bit patterns, so a chunk that
only flips the sign of a zero or a NaN is merged (C.10, the reference
drops it); the throughput model's weights stay positive when the rates
are 1e300 apart (C.6, the reference's underflow to 0).
"""

import math
import random
import time
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.runtime as jrt  # noqa: E402
from repro.core import KernelBuilder as JKB  # noqa: E402
from repro.core.autotune import TuningTable as JTuningTable  # noqa: E402

from repro_torch.core import KernelBuilder as TKB, TuningTable  # noqa: E402
from repro_torch.runtime import (AdaptiveSplitter, CommandQueue,  # noqa: E402
                                 Context, DeviceInfo, InvalidArgError,
                                 Platform, ResidencyTracker,
                                 ThrottledDevice, ThroughputModel,
                                 chunk_counters, create_buffer,
                                 create_sub_buffer, device_class,
                                 split_groups)
from repro_torch.runtime.scheduler import (CoExecutor,  # noqa: E402
                                           _mask_to_byte_spans)

try:
    from hypothesis import given, settings, strategies as st
    from hypothesis.stateful import (RuleBasedStateMachine, initialize,
                                     invariant, rule)
    HAVE_HYPOTHESIS = True
except ImportError:               # the seeded walks below still run
    HAVE_HYPOTHESIS = False


# ---------------------------------------------------------------------------
# kernels (one source, either package's KernelBuilder)
# ---------------------------------------------------------------------------

def k_scale(KB):
    """examples/opencl_runtime.py's first kernel: x = x * s."""
    b = KB("scale")
    x = b.arg_buffer("x", "float32")
    s = b.arg_scalar("s", "float32")
    g = b.global_id(0)
    x[g] = x[g] * s
    return b.finish()


def k_scale2(KB):
    """y = x * 2 + g (two buffers, the reference's coexec kernel)."""
    b = KB("scale2")
    x = b.arg_buffer("x", "float32")
    y = b.arg_buffer("y", "float32")
    g = b.global_id(0)
    y[g] = x[g] * 2.0 + g
    return b.finish()


def k_affine(KB):
    """y = x * 2 + 1: every element of y changes, so the written spans
    are exact (the reference's residency kernel)."""
    b = KB("affine")
    x = b.arg_buffer("x", "float32")
    y = b.arg_buffer("y", "float32")
    g = b.global_id(0)
    y[g] = x[g] * 2.0 + 1.0
    return b.finish()


def k_reduce(KB):
    """A LOCAL array and barriers: each group sums its 8 inputs."""
    b = KB("reduce8")
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


def bld(fn, KB):
    return lambda: fn(KB)


def _ctx():
    return Context(platform=Platform(torch_device="cpu"))


def _jctx():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return jrt.Context(platform=jrt.Platform())


def nan_zeros(n):
    """Zeros with every third element NaN: the C.10 input."""
    x = np.zeros(n, np.float32)
    x[::3] = np.nan
    return x


# name -> (kernel, inputs, scalars, global size, local size)
KCASES = {
    "scale2": (k_scale2, lambda: {"x": np.arange(512, dtype=np.float32),
                                  "y": np.zeros(512, np.float32)},
               {}, 512, 64),
    "reduce": (k_reduce,
               lambda: {"inp": np.random.default_rng(7).integers(
                   -50, 50, 256).astype(np.float32),
                        "out": np.zeros(32, np.float32)}, {}, 256, 8),
    "neg_nan_zeros": (k_scale, lambda: {"x": nan_zeros(256)},
                      {"s": -1.0}, 256, 64),
}


def ref_single(name, driver):
    """The reference's single-device launch of a case on ``driver``."""
    fn, mk, sc, n, lsz = KCASES[name]
    jctx = _jctx()
    k = jctx.create_program(bld(fn, JKB)).create_kernel()
    k.set_args(**mk(), **sc)
    dev = jctx.platform.get_devices(driver)[0]
    return {nm: np.asarray(v) for nm, v in
            jctx.launch(k, (n,), (lsz,), device=dev).items()}


# ---------------------------------------------------------------------------
# every mode's merge against the reference's single launch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["static", "steal", "adaptive"])
@pytest.mark.parametrize("driver", ["vector", "basic"])
@pytest.mark.parametrize("name", sorted(KCASES))
def test_merge_bitwise_equal_to_reference_single_launch(name, driver, mode):
    fn, mk, sc, n, lsz = KCASES[name]
    ctx = _ctx()
    k = ctx.create_program(bld(fn, TKB)).create_kernel()
    k.set_args(**mk(), **sc)
    co = ctx.create_co_executor(ctx.platform.co_devices(2, driver=driver),
                                chunks_per_device=3,
                                tuning_table=TuningTable())
    merged = co.launch(k, (n,), (lsz,), mode=mode)
    co.finish()
    want = ref_single(name, driver)
    for nm, v in want.items():
        assert merged[nm].numpy().tobytes() == v.tobytes(), (name, nm)
    st_ = co.last_stats
    assert st_.n_groups == n // lsz
    assert sum(st_.groups_per_device.values()) >= st_.n_groups


def test_c10_sign_flips_are_merged_and_the_reference_drops_them():
    """The -1.0 scale over zeros and NaNs: each of the 170 zeros
    becomes -0.0 and the NaNs stay NaN.  The port's merge takes those
    flips (bit patterns differ); the reference's ``!=`` treats -0.0 as
    0.0 and a NaN as any NaN, so its merge keeps none of the 170 sign
    bits its own single launch sets (ROADMAP C.10)."""
    n, lsz = 256, 64
    want = ref_single("neg_nan_zeros", "vector")["x"]
    assert int((want.view(np.uint32) >> 31).sum()) == 170

    ctx = _ctx()
    k = ctx.create_program(bld(k_scale, TKB)).create_kernel()
    k.set_args(x=nan_zeros(n), s=-1.0)
    co = ctx.create_co_executor(ctx.platform.co_devices(2))
    single = ctx.launch(k, (n,), (lsz,))["x"].numpy()
    merged = co.launch(k, (n,), (lsz,), mode="static")["x"].numpy()
    co.finish()
    assert single.tobytes() == want.tobytes()
    assert merged.tobytes() == single.tobytes()

    jctx = _jctx()
    jk = jctx.create_program(bld(k_scale, JKB)).create_kernel()
    jk.set_args(x=nan_zeros(n), s=-1.0)
    jco = jctx.create_co_executor(jctx.platform.co_devices(2))
    jmerged = np.asarray(jco.launch(jk, (n,), (lsz,), mode="static")["x"])
    jco.finish()
    assert int((jmerged.view(np.uint32) >> 31).sum()) == 0
    assert jmerged.tobytes() != want.tobytes()


def test_walkthrough_end_matches_reference():
    """examples/opencl_runtime.py:83-94: the scale kernel's host-array
    launch split over ``co_devices(2)``, static — equal to the context's
    single launch and to the reference's co-executed bytes."""
    n = 256
    host = np.arange(n, dtype=np.float32)
    outs = {}
    for pkg, ctx, KB in (("port", _ctx(), TKB), ("ref", _jctx(), JKB)):
        prog = ctx.create_program(bld(k_scale, KB)).build()
        k_host = prog.create_kernel().set_args(x=host.copy(), s=2.0)
        single = ctx.launch(k_host, (n,), (64,))
        co = ctx.create_co_executor(ctx.platform.co_devices(2))
        merged = co.launch(k_host.clone(), (n,), (64,), mode="static")
        st_ = co.last_stats
        co.finish()
        as_np = (lambda t: t.numpy()) if pkg == "port" else np.asarray
        assert as_np(merged["x"]).tobytes() == as_np(single["x"]).tobytes()
        outs[pkg] = (as_np(merged["x"]).tobytes(),
                     sorted(st_.groups_per_device.values()), st_.migrations)
    assert outs["port"] == outs["ref"]


def test_static_split_respects_weights():
    ctx = _ctx()
    devs = ctx.platform.co_devices(2)
    co = ctx.create_co_executor(devs)
    k = ctx.create_program(bld(k_scale2, TKB)).create_kernel()
    k.set_args(x=np.arange(512, dtype=np.float32),
               y=np.zeros(512, np.float32))
    co.launch(k, (512,), (64,), mode="static", weights=[3, 1])
    g = co.last_stats.groups_per_device
    assert g == {devs[0].info.name: 6, devs[1].info.name: 2}
    with pytest.raises(InvalidArgError, match="one weight per device"):
        co.launch(k, (512,), (64,), mode="static", weights=[1])
    with pytest.raises(InvalidArgError, match="unknown co-execution mode"):
        co.launch(k, (512,), (64,), mode="dynamic")
    co.finish()


def test_heterogeneous_devices_in_one_executor():
    """A vector device, a basic device and a throttled one in one
    executor (``CoExecutor`` takes any list): every mode equal to the
    reference's single launch."""
    plat = Platform(torch_device="cpu")
    devs = plat.co_devices(1, driver="vector") \
        + plat.co_devices(1, driver="basic") + [make_sim_device(5, 0.0, "z")]
    want = ref_single("scale2", "vector")["y"]
    ctx = Context(devices=devs, platform=plat)
    fn, mk, sc, n, lsz = KCASES["scale2"]
    k = ctx.create_program(bld(fn, TKB)).create_kernel().set_args(**mk())
    co = ctx.create_co_executor(tuning_table=TuningTable())
    for mode in ("static", "steal", "adaptive"):
        out = co.launch(k, (n,), (lsz,), mode=mode)
        assert out["y"].numpy().tobytes() == want.tobytes(), mode
    co.finish()
    assert [device_class(d) for d in devs] == ["vector", "basic", "z"]


# ---------------------------------------------------------------------------
# split_groups (reference tests/test_events.py)
# ---------------------------------------------------------------------------

SPLITS = [(8, [1, 1]), (8, [3, 1]), (7, [1, 1, 1]), (8, [0.2, 0.2]),
          (10, [0.75]), (8, [0.0, 1.0]), (8, [1.0, 0.0]), (1, [1, 1, 1]),
          (2, [1, 1, 1, 1, 1]), (0, [1, 1]), (3, [5, 1, 1, 1]), (1, [1, 3]),
          (100, [1e-9, 1.0])]


@pytest.mark.parametrize("n,shares", SPLITS)
def test_split_groups_equals_reference(n, shares):
    got = split_groups(n, shares)
    assert got == jrt.split_groups(n, shares)
    assert got[0][0] == 0 and got[-1][1] == n
    for (_, e0), (s1, _) in zip(got, got[1:]):
        assert e0 == s1
    assert sum(b - a for a, b in got) == n


@pytest.mark.parametrize("bad", [[], [0.0, 0.0], [-1.0, 2.0],
                                 [float("nan"), 1.0], [float("inf"), 1.0],
                                 ["x", 1.0], [1.0, None]])
def test_split_groups_rejects_degenerate_shares(bad):
    with pytest.raises(InvalidArgError):
        split_groups(8, bad)
    with pytest.raises(jrt.InvalidArgError):
        jrt.split_groups(8, bad)


def test_split_groups_rejects_bad_counts():
    with pytest.raises(InvalidArgError):
        split_groups(-1, [1.0])
    with pytest.raises(InvalidArgError):
        split_groups("eight", [1.0])


# ---------------------------------------------------------------------------
# residency, migration and span-granular invalidation
# ---------------------------------------------------------------------------

def test_residency_copied_once_not_per_launch():
    """8 chunks across 2 devices migrate each buffer once per device; a
    second run migrates only the written buffer, never x."""
    n = 512
    plat = Platform(torch_device="cpu")
    co = CoExecutor(plat.co_devices(2), chunks_per_device=4)
    xs = co.shared_buffer(np.arange(n, dtype=np.float32), "x")
    ys = co.shared_buffer(np.zeros(n, np.float32), "y")
    with pytest.deprecated_call():
        co.run(bld(k_affine, TKB), (64,), (n,), {"x": xs, "y": ys},
               mode="steal")
    st_ = co.last_stats
    assert sum(st_.chunks_per_device.values()) == 8
    assert st_.migrations == 4
    assert st_.residency_hits > 0
    with pytest.deprecated_call():
        co.run(bld(k_affine, TKB), (64,), (n,), {"x": xs, "y": ys},
               mode="steal")
    assert co.last_stats.migrations <= 2
    co.finish()


def test_second_launch_moves_no_read_only_buffer():
    """Static halves over SharedBuffers: a second launch makes no
    transfer of the read-only x, and re-migrates y only over the half
    the other device wrote."""
    n = 512
    ctx = _ctx()
    co = ctx.create_co_executor(ctx.platform.co_devices(2))
    x = co.shared_buffer(np.arange(n, dtype=np.float32), "x")
    y = co.shared_buffer(np.zeros(n, np.float32), "y")
    k = ctx.create_program(bld(k_affine, TKB)).create_kernel()
    k.set_args(x=x, y=y)
    first = co.launch(k, (n,), (64,), mode="static")["y"].numpy().copy()
    assert co.last_stats.migrations == 4
    second = co.launch(k, (n,), (64,), mode="static")["y"].numpy()
    st_ = co.last_stats
    co.finish()
    assert first.tobytes() == second.tobytes()
    assert sorted(e.name.split("->")[0] for e in st_.transfer_events) \
        == ["migrate:y", "migrate:y"]
    assert st_.partial_migrations == 2 and st_.bytes_migrated == n * 4
    want = (np.arange(n, dtype=np.float32) * 2 + 1).astype(np.float32)
    assert second.tobytes() == want.tobytes()


@pytest.mark.parametrize("ndev", [2, 3])
def test_group_range_invalidation_is_span_granular(ndev):
    """Devices write disjoint parts of y: each copy goes stale exactly
    over the parts the others wrote, and a repeat run re-migrates those
    parts only (the reference's numbers)."""
    n = 768
    plat = Platform(torch_device="cpu")
    co = CoExecutor(plat.co_devices(ndev))
    x = co.shared_buffer(np.arange(n, dtype=np.float32), "x")
    y = co.shared_buffer(np.zeros(n, np.float32), "y")
    with pytest.deprecated_call():
        co.run(bld(k_affine, TKB), (64,), (n,), {"x": x, "y": y},
               mode="static")
    part = n // ndev * 4
    for i, d in enumerate(co.devices):
        want = [(0, i * part)] if i else []
        if i < ndev - 1:
            want.append(((i + 1) * part, n * 4))
        assert co.tracker.stale_spans(y.key, d, y.nbytes) == \
            [s for s in want if s[1] > s[0]]
        assert co.tracker.resident(x.key, d)
    with pytest.deprecated_call():
        merged = co.run(bld(k_affine, TKB), (64,), (n,), {"x": x, "y": y},
                        mode="static")
    st_ = co.last_stats
    assert st_.partial_migrations == ndev
    assert st_.bytes_migrated == (ndev - 1) * n * 4
    assert st_.migrations == ndev and st_.residency_hits >= ndev
    expect = np.arange(n, dtype=np.float32) * 2 + 1
    assert merged["y"].numpy().tobytes() == \
        expect.astype(np.float32).tobytes()
    assert all(e.kind == "transfer" and e.succeeded
               for e in st_.transfer_events)
    co.finish()


def test_merge_survives_nan_initialized_buffers():
    n = 256
    plat = Platform(torch_device="cpu")
    co = CoExecutor(plat.co_devices(2))
    x = np.arange(n, dtype=np.float32)
    with pytest.deprecated_call():
        merged = co.run(bld(k_affine, TKB), (64,), (n,),
                        {"x": x, "y": np.full(n, np.nan, np.float32)},
                        mode="static")
    expect = (x * 2 + 1).astype(np.float32)
    assert merged["y"].numpy().tobytes() == expect.tobytes()
    co.finish()


def test_scattered_write_merge_falls_back_to_whole_invalidate():
    mask = torch.zeros(1024, dtype=torch.bool)
    mask[::2] = True
    assert _mask_to_byte_spans(mask, 4) is None
    dense = torch.zeros(1024, dtype=torch.bool)
    dense[100:300] = True
    assert _mask_to_byte_spans(dense, 4) == [(400, 1200)]
    assert _mask_to_byte_spans(torch.zeros(8, dtype=torch.bool), 4) == []
    runs = torch.zeros(16, dtype=torch.bool)
    runs[0:2] = runs[5:6] = runs[15:16] = True
    assert _mask_to_byte_spans(runs, 8) == [(0, 16), (40, 48), (120, 128)]


@pytest.mark.parametrize("seed", [0, 1])
def test_mask_spans_equal_the_reference(seed):
    """The merge's run extraction gives the reference's byte spans (or
    its None past the run cap) on random masks."""
    from repro.runtime.scheduler import _mask_to_byte_spans as j_spans
    rng = np.random.default_rng(seed)
    for _ in range(300):
        n = int(rng.integers(0, 300))
        mask = rng.random(n) < rng.random()
        if n and rng.random() < 0.2:
            mask[:] = False
            mask[rng.integers(0, n):] = True
        for max_runs in (1, 3, 64):
            assert _mask_to_byte_spans(torch.from_numpy(mask), 4,
                                       max_runs) \
                == j_spans(mask, 4, max_runs)


def test_migration_transfers_are_dag_ordered():
    n = 256
    plat = Platform(torch_device="cpu")
    co = CoExecutor(plat.co_devices(2))
    x = co.shared_buffer(np.arange(n, dtype=np.float32), "x")
    y = co.shared_buffer(np.zeros(n, np.float32), "y")
    with pytest.deprecated_call():
        co.run(bld(k_affine, TKB), (64,), (n,), {"x": x, "y": y},
               mode="static")
    st_ = co.last_stats
    assert len(st_.transfer_events) == 4
    by_queue = {}
    for ev in st_.transfer_events:
        by_queue.setdefault(id(ev.queue), []).append(ev)
    for ev in st_.events:
        if ev.kind != "kernel":
            continue
        for t in by_queue.get(id(ev.queue), []):
            assert t.end_ns <= ev.start_ns
    co.finish()


def test_view_initialized_data_identical_on_1_vs_2_device_split():
    """Data staged through a sub-buffer and map writes on a basic
    device, then co-executed: 1 and 2 devices give the same bytes."""
    lsz = 16
    plat = Platform(torch_device="cpu")
    dev = plat.get_devices("basic")[0]
    q = CommandQueue(dev)
    staging = create_buffer(dev, 2 * lsz * lsz, "float32")
    for i, vals in enumerate((np.arange(lsz * lsz, dtype=np.float32),
                              np.arange(lsz * lsz, dtype=np.float32)[::-1])):
        view = create_sub_buffer(staging, i * lsz * lsz * 4, lsz * lsz * 4)
        m = q.enqueue_map_buffer(view, "wi")
        m.get()[...] = vals
        q.enqueue_unmap_buffer(m)
    q.finish()
    host = staging.data.numpy().copy()
    staging.release()
    outs = []
    for ndev in (1, 2):
        co = CoExecutor(plat.co_devices(ndev), chunks_per_device=3)
        with pytest.deprecated_call():
            merged = co.run(bld(k_affine, TKB), (lsz,), (2 * lsz * lsz,),
                            {"x": host,
                             "y": np.zeros(2 * lsz * lsz, np.float32)},
                            mode="steal")
        outs.append(merged["y"].numpy())
        co.finish()
    assert outs[0].tobytes() == outs[1].tobytes()
    expect = host * 2 + 1
    assert outs[0].tobytes() == expect.astype(np.float32).tobytes()


def test_residency_tracker_contract():
    tr = ResidencyTracker()
    assert tr.acquire("b", "d0") is True
    assert tr.acquire("b", "d0") is False
    assert tr.acquire("b", "d1") is True
    tr.wrote("b", "d1")
    assert tr.acquire("b", "d0") is True
    assert tr.resident("b", "d1")
    tr.drop("b")
    assert not tr.resident("b", "d1")
    assert tr.stats()["migrations"] == 3 and tr.stats()["hits"] == 1


# ---------------------------------------------------------------------------
# the host API around the executor (reference tests/test_host_api.py)
# ---------------------------------------------------------------------------

def test_launch_path_buffer_class_checks():
    ctx = _ctx()
    k = ctx.create_program(bld(k_scale, TKB)).create_kernel()
    k.set_args(x=ctx.create_buffer(64), s=2.0)
    co = ctx.create_co_executor(ctx.platform.co_devices(2))
    with pytest.raises(InvalidArgError, match="accepts"):
        co.launch(k, (64,), (8,))


def test_bitwise_single_vs_co_executed_same_kernel():
    """One Kernel object: single-device and co-executed launches equal
    bitwise; one compile per co-device, none on the second mode, and
    one plan build for all devices."""
    ctx = _ctx()
    kernel = ctx.create_program(bld(k_reduce, TKB)).build().create_kernel()
    rng = np.random.default_rng(7)
    kernel.set_args(inp=rng.standard_normal(256).astype(np.float32),
                    out=np.zeros(32, np.float32))
    single = ctx.launch(kernel, (256,), (8,))
    devs = ctx.platform.co_devices(2)
    co = ctx.create_co_executor(devs)
    for mode in ("static", "steal"):
        merged = co.launch(kernel.clone(), (256,), (8,), mode=mode)
        for nm in ("out", "inp"):
            assert merged[nm].numpy().tobytes() == \
                single[nm].numpy().tobytes()
    co.finish()
    assert [d.cache_stats()["compiles"] for d in devs] == [1, 1]
    assert ctx.cache.stats.plan_builds == 1


def test_deprecated_coexecutor_run_still_works():
    ctx = _ctx()
    co = ctx.create_co_executor(ctx.platform.co_devices(2))
    host = np.arange(64, dtype=np.float32)
    with pytest.deprecated_call():
        merged = co.run(bld(k_scale, TKB), (8,), (64,), {"x": host.copy()},
                        {"s": 3.0})
    assert merged["x"].numpy().tobytes() == (host * 3.0).tobytes()
    co.finish()


def test_context_adopts_platform_devices_and_scopes_explicit_lists():
    """A platform-spanning context adopts devices the platform grows
    later; a context over an explicit list refuses them."""
    ctx = _ctx()
    devs = ctx.platform.co_devices(2)
    assert all(d in ctx.devices for d in
               ctx.create_co_executor(devs).devices)
    plat = Platform(torch_device="cpu")
    fixed = Context(devices=plat.get_devices("vector"), platform=plat)
    with pytest.raises(InvalidArgError, match="not part of this context"):
        fixed.create_co_executor(plat.co_devices(1))
    names = [d.info.name for d in plat.devices]
    assert len(names) == len(set(names))
    with pytest.raises(InvalidArgError, match="needs a CUDA device"):
        plat.co_devices(1, driver="cuda")


def test_fused_chain_coexec_two_devices_bitwise():
    """The stitched rmsnorm -> residual -> quantize kernel co-executed
    over 1 and 2 devices: equal to the unfused queue's result."""
    from repro_torch.core.examples import (build_quantize,
                                           build_residual_add,
                                           build_rmsnorm_ew)
    from repro_torch.core.fusion import ChainEdge, build_fused_spec
    n, lsz = 1024, (64,)
    rng = np.random.default_rng(3)
    xh, wh, rh = (rng.standard_normal(n).astype(np.float32)
                  for _ in range(3))
    ctx = _ctx()
    chain = ctx.create_program(build_rmsnorm_ew, build_residual_add,
                               build_quantize)
    bufs = {c: ctx.create_buffer(n) for c in "xwryzq"}
    q = ctx.create_queue(fusion="off")
    for c, h in zip("xwr", (xh, wh, rh)):
        q.enqueue_write_buffer(bufs[c], h)
    k1, k2, k3 = (chain.create_kernel(nm) for nm in
                  ("rmsnorm_ew", "residual_add", "quantize"))
    k1.set_args(x=bufs["x"], w=bufs["w"], y=bufs["y"], inv_rms=0.5)
    k2.set_args(y=bufs["y"], r=bufs["r"], z=bufs["z"])
    k3.set_args(z=bufs["z"], q=bufs["q"], scale=16.0)
    for k in (k1, k2, k3):
        q.enqueue_nd_range(k, (n,), lsz)
    q.finish()
    q_ref = bufs["q"].data.numpy().copy()
    spec = build_fused_spec(
        [build_rmsnorm_ew, build_residual_add, build_quantize],
        ["rmsnorm_ew", "residual_add", "quantize"],
        [ChainEdge(0, 1, "y", "y", True), ChainEdge(1, 2, "z", "z", True)],
        [[(0, "y"), (1, "y")], [(1, "z"), (2, "z")]],
        cache=ctx.devices[0].compile_cache)
    kern = spec.program.create_kernel(spec.kernel_name)
    kern.set_args(k0_x=xh, k0_w=wh, k1_r=rh, k2_q=np.zeros(n, np.float32),
                  k0_inv_rms=0.5, k2_scale=16.0)
    out1 = ctx.create_co_executor(ctx.devices[:1]).launch(
        kern, (n,), lsz)["k2_q"].numpy()
    out2 = ctx.create_co_executor(ctx.platform.co_devices(2)).launch(
        kern.clone(), (n,), lsz)["k2_q"].numpy()
    assert out1.tobytes() == q_ref.tobytes()
    assert out1.tobytes() == out2.tobytes()


# ---------------------------------------------------------------------------
# the scheduler in virtual time (reference tests/test_coexec_props.py)
# ---------------------------------------------------------------------------

class SplitDriver:
    """Simulates the co-executor's adaptive dispatch loop in virtual
    time: symbolic devices with true speeds (groups/sec), one in-flight
    chunk per device, completion-ordered callbacks, optional one-shot
    stalls and mid-run speed changes — ``CoExecutor._co_run``'s
    adaptive mode, so its invariants are the scheduler's.  As the
    port's executor does, it feeds the model each device's groups over
    its chunks' seconds so far (``chunk_rate=False``; True observes each
    chunk alone, as the reference's executor does)."""

    def __init__(self, speeds, n_groups, min_chunk=1, divisor=2.0,
                 alpha=0.5, seed_weights=None, chunk_rate=False):
        self.chunk_rate = chunk_rate
        self.overheads = {}          # device -> seconds a chunk costs extra
        self.busy = {}
        self.devices = [f"dev{i}" for i in range(len(speeds))]
        self.speed = dict(zip(self.devices, [float(s) for s in speeds]))
        self.model = ThroughputModel(alpha=alpha)
        if seed_weights is not None:
            for d, w in zip(self.devices, seed_weights):
                self.model.seed(d, w)
        self.split = AdaptiveSplitter(n_groups, self.devices, self.model,
                                      min_chunk=min_chunk, divisor=divisor)
        self.n_groups = int(n_groups)
        self.stalls = {d: 0.0 for d in self.devices}
        self.fresh_spans, self.steal_spans, self.completions = [], [], []
        self.finished_at = None

    def add_stall(self, device, seconds):
        self.stalls[device] += float(seconds)

    def set_speed(self, device, speed):
        self.speed[device] = float(speed)

    def _check_weights(self):
        w = self.model.weights(self.devices)
        assert len(w) == len(self.devices)
        assert all(math.isfinite(x) and x > 0 for x in w), w
        assert abs(sum(w) - 1.0) < 1e-9, w

    def _dispatch(self, device, now, active):
        steals_before = self.split.steals[device]
        span = self.split.next_chunk(device)
        if span is None:
            return
        if self.split.steals[device] > steals_before:
            self.steal_spans.append((device, span))
        else:
            self.fresh_spans.append((device, span))
        stall, self.stalls[device] = self.stalls[device], 0.0
        dur = stall + self.overheads.get(device, 0.0) \
            + (span[1] - span[0]) / self.speed[device]
        active[device] = (span, now, now + dur)

    def run(self, max_events=100000):
        active = {}
        for d in self.devices:
            self._dispatch(d, 0.0, active)
        events = 0
        while active:
            events += 1
            assert events < max_events, "scheduler failed to terminate"
            d = min(active, key=lambda k: active[k][2])
            span, t0, t1 = active.pop(d)
            g, sec = self.busy.get(d, (0, 0.0))
            g, sec = g + span[1] - span[0], sec + t1 - t0
            self.busy[d] = (g, sec)
            if self.chunk_rate:
                g, sec = span[1] - span[0], t1 - t0
            self.model.observe(d, g, sec)
            self._check_weights()
            if self.split.complete(d, span):
                self.finished_at = t1
            self.completions.append((d, span, t1))
            if self.finished_at is None:
                self._dispatch(d, t1, active)
        self.check_invariants()
        return self

    def check_invariants(self):
        spans = sorted(s for _, s in self.fresh_spans)
        if self.n_groups == 0:
            assert spans == [] and self.split.finished
            return
        assert spans[0][0] == 0 and spans[-1][1] == self.n_groups
        for (_, e0), (s1, _) in zip(spans, spans[1:]):
            assert e0 == s1, f"gap or overlap in fresh spans: {spans}"
        assert all(b > a for a, b in spans)
        assert self.finished_at is not None and self.split.finished
        fresh = [s for _, s in self.fresh_spans]
        for d, s in self.steal_spans:
            assert s in fresh
            owner = [dd for dd, ss in self.fresh_spans if ss == s]
            assert owner and owner[0] != d
        assert len(set(self.steal_spans)) == len(self.steal_spans)
        for d in self.devices:
            mine = [s for dd, s in self.fresh_spans + self.steal_spans
                    if dd == d]
            assert self.split.chunks[d] == len(mine)
            assert self.split.dispensed[d] == sum(b - a for a, b in mine)
            assert self.split.steals[d] == \
                len([1 for dd, _ in self.steal_spans if dd == d])
        self._check_weights()


def _rand_driver(rng, **overrides):
    n_dev = overrides.pop("n_dev", rng.randint(1, 6))
    speeds = overrides.pop(
        "speeds", [10 ** rng.uniform(-1.5, 1.5) for _ in range(n_dev)])
    kw = dict(n_groups=rng.randint(0, 200), min_chunk=rng.randint(1, 8),
              divisor=rng.uniform(1.0, 4.0), alpha=rng.uniform(0.1, 1.0))
    kw.update(overrides)
    return SplitDriver(speeds, **kw)


@pytest.mark.parametrize("seed", [0xC0E3EC, 1, 2])
def test_split_driver_random_walks(seed):
    rng = random.Random(seed)
    for _ in range(60):
        drv = _rand_driver(rng)
        for d in drv.devices:
            if rng.random() < 0.3:
                drv.add_stall(d, rng.uniform(0.0, 50.0))
        if rng.random() < 0.5:
            drv.set_speed(rng.choice(drv.devices),
                          10 ** rng.uniform(-1.5, 1.5))
        drv.run()


def test_stalled_device_never_strands_work():
    for seed in range(5):
        rng = random.Random(seed)
        stall = 1e6
        drv = _rand_driver(rng, n_dev=3, speeds=[100.0, 100.0, 50.0],
                           n_groups=rng.randint(30, 120))
        drv.add_stall(drv.devices[2], stall)
        drv.run()
        assert drv.finished_at < drv.n_groups / 100.0 + 1.0
        assert [s for _, s in drv.steal_spans]


def test_launch_rate_survives_command_overhead():
    """ROADMAP C.11, phase 14 (d)'s pair in virtual time: a card (1e8
    groups/s, 0.3 ms a chunk) and a host 500x slower (2 ms a chunk),
    six launches of 262,144 groups sharing one model.  Observed chunk by
    chunk (the reference's executor), the card's tail chunks of one
    group time its command, and its weight flips between launches;
    observed over the launch (the port's), it stays above 0.98."""
    trace = {}
    for chunk_rate in (True, False):
        model, trace[chunk_rate] = ThroughputModel(), []
        for _ in range(6):
            drv = SplitDriver([1e8, 2e5], 262144, chunk_rate=chunk_rate)
            drv.model = model
            drv.split = AdaptiveSplitter(262144, drv.devices, model)
            drv.overheads = {"dev0": 3e-4, "dev1": 2e-3}
            drv.run()
            trace[chunk_rate].append(model.weights(drv.devices)[0])
    assert min(trace[False]) > 0.98, trace
    assert min(trace[True]) < 0.5, trace


def test_weights_converge_to_speed_ratio():
    drv = SplitDriver([100.0, 100.0, 20.0], n_groups=400, min_chunk=2)
    drv.run()
    ideal = [100 / 220, 100 / 220, 20 / 220]
    for got, want in zip(drv.model.weights(drv.devices), ideal):
        assert abs(got - want) < 0.12


def test_weights_match_the_reference_on_ordinary_rates():
    """On rates a few decades apart the port's normalization (by the
    largest rate) gives the reference's weights to a few ulps."""
    rng = random.Random(3)
    for _ in range(50):
        ours, theirs = ThroughputModel(), jrt.ThroughputModel()
        devs = [f"d{i}" for i in range(rng.randint(1, 5))]
        for _ in range(rng.randint(0, 12)):
            d, g, t = (rng.choice(devs), rng.randint(1, 100),
                       10 ** rng.uniform(-4, 1))
            assert ours.observe(d, g, t) == theirs.observe(d, g, t)
        for a, b in zip(ours.weights(devs), theirs.weights(devs)):
            assert a == pytest.approx(b, rel=1e-12)


def test_throughput_model_degenerate_observations():
    m = ThroughputModel(alpha=0.5)
    devs = ["a", "b"]
    assert m.observe("a", 10, 0.1)
    baseline = m.weights(devs)
    for groups, seconds in [(0, 1.0), (-5, 1.0), (10, 0.0), (10, -1.0),
                            (float("nan"), 1.0), (10, float("nan")),
                            (10, float("inf")), (None, 1.0), (10, "x")]:
        assert not m.observe("a", groups, seconds)
        assert not m.observe("b", groups, seconds)
    assert m.weights(devs) == baseline
    assert m.rate("b") is None
    for bad in (0.0, -1.0, float("nan"), float("inf"), None, "x"):
        assert not m.seed("b", bad)
    w = m.weights(devs)
    assert abs(sum(w) - 1.0) < 1e-9 and all(x > 0 for x in w)
    for alpha in (0.0, 1.5):
        with pytest.raises(InvalidArgError):
            ThroughputModel(alpha=alpha)


def test_c6_weights_stay_positive_where_the_reference_underflows():
    """ROADMAP C.6's falsifying example: rates 1e107 and 1e-220 groups/s.
    The reference divides raw rates by their sum and gives the slow
    device a weight of exactly 0; the port's stays positive and finite,
    and the weights still sum to 1."""
    models = {}
    for pkg, M in (("port", ThroughputModel), ("ref", jrt.ThroughputModel)):
        m = models[pkg] = M(alpha=0.5)
        assert m.observe("d0", 1e103, 1e-4)
        assert m.observe("d1", 1.0, 1e220)
    assert models["ref"].weights(["d0", "d1"])[1] == 0.0
    m = models["port"]
    for devs in (["d0", "d1"], ["d0", "d1", "cold"]):
        w = m.weights(devs)
        assert all(math.isfinite(x) and x > 0 for x in w), w
        assert abs(sum(w) - 1.0) < 1e-9
        assert w[1] < 1e-11
    # the splitter still gives the slow device a chunk of min_chunk
    s = AdaptiveSplitter(10, ["d0", "d1"], m, min_chunk=1)
    assert s.next_chunk("d1") == (0, 1)


@pytest.mark.parametrize("rates", [(5.992310449541053e+307,),
                                   (1.7976931348623157e308,) * 2])
def test_c6_weights_stay_finite_where_the_reference_overflows(rates):
    """C.6's other falsifying example: one rate near the largest double
    and two devices still cold.  The reference sums the raw rates, the
    sum overflows to inf and every weight is 0; the port divides by the
    largest rate first, so the cold devices get the mean share.  (With
    two such rates the reference's cold share is inf / inf, a NaN.)"""
    devs = ["d0", "d1", "d2"]
    models = {}
    for pkg, M in (("port", ThroughputModel), ("ref", jrt.ThroughputModel)):
        m = models[pkg] = M(alpha=0.5)
        for d, r in zip(devs, rates):
            assert m.observe(d, r, 1.0)
    ref = models["ref"].weights(devs)
    assert ref[:2] == [0.0, 0.0] and not ref[2] > 0
    w = models["port"].weights(devs)
    assert all(math.isfinite(x) and x > 0 for x in w), w
    assert abs(sum(w) - 1.0) < 1e-9
    assert w == pytest.approx([1 / 3] * 3)


def test_throughput_model_seed_replaced_by_first_measurement():
    m = ThroughputModel(alpha=0.5)
    assert m.seed("a", 0.9) and m.seed("b", 0.1)
    assert m.weights(["a", "b"])[0] == pytest.approx(0.9)
    m.observe("a", 100, 1.0)
    assert m.rate("a") == pytest.approx(100.0)
    m.observe("a", 200, 1.0)
    assert m.rate("a") == pytest.approx(150.0)
    assert not m.seed("a", 5.0)
    assert m.rate("a") == pytest.approx(150.0)


def test_adaptive_splitter_basics():
    m = ThroughputModel()
    s = AdaptiveSplitter(10, ["a", "b"], m, min_chunk=1, divisor=2.0)
    assert s.next_chunk("a") == (0, 3)
    assert s.next_chunk("b") == (3, 5)
    spans = [(0, 3), (3, 5)]
    while spans[-1][1] < 10:
        spans.append(s.next_chunk("a"))
    assert all(e0 == s1 for (_, e0), (s1, _) in zip(spans, spans[1:]))
    fired = [sp for sp in spans if s.complete("a", sp)]
    assert fired == [spans[-1]] and s.finished
    assert s.dispensed["a"] + s.dispensed["b"] == 10
    assert s.steals == {"a": 0, "b": 0}
    assert AdaptiveSplitter(0, ["a"], m).finished
    for kw in ({"devices": []}, {"min_chunk": 0}, {"divisor": 0.5}):
        args = dict(n_groups=4, devices=["a"], model=m)
        args.update(kw)
        with pytest.raises(InvalidArgError):
            AdaptiveSplitter(**args)


def test_adaptive_splitter_steals_only_when_frontier_empty():
    m = ThroughputModel()
    s = AdaptiveSplitter(8, ["a", "b"], m, min_chunk=1, divisor=2.0)
    first = s.next_chunk("a")
    while True:
        sp = s.next_chunk("b")
        if sp is None or s.steals["b"] > 0:
            break
    assert s.steals["b"] == 1 and sp == first
    assert s.next_chunk("b") is None
    fired = sum(s.complete(d, span) for d, span in
                [("a", first)] + [("b", x) for x in s.pending_spans()])
    assert s.finished and fired == 1


# ---------------------------------------------------------------------------
# real launches over lopsided platforms (ThrottledDevice)
# ---------------------------------------------------------------------------

# simulated per-group costs must dominate the per-chunk host overhead, or
# the observed speed ratio compresses under load; a chunk of the port's
# torch targets costs 1-3 ms on the host (the reference's jitted one
# about 0.1 ms), so the reference's 1 ms / 8 ms become 4 ms / 32 ms:
# the same 8x ratio
FAST_S = 0.004
SLOW_S = 0.032
NL, LSZ_L = 96 * 16, 16


def make_sim_device(i, seconds_per_group, cls, **kw):
    return ThrottledDevice(DeviceInfo(
        name=f"sim-{cls}-{i}", driver="vector", global_mem_size=1 << 30,
        local_mem_size=1 << 20, max_work_group_size=1024, compute_units=1),
        "cpu", seconds_per_group=seconds_per_group, coexec_class=cls, **kw)


def lopsided_platform():
    return [make_sim_device(0, FAST_S, "fast"),
            make_sim_device(1, FAST_S, "fast"),
            make_sim_device(2, SLOW_S, "slow")]


def _lopsided_kernel(ctx):
    k = ctx.create_program(bld(k_scale2, TKB)).build().create_kernel()
    return k.set_args(x=np.arange(NL, dtype=np.float32),
                      y=np.zeros(NL, np.float32))


def _ref_lopsided():
    jctx = _jctx()
    k = jctx.create_program(bld(k_scale2, JKB)).create_kernel()
    k.set_args(x=np.arange(NL, dtype=np.float32), y=np.zeros(NL, np.float32))
    return np.asarray(jctx.launch(k, (NL,), (LSZ_L,))["y"]).tobytes()


def test_adaptive_bitwise_identical_every_interleaving():
    devs = lopsided_platform()
    ctx = Context(devices=devs, platform=Platform(torch_device="cpu"))
    k = _lopsided_kernel(ctx)
    co = ctx.create_co_executor(devs, tuning_table=TuningTable())
    ref = _ref_lopsided()
    rng = random.Random(7)
    for i in range(6):
        if rng.random() < 0.5:
            devs[2].stall(rng.uniform(0.01, 0.08))
        out = co.launch(k, (NL,), (LSZ_L,), mode="adaptive")
        assert out["y"].numpy().tobytes() == ref, f"launch {i}"
        st_ = co.last_stats
        assert st_.mode == "adaptive" and st_.n_groups == NL // LSZ_L
        w = st_.weights
        assert abs(sum(w.values()) - 1.0) < 1e-9
        assert all(math.isfinite(x) and x > 0 for x in w.values())
    co.finish()


@pytest.mark.parametrize("window", [True, False])
def test_throttled_device_charges_time_and_windows_chunks(window):
    """A throttled device runs the real kernel (bitwise) and charges
    ``seconds_per_group`` per executed group plus an armed stall, on an
    injected clock; windowed or not, a chunk writes its own span."""
    slept = []
    dev = make_sim_device(0, 0.5, "t", sleep=slept.append,
                          window_chunks=window)
    ctx = Context(devices=[dev], platform=Platform(torch_device="cpu"))
    k = _lopsided_kernel(ctx)
    binary = k.bind(dev, (LSZ_L,))
    x = torch.arange(NL, dtype=torch.float32)
    y = torch.zeros(NL)
    dev.stall(2.0)
    binary.launch_ndrange({"x": x, "y": y}, (NL,), group_range=(3, 5))
    assert slept == [2.0 + 2 * 0.5]
    want = x * 2 + torch.arange(NL, dtype=torch.float32)
    assert torch.equal(y[3 * LSZ_L:5 * LSZ_L], want[3 * LSZ_L:5 * LSZ_L])
    assert int(torch.count_nonzero(y[:3 * LSZ_L])) == 0
    out = binary({"x": x.numpy(), "y": np.zeros(NL, np.float32)}, (NL,))
    assert slept[-1] == NL // LSZ_L * 0.5
    assert out["y"].numpy().tobytes() == _ref_lopsided()


def test_one_plan_build_across_n_heterogeneous_devices():
    devs = lopsided_platform()
    ctx = Context(devices=devs, platform=Platform(torch_device="cpu"))
    k = _lopsided_kernel(ctx)
    co = ctx.create_co_executor(devs, tuning_table=TuningTable())
    co.launch(k, (NL,), (LSZ_L,), mode="adaptive")
    assert ctx.cache.stats.plan_builds == 1
    co.finish()


def test_coexec_stats_consistent_with_event_timeline():
    devs = lopsided_platform()
    ctx = Context(devices=devs, platform=Platform(torch_device="cpu"))
    k = _lopsided_kernel(ctx)
    co = ctx.create_co_executor(devs, tuning_table=TuningTable())
    devs[2].stall(0.05)                    # force at least one steal
    co.launch(k, (NL,), (LSZ_L,), mode="adaptive")
    st_ = co.last_stats
    co.finish()                            # drain stragglers first
    rows = chunk_counters(st_.events, kind="kernel")
    assert all(r["ok"] for r in rows)
    by_dev, spans = {}, {}
    for r in rows:
        _, dev_name, span = str(r["name"]).split(":")
        lo, hi = map(int, span.split("-"))
        by_dev[dev_name] = by_dev.get(dev_name, 0) + 1
        spans.setdefault((lo, hi), []).append(dev_name)
    assert by_dev == st_.chunks_per_device
    for name, count in st_.groups_per_device.items():
        assert count == sum(hi - lo for (lo, hi), ds in spans.items()
                            for d in ds if d == name)
    dup = sum(len(ds) - 1 for ds in spans.values())
    assert dup == sum(st_.steals_per_device.values()) >= 1
    merged = []
    for lo, hi in sorted(spans):
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    assert merged == [(0, st_.n_groups)]
    overlap = st_.migration_overlap_s()
    total = sum(r["duration_s"] for r in chunk_counters(st_.transfer_events))
    assert 0.0 <= overlap <= total + 1e-9
    assert st_.migrations == 6
    assert st_.merge_s > 0 and st_.bytes_to_host == 0


def test_warm_tuning_table_converges_within_two_launches():
    """A fresh executor warm-started from a persisted TuningTable is
    near the converged lopsided split from its first launch; the table
    entry is the reference's format, keyed by the same IR hash."""
    table = TuningTable()
    devs = lopsided_platform()
    ctx = Context(devices=devs, platform=Platform(torch_device="cpu"))
    k = _lopsided_kernel(ctx)
    co = ctx.create_co_executor(devs, tuning_table=table)
    co.launch(k, (NL,), (LSZ_L,), mode="static")
    for _ in range(4):
        co.launch(k, (NL,), (LSZ_L,), mode="adaptive")
    co.finish()
    key = TuningTable.make_coexec_key(k.ir_hash,
                                      [device_class(d) for d in devs])
    jk = _jctx().create_program(bld(k_scale2, JKB)).create_kernel()
    assert key == JTuningTable.make_coexec_key(jk.ir_hash,
                                               ["fast", "fast", "slow"])
    ent = table.get_coexec(key)
    assert ent is not None and ent["launches"] == 4
    assert ent["weights"]["slow"] < 0.25, ent

    devs2 = lopsided_platform()
    ctx2 = Context(devices=devs2, platform=Platform(torch_device="cpu"))
    k2 = _lopsided_kernel(ctx2)
    co2 = ctx2.create_co_executor(devs2, tuning_table=table)
    co2.launch(k2, (NL,), (LSZ_L,), mode="static")
    for _ in range(2):
        co2.launch(k2, (NL,), (LSZ_L,), mode="adaptive")
        st_ = co2.last_stats
    co2.finish()
    slow = devs2[2].info.name
    assert st_.weights[slow] < 0.2, st_.weights
    assert st_.groups_per_device.get(slow, 0) < st_.n_groups / 2


class LateStartDevice(ThrottledDevice):
    """A device whose armed stall delays the *start* of its next chunk,
    as another tenant holding it would: the chunk reads its copy only
    after the stall."""

    def compile(self, build, local_size, **opts):
        inner = super().compile(build, local_size, **opts)
        dev = self

        class Late:
            def __getattr__(self, name):
                return getattr(inner, name)

            def launch_ndrange(self, buffers, global_size, scalars=None,
                               group_range=None):
                delay = dev._consume_stall()
                if delay:
                    time.sleep(delay)
                return inner.launch_ndrange(buffers, global_size, scalars,
                                            group_range)
        return Late()


def test_next_launch_waits_for_a_straggler_running_in_place():
    """Adaptive mode returns at the merge gate while a stolen straggler
    may still be running in place on its device's copy.  With an
    in-place kernel (x = x * s) over one SharedBuffer, the next launch
    moves data onto that copy and runs chunks there only after the
    straggler has ended, and three launches give the reference's three
    single launches bitwise."""
    n, lsz = 64 * 16, 16
    info = DeviceInfo(name="sim-late-2", driver="vector",
                      global_mem_size=1 << 30, local_mem_size=1 << 20,
                      max_work_group_size=1024, compute_units=1)
    late = LateStartDevice(info, "cpu", coexec_class="late",
                           window_chunks=False)
    devs = [make_sim_device(0, 0.0, "fast"), make_sim_device(1, 0.0, "fast"),
            late]
    ctx = Context(devices=devs, platform=Platform(torch_device="cpu"))
    host = np.random.default_rng(5).standard_normal(n, dtype=np.float32)
    co = ctx.create_co_executor(devs, tuning_table=TuningTable())
    k = ctx.create_program(bld(k_scale, TKB)).build().create_kernel()
    k.set_args(x=co.shared_buffer(host, "x"), s=3.0)
    jctx = _jctx()
    jk = jctx.create_program(bld(k_scale, JKB)).create_kernel()
    wants = [host]
    for _ in range(3):
        jk.set_args(x=wants[-1], s=3.0)
        wants.append(np.asarray(jctx.launch(jk, (n,), (lsz,))["x"]))
    late.stall(0.3)
    outs, stats = [], []
    for _ in range(3):
        outs.append(co.launch(k, (n,), (lsz,), mode="adaptive")["x"])
        stats.append(co.last_stats)
    co.finish()
    for i, (out, want) in enumerate(zip(outs, wants[1:])):
        assert out.numpy().tobytes() == want.tobytes(), f"launch {i}"
    first, second = stats[0], stats[1]
    stragglers = [e for e in first.events if e.kind == "kernel"
                  and e.name.startswith(f"co-adaptive:{info.name}:")]
    assert stragglers and first.steals_per_device[devs[0].info.name] \
        + first.steals_per_device[devs[1].info.name] >= 1
    ended = max(e.end_ns for e in stragglers)
    started = [e.start_ns for e in second.events + second.transfer_events
               if e.start_ns is not None]
    assert started and min(started) >= ended


def test_observe_event_folds_a_devices_chunks_over_the_launch():
    """``observe_event`` observes a device's groups over its chunks'
    seconds so far in the launch (ROADMAP C.11): a one-group tail chunk
    that takes as long as the device's first chunk does not make it look
    100 times slower.  ``start_launch`` starts the totals again."""
    def ev(seconds, done=True):
        return SimpleNamespace(name="c", kind="kernel", done=done,
                               succeeded=True, profile={}, queued_ns=0,
                               start_ns=0, end_ns=int(seconds * 1e9))
    m = ThroughputModel(alpha=1.0)
    m.start_launch()
    assert m.observe_event("a", 100, ev(1.0))
    assert m.observe_event("a", 1, ev(1.0))
    assert m.rate("a") == 101 / 2.0
    assert not m.observe_event("a", 5, ev(1.0, done=False))
    m.start_launch()
    assert m.observe_event("a", 10, ev(0.5))
    assert m.rate("a") == 20.0


# ---------------------------------------------------------------------------
# hypothesis: minimized traces and the stateful machine (derandomized)
# ---------------------------------------------------------------------------

if HAVE_HYPOTHESIS:
    @settings(derandomize=True, max_examples=40)
    @given(st.data())
    def test_split_driver_hypothesis_traces(data):
        n_dev = data.draw(st.integers(1, 5), label="n_dev")
        speeds = data.draw(st.lists(
            st.floats(0.05, 500.0, allow_nan=False, allow_infinity=False),
            min_size=n_dev, max_size=n_dev), label="speeds")
        drv = SplitDriver(
            speeds, data.draw(st.integers(0, 150), label="n_groups"),
            min_chunk=data.draw(st.integers(1, 6), label="min_chunk"),
            divisor=data.draw(st.floats(1.0, 4.0), label="divisor"),
            alpha=data.draw(st.floats(0.05, 1.0), label="alpha"))
        for d in drv.devices:
            if data.draw(st.booleans(), label=f"stall?{d}"):
                drv.add_stall(d, data.draw(st.floats(0.0, 100.0),
                                           label=f"stall{d}"))
        drv.run()

    class PortCoexecMachine(RuleBasedStateMachine):
        """The splitter and the model under an adversarial interleaving
        of dispenses, completions in any order, steals and arbitrary —
        degenerate and 1e300-apart — observations: the dispense
        partition, the steal discipline and the weights' normalization
        hold after every step."""

        @initialize(n_groups=st.integers(0, 120), n_dev=st.integers(1, 4),
                    min_chunk=st.integers(1, 5))
        def setup(self, n_groups, n_dev, min_chunk):
            self.devices = [f"d{i}" for i in range(n_dev)]
            self.model = ThroughputModel(alpha=0.5)
            self.split = AdaptiveSplitter(n_groups, self.devices,
                                          self.model, min_chunk=min_chunk)
            self.n_groups = n_groups
            self.fresh, self.stolen, self.inflight = [], [], []

        def _dev(self, i):
            return self.devices[i % len(self.devices)]

        @rule(i=st.integers(0, 3))
        def dispense(self, i):
            d = self._dev(i)
            before = self.split.steals[d]
            span = self.split.next_chunk(d)
            if span is None:
                return
            if self.split.steals[d] > before:
                assert (d, span) not in self.stolen
                self.stolen.append((d, span))
                assert sum(b - a for _, (a, b) in self.fresh) \
                    == self.n_groups
            else:
                self.fresh.append((d, span))
            self.inflight.append((d, span))

        @rule(j=st.integers(0, 200))
        def complete_one(self, j):
            if not self.inflight:
                return
            d, span = self.inflight.pop(j % len(self.inflight))
            was_finished = self.split.finished
            if self.split.complete(d, span):
                assert not was_finished, "finished fired twice"

        @rule(i=st.integers(0, 3),
              groups=st.one_of(st.integers(-5, 50),
                               st.floats(allow_nan=True)),
              seconds=st.one_of(st.floats(allow_nan=True),
                                st.floats(0.0001, 10.0)))
        def observe(self, i, groups, seconds):
            self.model.observe(self._dev(i), groups, seconds)

        @rule(i=st.integers(0, 3), k=st.integers(-300, 300))
        def observe_extreme(self, i, k):
            # C.6's shape: rates hundreds of decades apart
            self.model.observe(self._dev(i), 10.0 ** abs(k) if k >= 0
                               else 1.0, 1.0 if k >= 0 else 10.0 ** -k)

        @invariant()
        def weights_normalized_finite(self):
            if not hasattr(self, "model"):
                return
            w = self.model.weights(self.devices)
            assert all(math.isfinite(x) and x > 0 for x in w), w
            assert abs(sum(w) - 1.0) < 1e-9

        @invariant()
        def fresh_spans_prefix_partition(self):
            if not hasattr(self, "split"):
                return
            covered = 0
            for a, b in sorted(s for _, s in self.fresh):
                assert a == covered and b > a
                covered = b
            assert covered <= self.n_groups

        @invariant()
        def finished_only_after_full_dispensation(self):
            if not hasattr(self, "split"):
                return
            if self.split.finished and self.n_groups:
                assert sum(b - a for a, b in {s for _, s in self.fresh}) \
                    >= self.n_groups

    PortCoexecMachine.TestCase.settings = settings(
        derandomize=True, max_examples=25, stateful_step_count=30)
    TestPortCoexecMachine = PortCoexecMachine.TestCase
