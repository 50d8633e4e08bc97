"""The port's autotuner (``repro_torch.core.autotune``) and its ``auto``
device, held against the reference's (``repro.core.autotune``).

On the CPU the candidates are ``loop`` and ``vector``: ``cuda`` is a
candidate only where the launch's device is a CUDA device, and is left
out here, not failed.  Outputs are held bitwise against the reference's
launches and the ``vector`` target on the same numpy inputs.  The tuning
table is the reference's format: a file the reference writes loads in
the port under the same keys, and a winner or pin naming the reference's
``pallas`` target is tuned again, never launched.  Launches are in place
on a queue, so an ``auto`` kernel tunes on clones and then runs the
winner once: ``x[g] = x[g] * s`` gives ``x * s``, not ``x * s**5``.
"""

import threading
import time
import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.core as jcore  # noqa: E402
import repro.runtime as jrt  # noqa: E402
from repro.core import KernelBuilder as JKB  # noqa: E402
from repro.suite import SUITE as J_SUITE  # noqa: E402

from repro_torch.core import (AutotunedKernel, BuildError,  # noqa: E402
                              CompilationCache, KernelBuilder as TKB,
                              TuningTable, ir_hash, set_default_table)
from repro_torch.core import autotune  # noqa: E402
from repro_torch.core.api import _compile_kernel  # noqa: E402
from repro_torch.runtime import (CommandQueue, Context, Platform,  # noqa: E402
                                 create_buffer)
from repro_torch.suite import SUITE  # noqa: E402


def vecadd(KB):
    b = KB("vecadd")
    A, B, C = (b.arg_buffer(n, "float32") for n in "ABC")
    gid = b.global_id(0)
    C[gid] = A[gid] + B[gid]
    return b.finish()


def scale(KB, name="scale"):
    b = KB(name)
    x = b.arg_buffer("x", "float32")
    s = b.arg_scalar("s", "float32")
    g = b.global_id(0)
    x[g] = x[g] * s
    return b.finish()


def bld(fn, KB, *args):
    return lambda: fn(KB, *args)


def _bufs(n=32):
    rng = np.random.default_rng(n)
    return {"A": rng.integers(-9, 9, n).astype(np.float32),
            "B": rng.integers(-9, 9, n).astype(np.float32),
            "C": np.zeros(n, np.float32)}


def _kernel(table, candidates=("loop", "vector"), build=None, **kw):
    build = build or bld(vecadd, TKB)
    return AutotunedKernel(build(), build, (8,), {}, candidates, table,
                           CompilationCache(), _compile_kernel, **kw)


@pytest.fixture
def default_table():
    """A private process-default table for the test, restored after."""
    table = TuningTable()
    set_default_table(table)
    yield table
    set_default_table(None)


# ---------------------------------------------------------------------------
# AutotunedKernel (reference tests/test_cache.py:200-302)
# ---------------------------------------------------------------------------

def test_autotuner_records_and_reuses_winner(tmp_path):
    path = str(tmp_path / "tuning.json")
    table = TuningTable(path)
    k = _kernel(table)
    bufs = _bufs()
    out = k(bufs, (32,))
    assert out["C"].numpy().tobytes() == \
        (bufs["A"] + bufs["B"]).tobytes()
    assert k.last_winner in ("loop", "vector")
    assert len(table) == 1 and k.cache.stats.tune_decisions == 1
    winner = k.last_winner
    k(bufs, (32,))
    assert k.last_winner == winner
    assert k.cache.stats.tune_decisions == 1
    key = TuningTable.make_key(ir_hash(vecadd(TKB)), (8,), (32,), [])
    assert TuningTable(path).get(key) == winner
    # the reference computes the same key for the same kernel
    assert key == jcore.TuningTable.make_key(
        jcore.ir_hash(vecadd(JKB)), (8,), (32,), [])


def test_autotuner_new_shape_triggers_new_decision(tmp_path):
    table = TuningTable(str(tmp_path / "t.json"))
    k = _kernel(table)
    k(_bufs(32), (32,))
    k(_bufs(64), (64,))
    assert len(table) == 2


def test_autotuner_pin_bypasses_measurement(tmp_path):
    table = TuningTable(str(tmp_path / "t.json"))
    table.pin("vecadd", "loop")
    k = _kernel(table)
    bufs = _bufs()
    out = k(bufs, (32,))
    assert k.last_winner == "loop" and len(table) == 0
    assert out["C"].numpy().tobytes() == (bufs["A"] + bufs["B"]).tobytes()


def test_compile_kernel_target_auto_end_to_end(default_table):
    k = _compile_kernel(bld(vecadd, TKB), (8,), target="auto",
                        cache=CompilationCache())
    assert isinstance(k, AutotunedKernel)
    bufs = _bufs()
    out = k(bufs, (32,))
    assert out["C"].numpy().tobytes() == (bufs["A"] + bufs["B"]).tobytes()
    assert k.num_regions >= 1 and len(default_table) == 1
    assert k.context_stats == k.kernel_for(k.last_winner).context_stats


def test_cuda_candidate_is_left_out_on_the_cpu():
    """The default candidates name ``cuda``; on a CPU launch it is not
    timed and not recorded as a failure."""
    table = TuningTable()
    k = _kernel(table, candidates=autotune.DEFAULT_CANDIDATES)
    assert autotune.DEFAULT_CANDIDATES == ("loop", "vector", "cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        k(_bufs(), (32,))
    (ent,) = table._winners.values()
    assert set(ent["timings_us"]) == {"loop", "vector"}
    assert "failed" not in ent
    assert all(t > 0 for t in ent["timings_us"].values())


def test_pallas_pin_and_winner_are_tuned_again():
    """A pin or a recorded winner naming the reference's ``pallas``
    target (or ``cuda`` on a CPU launch) is ignored and the shape is
    tuned again; the recorded winner is replaced."""
    table = TuningTable()
    table.pin("vecadd", "pallas")
    k = _kernel(table)
    bufs = _bufs()
    out = k(bufs, (32,))
    assert k.last_winner in ("loop", "vector") and len(table) == 1
    assert out["C"].numpy().tobytes() == (bufs["A"] + bufs["B"]).tobytes()
    key = next(iter(table._winners))
    for stale in ("pallas", "cuda"):
        table.record(key, stale, {stale: 1.0})
        k2 = _kernel(table)
        k2(bufs, (32,))
        assert table.get(key) in ("loop", "vector")
        assert k2.cache.stats.tune_decisions == 1
    assert k2.num_regions >= 1       # introspection ignores the pin too


def test_failing_candidate_warns_and_is_recorded():
    def flaky(build, lsz, target, **kw):
        if target == "loop":
            raise RuntimeError("loop target broke")
        return _compile_kernel(build, lsz, target=target, **kw)
    table = TuningTable()
    k = AutotunedKernel(vecadd(TKB), bld(vecadd, TKB), (8,), {},
                        ("loop", "vector"), table, CompilationCache(), flaky)
    with pytest.warns(RuntimeWarning, match="candidate 'loop' failed"):
        k(_bufs(), (32,))
    (ent,) = table._winners.values()
    assert ent["target"] == "vector" and "loop target broke" in \
        ent["failed"]["loop"]
    k = AutotunedKernel(vecadd(TKB), bld(vecadd, TKB), (8,), {}, ("loop",),
                        TuningTable(), CompilationCache(), flaky)
    with pytest.warns(RuntimeWarning), pytest.raises(BuildError):
        k(_bufs(), (32,))


def test_cuda_candidate_failure_on_a_cuda_device_raises():
    """The card's own kernel failing to build is an error, never a quiet
    win of a plain candidate, and nothing is recorded.  (The device is
    only named: the failure comes before any launch, so this runs here.)"""
    def broken(build, lsz, target, **kw):
        raise BuildError("nvcc refused the kernel", build_log="")
    table = TuningTable()
    k = AutotunedKernel(vecadd(TKB), bld(vecadd, TKB), (8,), {},
                        ("loop", "cuda"), table, CompilationCache(), broken)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(BuildError, match="nvcc refused"):
            k._tune("key", torch.device("cuda"), None, (32,), None, None)
    assert len(table) == 0


@pytest.mark.parametrize("target,device,timed", [
    ("loop", "cpu", True), ("vector", "cpu", True), ("cuda", "cpu", False),
    ("loop", "cuda", False), ("vector", "cuda", True), ("cuda", "cuda", True),
    ("pallas", "cpu", False)])
def test_candidates_timed_on_each_device(target, device, timed):
    """On the CPU the tuner times loop and vector; on a CUDA device vector
    and cuda (loop steps the work-items from the host there)."""
    assert autotune._timed_on(target, torch.device(device)) is timed


def test_tuning_window_excludes_the_buffer_copies(monkeypatch):
    """Each candidate runs on copies made before its timed window: a copy
    that takes 50 ms leaves every recorded time well under 50 ms."""
    def slow_copy(v, device=None):
        time.sleep(0.05)
        return real(v, device)
    real = autotune.to_device
    monkeypatch.setattr(autotune, "to_device", slow_copy)
    table = TuningTable()
    k = _kernel(table)
    t0 = time.perf_counter()
    k(_bufs(), (32,))
    assert time.perf_counter() - t0 > 2 * 4 * 3 * 0.05   # copies happened
    (ent,) = table._winners.values()
    assert max(ent["timings_us"].values()) < 40_000, ent


# ---------------------------------------------------------------------------
# the tuning table: the reference's format and keys
# ---------------------------------------------------------------------------

def test_reference_table_file_loads_in_the_port(tmp_path):
    path = str(tmp_path / "shared.json")
    jt = jcore.TuningTable(path)
    h = jcore.ir_hash(vecadd(JKB))
    wkey = jcore.TuningTable.make_key(h, (8,), (32,), [], device="dev-a")
    pkey = jcore.TuningTable.make_key(h, (8,), (64,), [])
    ckey = jcore.TuningTable.make_coexec_key(h, ["vector", "basic"])
    skey = jcore.TuningTable.make_sweep_key("gemm", "vector", "m=8", "d")
    jt.record(wkey, "vector", {"vector": 1.0, "loop": 9.0})
    jt.record(pkey, "pallas", {"pallas": 0.5})
    jt.record_coexec(ckey, {"vector": 3.0, "basic": 1.0})
    jt.record_sweep(skey, {"ts": 8}, {"ts=8": 2.0, "ts=4": 3.0})
    jt.pin("other", "loop")

    t = TuningTable(path)
    assert ir_hash(vecadd(TKB)) == h
    assert TuningTable.make_key(h, (8,), (32,), [], device="dev-a") == wkey
    assert t.get(wkey) == "vector" and t.get(pkey) == "pallas"
    assert t.get_coexec(ckey) == jt.get_coexec(ckey)
    assert t.get_sweep(skey) == jt.get_sweep(skey)
    assert t.pinned("other") == "loop" and len(t) == len(jt) == 2
    # the port uses the recorded vector winner as is, and tunes the
    # pallas shape again
    k = _kernel(t, device_key="dev-a")
    k(_bufs(32), (32,))
    assert k.last_winner == "vector" and k.cache.stats.tune_decisions == 0
    k2 = _kernel(t)
    k2(_bufs(64), (64,))
    assert t.get(pkey) in ("loop", "vector")
    assert k2.cache.stats.tune_decisions == 1
    # and the reference reads the port's rewrite back
    assert jcore.TuningTable(path).get(pkey) == t.get(pkey)


def test_tuning_keys_are_per_device():
    key_a = TuningTable.make_key("iriri", (8,), (32,), [], device="dev-a")
    key_b = TuningTable.make_key("iriri", (8,), (32,), [], device="dev-b")
    bare = TuningTable.make_key("iriri", (8,), (32,), [])
    assert len({key_a, key_b, bare}) == 3
    t = TuningTable()
    t.record(key_a, "vector", {"vector": 1.0})
    t.record(key_b, "loop", {"loop": 1.0})
    assert t.get(key_a) == "vector" and t.get(key_b) == "loop"


def test_corrupt_table_file_loads_empty(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text("{not json")
    assert len(TuningTable(str(path))) == 0


# ---------------------------------------------------------------------------
# the auto device (reference tests/test_events.py, test_host_api.py)
# ---------------------------------------------------------------------------

def test_autotuned_device_key_flows_from_runtime(default_table):
    dev = Platform(torch_device="cpu").get_devices("auto")[0]
    with pytest.deprecated_call():
        k = dev.build_kernel(bld(vecadd, TKB), (8,))
    assert k.device_key == dev.info.name
    k(_bufs(), (32,))
    key = TuningTable.make_key(k._ir, (8,), (32,), sorted(k.options.items()),
                               device=dev.info.name)
    assert len(default_table) == 1 and default_table.get(key) is not None


def test_autotuned_device_through_program(default_table):
    ctx = Context(platform=Platform(torch_device="cpu"))
    auto_dev = next(d for d in ctx.devices if d.info.driver == "auto")
    k = ctx.create_program(bld(scale, TKB)).create_kernel()
    host = np.arange(32, dtype=np.float32)
    k.set_args(x=host, s=2.5)
    out = ctx.launch(k, (32,), (8,), device=auto_dev)
    assert out["x"].numpy().tobytes() == (host * np.float32(2.5)).tobytes()
    binary = k.bind(auto_dev, (8,))
    assert isinstance(binary, AutotunedKernel)
    assert binary.last_winner in ("loop", "vector")


def test_auto_queue_launch_applies_once_in_place(default_table):
    """``x[g] = x[g] * s`` on a queue of the auto device: the first
    launch tunes on clones and runs the winner once in place; the second
    launches the recorded winner.  Bitwise x * s, then x * s * s — the
    reference's two launches."""
    n = 64
    host = np.arange(n, dtype=np.float32) - 7.5
    ctx = Context(platform=Platform(torch_device="cpu"))
    dev = ctx.platform.get_devices("auto")[0]
    k = ctx.create_program(bld(scale, TKB)).create_kernel()
    buf = ctx.create_buffer(n, device=dev)
    k.set_args(x=buf, s=-3.0)
    q = ctx.create_queue(dev)
    q.enqueue_write_buffer(buf, host)
    outs = []
    for _ in range(2):
        q.enqueue_nd_range(k, (n,), (8,))
        out = np.zeros(n, np.float32)
        q.enqueue_read_buffer(buf, out)
        q.finish()
        outs.append(out)
    assert dev.cache_stats()["tune_decisions"] == 1
    jctx = jrt.Context(platform=jrt.Platform())
    jk = jctx.create_program(bld(scale, JKB)).create_kernel()
    want = host
    for got in outs:
        jk.set_args(x=want, s=-3.0)
        want = np.asarray(jctx.launch(jk, (n,), (8,))["x"])
        assert got.tobytes() != host.tobytes()
    assert outs[0].tobytes() == (host * np.float32(-3.0)).tobytes()
    assert outs[1].tobytes() == want.tobytes()


def test_concurrent_autotuned_enqueues_tune_once(default_table, monkeypatch):
    monkeypatch.delenv("REPRO_KERNEL_CACHE_DIR", raising=False)
    dev = Platform(torch_device="cpu").get_devices("auto")[0]
    q = CommandQueue(dev, out_of_order=True, workers=4)
    bufs = [create_buffer(dev, 8, "float32") for _ in range(6)]
    for b_ in bufs:
        q.enqueue_write_buffer(b_, np.zeros(8, np.float32))
    bar = q.enqueue_barrier()

    def build():
        b = TKB("inc")
        x = b.arg_buffer("x", "float32")
        gid = b.global_id(0)
        x[gid] = x[gid] + 1.0
        return b.finish()

    with pytest.deprecated_call():
        evs = [q.enqueue_kernel(build, (8,), (8,), {"x": b_},
                                wait_for=[bar]) for b_ in bufs]
    outs = [np.zeros(8, np.float32) for _ in bufs]
    for b_, o, e in zip(bufs, outs, evs):
        q.enqueue_read_buffer(b_, o, wait_for=[e])
    q.finish()
    assert all(o.tobytes() == np.ones(8, np.float32).tobytes() for o in outs)
    st = dev.cache_stats()
    assert st["tune_decisions"] == 1
    assert st["compiles"] <= 2         # loop and vector, shared by all


@pytest.mark.parametrize("name", sorted(SUITE))
def test_auto_device_suite_bitwise(name, default_table):
    """Every suite kernel at its ci shape through the auto device: equal
    to the vector target and to the reference's vector launch."""
    sk, jsk = SUITE[name], J_SUITE[name]
    shape = sk.shapes["ci"]
    params = next(iter(sk.space(shape)))
    inputs = sk.make_inputs(shape, params)
    gsz, lsz = sk.launch_dims(shape, params)
    ctx = Context(platform=Platform(torch_device="cpu"))
    auto = ctx.platform.get_devices("auto")[0]
    vec = ctx.platform.get_devices("vector")[0]
    k = ctx.create_program(sk.build(shape, params)).create_kernel()
    k.set_args(**inputs)
    got = ctx.launch(k, gsz, lsz, device=auto)
    again = ctx.launch(k, gsz, lsz, device=auto)
    ref = ctx.launch(k, gsz, lsz, device=vec)
    jctx = jrt.Context(platform=jrt.Platform())
    jk = jctx.create_program(jsk.build(shape, params)).create_kernel()
    jk.set_args(**jsk.make_inputs(shape, params))
    jout = jctx.launch(jk, gsz, lsz)
    for o in sk.outputs:
        g = got[o].numpy().tobytes()
        assert g == again[o].numpy().tobytes() == ref[o].numpy().tobytes()
        assert g == np.asarray(jout[o]).tobytes(), (name, o)
    assert auto.cache_stats()["tune_decisions"] == 1


def test_auto_devices_co_execute(default_table):
    """Two auto devices in one executor: each chunk is a group_range
    launch of the winner (tuned on the chunk's clones); the merge equals
    the reference's single launch."""
    n = 256
    ctx = Context(platform=Platform(torch_device="cpu"))
    k = ctx.create_program(bld(scale, TKB)).create_kernel()
    x = np.linspace(-4, 4, n, dtype=np.float32)
    k.set_args(x=x, s=0.5)
    co = ctx.create_co_executor(ctx.platform.co_devices(2, driver="auto"))
    merged = co.launch(k, (n,), (64,), mode="steal")
    co.finish()
    jctx = jrt.Context(platform=jrt.Platform())
    jk = jctx.create_program(bld(scale, JKB)).create_kernel()
    jk.set_args(x=x, s=0.5)
    want = np.asarray(jctx.launch(jk, (n,), (64,))["x"])
    assert merged["x"].numpy().tobytes() == want.tobytes()


def test_single_flight_tuning_under_threads():
    """Eight threads launch one new shape at once: one decision."""
    table = TuningTable()
    k = _kernel(table)
    outs, errs = [], []

    def go():
        try:
            outs.append(k(_bufs(), (32,))["C"].numpy().tobytes())
        except Exception as e:  # pragma: no cover - reported below
            errs.append(e)
    threads = [threading.Thread(target=go) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs and len(set(outs)) == 1
    assert len(table) == 1 and k.cache.stats.tune_decisions == 1


def test_launch_ndrange_tunes_on_clones():
    """The in-place path: candidates never touch the launch's tensors;
    the winner runs on them once."""
    table = TuningTable()
    k = _kernel(table, build=bld(scale, TKB))
    x = torch.arange(16, dtype=torch.float32)
    k.launch_ndrange({"x": x}, (16,), {"s": 3.0})
    assert torch.equal(x, torch.arange(16, dtype=torch.float32) * 3)
    k.launch_ndrange({"x": x}, (16,), {"s": 3.0}, group_range=(0, 1))
    want = torch.arange(16, dtype=torch.float32) * 3
    want[:8] *= 3
    assert torch.equal(x, want) and len(table) == 1
