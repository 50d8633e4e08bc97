"""The port's host runtime (``repro_torch.runtime``: buffers, sub-buffers,
maps, buffer and kernel enqueues, events, the context, the trace) held
against the reference's (``repro.runtime``) on the same numpy inputs.

The port runs on ``Platform(torch_device="cpu")``, the reference on its
``Platform()`` (JAX on the CPU).  Tolerance: bitwise throughout — the
kernels here compute integer-valued or dyadic data, and the walk-through
of ``examples/opencl_runtime.py`` gives the reference's result bytes.

Where the port differs by design, the test pins the difference and
ROADMAP §C names it: a map is a host bounce, so host writes reach the
buffer at unmap (C.8); kernel arguments are the buffers' own tensors,
updated in place, so arguments that alias one allocation see each
other's writes in the order the target runs its work-items (C.9).
"""

import json
import random
import threading
import time
import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.runtime as jrt  # noqa: E402
from repro.core import KernelBuilder as JKB  # noqa: E402
from repro.core import run_ndrange as j_run_ndrange  # noqa: E402

import repro_torch.runtime as trt  # noqa: E402
from repro_torch.core import KernelBuilder as TKB  # noqa: E402
from repro_torch.core import errors as terrors  # noqa: E402
from repro_torch.runtime import (CommandError, Context,  # noqa: E402
                                 DependencyError, EventStatus, MapError,
                                 Platform, ResidencyTracker, UserEvent,
                                 create_buffer, create_sub_buffer)

N, LSZ = 64, 8

try:
    from hypothesis import settings, strategies as st
    from hypothesis.stateful import (Bundle, RuleBasedStateMachine,
                                     consumes, initialize, invariant,
                                     multiple, rule)
    HAVE_HYPOTHESIS = True
except ImportError:               # the seeded walks below still run
    HAVE_HYPOTHESIS = False


@pytest.fixture(scope="module")
def plat():
    return Platform(torch_device="cpu")


@pytest.fixture(scope="module")
def jplat():
    return jrt.Platform()


def _ctx():
    return Context(platform=Platform(torch_device="cpu"))


def _jctx():
    """The reference's context on a platform of its own, as the port's
    is: the process-default platform's arena holds whatever earlier tests
    in the process allocated, which moves a new buffer's chunk offset."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return jrt.Context(platform=jrt.Platform())


def host(buf) -> np.ndarray:
    """A buffer's contents on the host, whichever package made it."""
    d = buf.data
    return d.cpu().numpy() if isinstance(d, torch.Tensor) else np.asarray(d)


# -- kernels, built by either package's KernelBuilder -------------------------

def k_scale(KB):
    b = KB("scale")
    x = b.arg_buffer("x", "float32")
    s = b.arg_scalar("s", "float32")
    g = b.global_id(0)
    x[g] = x[g] * s
    return b.finish()


def k_offset(KB):
    b = KB("offset")
    x = b.arg_buffer("x", "float32")
    o = b.arg_scalar("o", "float32")
    g = b.global_id(0)
    x[g] = x[g] + o
    return b.finish()


def k_axpy(KB):
    """x = x * 2 + 1: exact in f32 for small-integer inputs."""
    b = KB("axpy")
    x = b.arg_buffer("x", "float32")
    g = b.global_id(0)
    x[g] = x[g] * 2.0 + 1.0
    return b.finish()


def k_scale2(KB):
    """y = x * 2 + g (two buffers)."""
    b = KB("scale2")
    x = b.arg_buffer("x", "float32")
    y = b.arg_buffer("y", "float32")
    g = b.global_id(0)
    y[g] = x[g] * 2.0 + g
    return b.finish()


def bld(fn, KB):
    return lambda: fn(KB)


# ---------------------------------------------------------------------------
# the walk-through of examples/opencl_runtime.py up to its co-executor
# ---------------------------------------------------------------------------

def walkthrough(ctx, KB):
    """examples/opencl_runtime.py's steps up to ``:86``; returns the
    result, the buffer's chunk offset, the four events and the queue."""
    prog = ctx.create_program(bld(k_scale, KB), bld(k_offset, KB)).build()
    scale = prog.create_kernel("scale")
    offset = prog.create_kernel("offset")
    n = 256
    host_in = np.arange(n, dtype=np.float32)
    out = np.zeros(n, np.float32)
    buf = ctx.create_buffer(n, "float32")
    scale.set_args(x=buf, s=2.0)
    offset.set_args(x=buf, o=1.0)
    q = ctx.create_queue(out_of_order=True)
    e_w = q.enqueue_write_buffer(buf, host_in)
    e_s = q.enqueue_nd_range(scale, (n,), (64,), wait_for=[e_w])
    e_o = q.enqueue_nd_range(offset, (n,), (64,), wait_for=[e_s])
    e_r = q.enqueue_read_buffer(buf, out, wait_for=[e_o])
    q.finish()
    return out, buf.chunk.start, (e_w, e_s, e_o, e_r), q


def test_opencl_runtime_walkthrough_gives_the_reference_bytes():
    out, start, evs, q = walkthrough(_ctx(), TKB)
    jout, jstart, jevs, jq = walkthrough(_jctx(), JKB)
    assert out.tobytes() == jout.tobytes()
    assert out.tobytes() == (np.arange(256, dtype=np.float32) * 2
                             + 1).tobytes()
    assert start == jstart
    assert [e.name for e in evs] == [e.name for e in jevs]
    assert [e.kind for e in evs] == [e.kind for e in jevs]
    assert q.stats["launches"] == jq.stats["launches"] == 2
    for ev in evs:
        p = ev.profile
        assert p["queued_ns"] <= p["submit_ns"] <= p["start_ns"] \
            <= p["end_ns"]
    for a, b in zip(evs, evs[1:]):
        assert a.end_ns <= b.start_ns


# ---------------------------------------------------------------------------
# buffers: creation, validation, laziness, pools, release
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [0, -3, 2.5, "8", None, True])
def test_create_buffer_validation_matches_reference(plat, jplat, bad):
    for mod, dev, ctx in ((trt, plat.get_devices()[0], _ctx()),
                          (jrt, jplat.get_devices()[0], _jctx())):
        with pytest.raises(mod.InvalidBufferError) as ei:
            ctx.create_buffer(bad)
        assert ei.value.code == -61 and isinstance(ei.value, ValueError)
        with pytest.raises(mod.InvalidBufferError):
            mod.create_buffer(dev, bad)


@pytest.mark.parametrize("dtype", ["floatXX", "not-a-dtype"])
def test_bad_buffer_dtype_is_refused(dtype):
    with pytest.raises(trt.InvalidBufferError):
        _ctx().create_buffer(8, dtype)
    with pytest.raises(jrt.InvalidBufferError):
        _jctx().create_buffer(8, dtype)


def test_buffer_lives_on_its_device_as_a_flat_tensor(plat):
    dev = plat.get_devices("basic")[0]
    buf = create_buffer(dev, 16, "f4")
    assert isinstance(buf.data, torch.Tensor)
    assert buf.data.shape == (16,) and buf.data.dtype == torch.float32
    assert buf.data.device == dev.torch_device
    assert buf.dtype == "float32" and buf.nbytes == 64
    assert create_buffer(dev, np.int64(4), "int32").data.dtype == torch.int32
    with pytest.raises(trt.InvalidBufferError, match="elements"):
        buf.data = np.zeros(15, np.float32)
    buf.release()
    assert buf.chunk is None and not buf.materialized


def test_pooled_buffers_are_lazy_and_reuse_the_pool():
    ctx = _ctx()
    b1 = ctx.create_buffer(1024, "float32")
    assert not b1.materialized and b1.chunk is None
    repr(b1)                                  # a repr must not materialize
    assert not b1.materialized
    b1.data[0] = 1.0                          # first real use
    assert b1.materialized and b1.chunk is not None
    b1.release()
    b2 = ctx.create_buffer(1024, "float32")
    _ = b2.data
    assert ctx.pool_stats()[ctx.devices[0].info.name]["hits"] >= 1
    b2.release()
    with pytest.raises(trt.InvalidArgError, match="not part of this context"):
        Context(devices=ctx.devices[:1], platform=ctx.platform
                ).create_buffer(8, device=ctx.devices[1])
    with pytest.raises(trt.InvalidArgError, match="at least one device"):
        Context(devices=[], platform=ctx.platform)


def test_buffer_dtype_aliases_accepted():
    ctx = _ctx()
    k = ctx.create_program(bld(k_scale, TKB)).create_kernel()
    k.set_arg("x", ctx.create_buffer(8, np.float32))
    k.set_arg("x", ctx.create_buffer(8, "f4"))
    with pytest.raises(trt.InvalidArgError, match="dtype"):
        k.set_arg("x", ctx.create_buffer(8, "f8"))


def test_setting_a_buffer_argument_does_not_materialize_it():
    ctx = _ctx()
    buf = ctx.create_buffer(N)
    k = ctx.create_program(bld(k_scale, TKB)).create_kernel()
    k.set_args(x=buf, s=2.0)
    assert k.launch_args(accept=("device",))[0]["x"] is buf
    assert not buf.materialized


# ---------------------------------------------------------------------------
# sub-buffers
# ---------------------------------------------------------------------------

def test_view_aliases_parent(plat):
    dev = plat.get_devices("basic")[0]
    buf = create_buffer(dev, 16, "float32")
    buf.data = np.arange(16, dtype=np.float32)
    sub = create_sub_buffer(buf, 4 * 4, 8 * 4)     # elements [4, 12)
    assert sub.data.numpy().tolist() == list(range(4, 12))
    assert sub.data.data_ptr() == buf.data.data_ptr() + 16   # a view
    sub.data = np.full(8, 9.0, np.float32)
    d = host(buf)
    assert d[3] == 3.0 and d[4] == 9.0 and d[11] == 9.0 and d[12] == 12.0
    buf.data = np.zeros(16, np.float32)            # in place: view follows
    assert sub.data[0] == 0.0
    buf.release()


def test_alignment_and_bounds_rules_match_reference(plat, jplat):
    for mod, dev in ((trt, plat.get_devices("basic")[0]),
                     (jrt, jplat.get_devices("basic")[0])):
        buf = mod.create_buffer(dev, 16, "float32")
        old = dev.info.mem_base_addr_align
        try:
            dev.info.mem_base_addr_align = 32
            with pytest.raises(mod.MapError, match="mem_base_addr_align"):
                mod.create_sub_buffer(buf, 4, 32)
            mod.create_sub_buffer(buf, 32, 32)
        finally:
            dev.info.mem_base_addr_align = old
        for origin, nbytes, msg in ((0, 65, "outside parent"),
                                    (64, 4, "outside parent"),
                                    (4, 6, "elements")):
            with pytest.raises(mod.MapError, match=msg):
                mod.create_sub_buffer(buf, origin, nbytes)
        sub = mod.create_sub_buffer(buf, 0, 32)
        with pytest.raises(mod.MapError, match="sub-buffer from a sub"):
            mod.create_sub_buffer(sub, 0, 16)
        buf.release()


def test_write_through_view_invalidates_span_only(plat):
    dev = plat.get_devices("basic")[0]
    buf = create_buffer(dev, 16, "float32")
    tr = ResidencyTracker()
    buf.bind_residency(tr, "P", "this-dev")
    tr.acquire_spans("P", "other-dev", buf.nbytes)
    sub = create_sub_buffer(buf, 4 * 4, 8 * 4)
    sub.mark_written()
    assert tr.stale_spans("P", "other-dev") == [(16, 48)]
    assert tr.stale_spans("P", "this-dev", buf.nbytes) == [(0, 16), (48, 64)]
    buf.mark_written()
    assert tr.stale_spans("P", "other-dev") == [(0, 64)]
    buf.release()


# ---------------------------------------------------------------------------
# maps through the host bounce
# ---------------------------------------------------------------------------

def test_map_is_a_bounce_and_writes_land_at_unmap(plat):
    """C.8: the mapped array is a host copy (the reference's is a view of
    the payload); a host write reaches the buffer when the unmap runs."""
    dev = plat.get_devices("basic")[0]
    q = trt.CommandQueue(dev)
    buf = create_buffer(dev, N, "float32")
    q.enqueue_write_buffer(buf, np.arange(N, dtype=np.float32))
    region = q.enqueue_map_buffer(buf, "rw")
    arr = region.get()
    assert region.event.kind == "map" and region.active
    assert arr.tolist() == list(range(N))
    assert not np.shares_memory(arr, buf.data.numpy())
    arr[0] = 123.0
    assert host(buf)[0] == 0.0, "a mapped write lands at unmap"
    q.enqueue_unmap_buffer(region)
    q.finish()
    assert host(buf)[0] == 123.0 and region.array is None
    assert not region.active
    buf.release()


def test_read_map_copies_nothing_back(plat):
    dev = plat.get_devices("basic")[0]
    q = trt.CommandQueue(dev)
    buf = create_buffer(dev, N, "float32")
    region = q.enqueue_map_buffer(buf, "r")
    region.get()[:] = 5.0
    q.enqueue_unmap_buffer(region)
    q.finish()
    assert not host(buf).any()
    buf.release()


def test_map_sub_range_of_a_sub_buffer(plat):
    dev = plat.get_devices("basic")[0]
    q = trt.CommandQueue(dev)
    buf = create_buffer(dev, 16, "float32")
    sub = create_sub_buffer(buf, 4 * 4, 8 * 4)
    region = q.enqueue_map_buffer(sub, "w", offset=4, nbytes=8)
    arr = region.get()
    assert region.abs_span == (20, 28)
    arr[:] = [7.0, 8.0]
    q.enqueue_unmap_buffer(region)
    q.finish()
    d = host(buf)
    assert d[5] == 7.0 and d[6] == 8.0 and d[4] == 0.0 and d[7] == 0.0
    buf.release()


def test_overlapping_write_maps_rejected_read_maps_ok(plat):
    dev = plat.get_devices("basic")[0]
    q = trt.CommandQueue(dev, out_of_order=True)
    buf = create_buffer(dev, N, "float32")
    r1 = q.enqueue_map_buffer(buf, "r", offset=0, nbytes=32)
    r2 = q.enqueue_map_buffer(buf, "r", offset=16, nbytes=32)
    assert r1.get() is not None and r2.get() is not None
    qbad = trt.CommandQueue(dev, out_of_order=True)
    bad = qbad.enqueue_map_buffer(buf, "w", offset=24, nbytes=8)
    qbad.flush()
    with pytest.raises(CommandError):
        bad.event.wait()
    assert isinstance(bad.event.error, MapError)
    ok = q.enqueue_map_buffer(buf, "w", offset=128, nbytes=8)
    assert ok.get() is not None
    for r in (r1, r2, ok):
        q.enqueue_unmap_buffer(r)
    q.finish()
    buf.release()


@pytest.mark.parametrize("flags", ["r", "w"])
def test_launch_over_mapped_buffer_fails(plat, flags):
    dev = plat.get_devices("basic")[0]
    q = trt.CommandQueue(dev, out_of_order=True)
    buf = create_buffer(dev, N, "float32")
    with pytest.deprecated_call():
        k = dev.build_kernel(bld(k_axpy, TKB), (LSZ,))
    region = q.enqueue_map_buffer(buf, flags)
    region.get()
    qbad = trt.CommandQueue(dev, out_of_order=True)
    ev = qbad.enqueue_ndrange_kernel(k, (N,), {"x": buf})
    wr = qbad.enqueue_write_buffer(buf, np.ones(N, np.float32))
    qbad.flush()
    with pytest.raises(CommandError, match="active map"):
        ev.wait()
    with pytest.raises(CommandError, match="active map"):
        wr.wait()
    assert isinstance(ev.error, MapError)
    assert isinstance(wr.error, MapError)
    assert qbad.stats["launches"] == 0
    q.enqueue_unmap_buffer(region)
    q.finish()
    ev2 = q.enqueue_ndrange_kernel(k, (N,), {"x": buf})
    q.flush()
    ev2.wait()
    assert host(buf).tolist() == [1.0] * N
    buf.release()


def test_double_unmap_fails(plat):
    dev = plat.get_devices("basic")[0]
    q = trt.CommandQueue(dev, out_of_order=True)
    buf = create_buffer(dev, N, "float32")
    region = q.enqueue_map_buffer(buf, "r")
    region.get()
    first = q.enqueue_unmap_buffer(region)
    q.flush()
    first.wait()
    bad = q.enqueue_unmap_buffer(region)
    q.flush()
    with pytest.raises(CommandError, match="inactive"):
        bad.wait()
    buf.release()


def test_write_invalidate_skips_read_back(plat):
    dev = plat.get_devices("basic")[0]
    q = trt.CommandQueue(dev)
    buf = create_buffer(dev, N, "float32")
    synced = []
    buf.on_map_sync = lambda lo, hi: synced.append((lo, hi))
    r = q.enqueue_map_buffer(buf, "r", offset=0, nbytes=32)
    r.get()
    q.enqueue_unmap_buffer(r)
    q.finish()
    assert synced == [(0, 32)]
    wi = q.enqueue_map_buffer(buf, "wi")
    wi.get()[...] = 3.0
    q.enqueue_unmap_buffer(wi)
    q.finish()
    assert synced == [(0, 32)], "write-invalidate must skip read-back"
    assert host(buf).tolist() == [3.0] * N
    buf.release()


def test_failed_map_rolls_back_registration(plat):
    dev = plat.get_devices("basic")[0]
    q = trt.CommandQueue(dev, out_of_order=True)
    buf = create_buffer(dev, N, "float32")

    def boom(lo, hi):
        raise RuntimeError("sync failed")
    buf.on_map_sync = boom
    qbad = trt.CommandQueue(dev, out_of_order=True)
    bad = qbad.enqueue_map_buffer(buf, "r")
    qbad.flush()
    with pytest.raises(CommandError, match="sync failed"):
        bad.event.wait()
    assert not bad.active and buf.map_count == 0
    buf.on_map_sync = None
    ok = q.enqueue_map_buffer(buf, "rw")
    assert ok.get() is not None
    q.enqueue_unmap_buffer(ok)
    q.finish()
    buf.release()


def test_unmap_publishes_residency_invalidation(plat):
    dev = plat.get_devices("basic")[0]
    q = trt.CommandQueue(dev)
    buf = create_buffer(dev, 16, "float32")
    tr = ResidencyTracker()
    buf.bind_residency(tr, "M", "this-dev")
    tr.acquire_spans("M", "other-dev", buf.nbytes)
    region = q.enqueue_map_buffer(buf, "w", offset=8, nbytes=16)
    region.get()[:] = 5.0
    assert tr.stale_spans("M", "other-dev") == []
    q.enqueue_unmap_buffer(region)
    q.finish()
    assert tr.stale_spans("M", "other-dev") == [(8, 24)]
    buf.release()


# ---------------------------------------------------------------------------
# kernels through views and maps: the port, the reference and the oracle
# ---------------------------------------------------------------------------

def _oracle_halves():
    parent = np.arange(2 * N, dtype=np.float32)
    return np.concatenate([
        j_run_ndrange(k_axpy(JKB), (N,), (LSZ,),
                      {"x": parent[:N].copy()})["x"],
        j_run_ndrange(k_axpy(JKB), (N,), (LSZ,),
                      {"x": parent[N:].copy()})["x"]])


def _halves(mod, KB, dev):
    q = mod.CommandQueue(dev)
    buf = mod.create_buffer(dev, 2 * N, "float32")
    q.enqueue_write_buffer(buf, np.arange(2 * N, dtype=np.float32))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        k = dev.build_kernel(bld(k_axpy, KB), (LSZ,))
    lo = mod.create_sub_buffer(buf, 0, N * 4)
    hi = mod.create_sub_buffer(buf, N * 4, N * 4)
    q.enqueue_ndrange_kernel(k, (N,), {"x": lo})
    q.enqueue_ndrange_kernel(k, (N,), {"x": hi})
    q.finish()
    return host(buf)


@pytest.mark.parametrize("kind", ["basic", "vector"])
def test_subbuffer_kernels_bitwise_with_reference(plat, jplat, kind):
    got = _halves(trt, TKB, plat.get_devices(kind)[0])
    ref = _halves(jrt, JKB, jplat.get_devices(kind)[0])
    assert got.tobytes() == ref.tobytes() == _oracle_halves().tobytes()


def _mapped(mod, KB, dev, init):
    q = mod.CommandQueue(dev)
    buf = mod.create_buffer(dev, N, "float32")
    w = q.enqueue_map_buffer(buf, "wi")
    w.get()[...] = init
    q.enqueue_unmap_buffer(w)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        k = dev.build_kernel(bld(k_axpy, KB), (LSZ,))
    q.enqueue_ndrange_kernel(k, (N,), {"x": buf})
    r = q.enqueue_map_buffer(buf, "r")
    out = r.get().copy()
    q.enqueue_unmap_buffer(r)
    q.finish()
    return out


@pytest.mark.parametrize("kind", ["basic", "vector"])
def test_mapped_region_kernels_bitwise_with_reference(plat, jplat, kind):
    init = np.arange(N, dtype=np.float32) - N // 2
    expect = j_run_ndrange(k_axpy(JKB), (N,), (LSZ,),
                           {"x": init.copy()})["x"]
    got = _mapped(trt, TKB, plat.get_devices(kind)[0], init)
    ref = _mapped(jrt, JKB, jplat.get_devices(kind)[0], init)
    assert got.tobytes() == ref.tobytes() == expect.tobytes()


def _aliased(mod, KB, dev, x_origin, y_origin, n_root):
    """scale2 with x and y as two views of one root allocation."""
    q = mod.CommandQueue(dev)
    buf = mod.create_buffer(dev, n_root, "float32")
    q.enqueue_write_buffer(buf, np.arange(n_root, dtype=np.float32) % 7)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        k = dev.build_kernel(bld(k_scale2, KB), (LSZ,))
    x = mod.create_sub_buffer(buf, x_origin * 4, N * 4)
    y = mod.create_sub_buffer(buf, y_origin * 4, N * 4)
    q.enqueue_ndrange_kernel(k, (N,), {"x": x, "y": y})
    q.finish()
    return host(buf)


@pytest.mark.parametrize("kind", ["basic", "vector"])
def test_disjoint_views_in_one_launch_match_reference(plat, jplat, kind):
    got = _aliased(trt, TKB, plat.get_devices(kind)[0], 0, N, 2 * N)
    ref = _aliased(jrt, JKB, jplat.get_devices(kind)[0], 0, N, 2 * N)
    assert got.tobytes() == ref.tobytes()


def test_overlapping_views_in_one_launch_are_in_place(plat, jplat):
    """C.9: y is x shifted by one element.  The reference gives every
    argument its own snapshot; the port launches on the views in place.
    The vector target loads a region's lanes before it stores them, so it
    gives the reference's bytes; the loop target runs the work-items in
    order, so work-item g reads what g - 1 just wrote."""
    ref = _aliased(jrt, JKB, jplat.get_devices("vector")[0], 0, 1, N + 1)
    vec = _aliased(trt, TKB, plat.get_devices("vector")[0], 0, 1, N + 1)
    loop = _aliased(trt, TKB, plat.get_devices("basic")[0], 0, 1, N + 1)
    assert vec.tobytes() == ref.tobytes()
    seq = np.arange(N + 1, dtype=np.float32) % 7
    for g in range(N):
        seq[g + 1] = seq[g] * np.float32(2) + np.float32(g)
    assert loop.tobytes() == seq.tobytes()
    assert loop.tobytes() != ref.tobytes()


def test_concurrent_first_uses_make_one_tensor():
    """Writes through 16 views of one still-lazy buffer on a 16-worker
    out-of-order queue, the interpreter switching threads often: every
    write lands, so the first uses materialized one tensor, not several."""
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(5):
            ctx = _ctx()
            buf = ctx.create_buffer(16 * N)
            q = ctx.create_queue(out_of_order=True, workers=16)
            for i in range(16):
                q.enqueue_write_buffer(
                    create_sub_buffer(buf, i * N * 4, N * 4),
                    np.full(N, i + 1, np.float32))
            q.finish(timeout=30.0)
            assert host(buf).tobytes() == np.repeat(
                np.arange(1, 17, dtype=np.float32), N).tobytes()
    finally:
        sys.setswitchinterval(old)


def test_launch_refuses_a_buffer_of_another_device(plat):
    other = Platform(torch_device="meta").get_devices()[0]
    dev = plat.get_devices("vector")[0]
    q = trt.CommandQueue(dev)
    with pytest.deprecated_call():
        k = dev.build_kernel(bld(k_axpy, TKB), (LSZ,))
    ev = q.enqueue_ndrange_kernel(k, (N,), {"x": create_buffer(other, N)})
    with pytest.raises(CommandError):
        q.finish()
    assert isinstance(ev.error, trt.InvalidArgError)
    assert "meta" in str(ev.error)


# ---------------------------------------------------------------------------
# events over buffer and kernel commands
# ---------------------------------------------------------------------------

def _pipeline(mod, KB, dev):
    n = 128
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        k = dev.build_kernel(bld(k_scale2, KB), (64,))
    q = mod.CommandQueue(dev, out_of_order=True, workers=4)
    xb = mod.create_buffer(dev, n, "float32")
    yb = mod.create_buffer(dev, n, "float32")
    out = np.zeros(n, np.float32)
    e_w = q.enqueue_write_buffer(xb, np.arange(n, dtype=np.float32))
    e_k = q.enqueue_ndrange_kernel(k, (n,), {"x": xb, "y": yb},
                                   wait_for=[e_w])
    e_r = q.enqueue_read_buffer(yb, out, wait_for=[e_k])
    q.finish()
    assert e_w.succeeded and e_k.succeeded and e_r.succeeded
    assert e_w.kind == "transfer" and e_k.kind == "kernel"
    assert e_w.end_ns <= e_k.start_ns and e_k.end_ns <= e_r.start_ns
    return out


def test_event_ordered_kernel_pipeline(plat, jplat):
    got = _pipeline(trt, TKB, plat.get_devices()[0])
    ref = _pipeline(jrt, JKB, jplat.get_devices()[0])
    n = np.arange(128, dtype=np.float32)
    assert got.tobytes() == ref.tobytes() == (n * 2 + n).tobytes()


def test_write_from_a_tensor(plat):
    dev = plat.get_devices()[0]
    q = trt.CommandQueue(dev)
    buf = create_buffer(dev, N)
    out = np.zeros(N, np.float32)
    q.enqueue_write_buffer(buf, torch.arange(N, dtype=torch.float64))
    q.enqueue_read_buffer(buf, out)
    q.finish()
    assert out.tolist() == list(range(N))


def test_failed_kernel_fails_its_dependents(plat):
    dev = plat.get_devices()[0]
    q = trt.CommandQueue(dev, out_of_order=True)
    buf = create_buffer(dev, N)
    with pytest.deprecated_call():
        k = dev.build_kernel(bld(k_axpy, TKB), (LSZ,))
    bad = q.enqueue_ndrange_kernel(k, (N + 1,), {"x": buf})  # not a multiple
    ran = []
    after = q.enqueue_native(lambda: ran.append(1), wait_for=[bad])
    out = np.zeros(N, np.float32)
    rd = q.enqueue_read_buffer(buf, out, wait_for=[bad])
    q.flush()
    with pytest.raises(CommandError):
        bad.wait()
    for ev in (after, rd):
        with pytest.raises(DependencyError):
            ev.wait()
    assert not ran and bad.status < 0
    assert isinstance(bad.error, terrors.InvalidArgError)


def test_status_ladder_and_profiling(plat):
    q = trt.CommandQueue(plat.get_devices()[0])
    seen = []
    ev = q._enqueue("probe", lambda: seen.append(ev.status), [])
    assert ev.status == EventStatus.QUEUED
    q.finish()
    assert seen == [EventStatus.RUNNING] and ev.succeeded
    p = ev.profile
    assert p["queued_ns"] <= p["submit_ns"] <= p["start_ns"] <= p["end_ns"]


def test_dag_ordering_and_diamond_out_of_order(plat):
    q = trt.CommandQueue(plat.get_devices()[0], out_of_order=True, workers=4)
    order, lock = [], threading.Lock()

    def mk(tag):
        def fn():
            time.sleep(0.002)
            with lock:
                order.append(tag)
        return fn
    a = q._enqueue("A", mk("A"), [])
    b = q._enqueue("B", mk("B"), [a])
    c = q._enqueue("C", mk("C"), [a])
    d = q._enqueue("D", mk("D"), [b, c])
    q.finish()
    assert order[0] == "A" and order[-1] == "D"
    assert set(order[1:3]) == {"B", "C"}
    assert d.submit_ns >= max(b.end_ns, c.end_ns)


def test_user_event_gates_a_kernel_and_finish_times_out(plat):
    dev = plat.get_devices()[0]
    q = trt.CommandQueue(dev, out_of_order=True)
    buf = create_buffer(dev, N)
    with pytest.deprecated_call():
        k = dev.build_kernel(bld(k_axpy, TKB), (LSZ,))
    gate = UserEvent("gate")
    ev = q.enqueue_ndrange_kernel(k, (N,), {"x": buf}, wait_for=[gate])
    with pytest.raises(RuntimeError, match="ndrange"):
        q.finish(timeout=0.05)
    assert not ev.done and not host(buf).any()
    gate.complete()
    q.finish()
    assert host(buf).tolist() == [1.0] * N


def test_in_order_queue_keeps_cross_queue_wait_list(plat):
    dev = plat.get_devices()[0]
    other = trt.CommandQueue(dev, out_of_order=True)
    gate = UserEvent("xq")
    far = other._enqueue("far", lambda: None, [gate])
    other.flush()
    q = trt.CommandQueue(dev)
    ran = []
    q._enqueue("first", lambda: ran.append("first"), [])
    q._enqueue("xdep", lambda: ran.append("xdep"), [far])
    q.flush()
    time.sleep(0.02)
    assert "xdep" not in ran
    gate.complete()
    q.finish()
    other.finish()
    assert ran == ["first", "xdep"]


def test_cancel_pending_fails_buffer_commands_typed(plat):
    dev = plat.get_devices()[0]
    q = trt.CommandQueue(dev, out_of_order=True)
    buf = create_buffer(dev, N)
    gate = UserEvent("never")
    armed = q.enqueue_write_buffer(buf, np.ones(N, np.float32),
                                   wait_for=[gate])
    q.flush()
    unflushed = q.enqueue_read_buffer(buf, np.zeros(N, np.float32))
    lost = terrors.DeviceLostError("gone")
    assert set(q.cancel_pending(lost)) == {armed, unflushed}
    with pytest.raises(CommandError):
        q.finish(timeout=5.0)
    assert armed.error is lost and not host(buf).any()
    gate.complete()


# ---------------------------------------------------------------------------
# the host object model around device buffers
# ---------------------------------------------------------------------------

def test_kernel_clone_concurrent_out_of_order_queue():
    ctx = _ctx()
    base = ctx.create_program(bld(k_scale, TKB)).create_kernel()
    q = ctx.create_queue(out_of_order=True, workers=4)
    bufs, events = [], []
    for i in range(8):
        buf = ctx.create_buffer(N)
        ev_w = q.enqueue_write_buffer(buf, np.arange(N, dtype=np.float32))
        k = base.clone().set_args(x=buf, s=float(i + 1))
        events.append(q.enqueue_nd_range(k, (N,), (LSZ,), wait_for=[ev_w]))
        bufs.append(buf)
    q.finish()
    for i, buf in enumerate(bufs):
        assert host(buf).tolist() == [v * (i + 1) for v in range(N)]
    assert all(ev.succeeded for ev in events)
    assert base.missing_args() == ["x", "s"]
    assert q.stats["launches"] == 8 and q.stats["enqueue_compiles"] == 1


def test_enqueue_snapshots_args():
    ctx = _ctx()
    k = ctx.create_program(bld(k_scale, TKB)).create_kernel()
    b1, b2 = ctx.create_buffer(16), ctx.create_buffer(16)
    q = ctx.create_queue()
    q.enqueue_write_buffer(b1, np.ones(16, np.float32))
    q.enqueue_write_buffer(b2, np.ones(16, np.float32))
    k.set_args(x=b1, s=3.0)
    q.enqueue_nd_range(k, (16,), (8,))
    k.set_args(x=b2, s=100.0)
    q.finish()
    assert host(b1).tolist() == [3.0] * 16
    assert host(b2).tolist() == [1.0] * 16


def test_launch_path_buffer_class_checks():
    ctx = _ctx()
    k = ctx.create_program(bld(k_scale, TKB)).create_kernel()
    k.set_args(x=ctx.create_buffer(N), s=2.0)
    with pytest.raises(trt.InvalidArgError, match="accepts"):
        ctx.launch(k, (N,), (LSZ,))
    k.set_args(x=np.ones(N, np.float32))
    q = ctx.create_queue()
    with pytest.raises(trt.InvalidArgError, match="accepts"):
        q.enqueue_nd_range(k, (N,), (LSZ,))
    assert ctx.launch(k, (N,), (LSZ,))["x"].tolist() == [2.0] * N


def test_co_executor_runs_over_the_context_devices():
    """``create_co_executor()`` spans the context's devices and its
    launch equals a single-device launch bitwise."""
    ctx = _ctx()
    co = ctx.create_co_executor()
    assert co.devices == ctx.devices
    k = ctx.create_program(bld(k_scale2, TKB)).create_kernel()
    k.set_args(x=np.arange(N, dtype=np.float32), y=np.zeros(N, np.float32))
    single = ctx.launch(k, (N,), (LSZ,))
    merged = co.launch(k, (N,), (LSZ,), mode="static")
    co.finish()
    assert merged["y"].numpy().tobytes() == single["y"].numpy().tobytes()
    assert sum(co.last_stats.groups_per_device.values()) == N // LSZ


def test_map_guards_raise_typed_errors():
    ctx = _ctx()
    buf = ctx.create_buffer(N)
    q = ctx.create_queue()
    q.enqueue_map_buffer(buf, "w").get()
    k = ctx.create_program(bld(k_scale, TKB)).create_kernel()
    ev = q.enqueue_nd_range(k.set_args(x=buf, s=2.0), (N,), (LSZ,))
    with pytest.raises(CommandError):
        q.finish()
    assert isinstance(ev.error, MapError)
    assert isinstance(ev.error, trt.ReproError)
    assert ev.status == MapError("x").code == -12


def test_deprecated_entry_points_still_work():
    ctx = _ctx()
    dev = ctx.devices[0]
    with pytest.deprecated_call():
        k = dev.build_kernel(bld(k_scale, TKB), (8,))
    out = k({"x": np.ones(8, np.float32)}, (8,), {"s": 4.0})
    assert out["x"].tolist() == [4.0] * 8
    buf = ctx.create_buffer(16)
    q = ctx.create_queue(dev)
    q.enqueue_write_buffer(buf, np.ones(16, np.float32))
    with pytest.deprecated_call():
        q.enqueue_kernel(bld(k_scale, TKB), (8,), (16,), {"x": buf},
                         {"s": 5.0})
    q.finish()
    assert host(buf).tolist() == [5.0] * 16
    assert q.stats["launches"] == 1


def test_context_release_drains_queues_and_trims_pools():
    ctx = _ctx()
    buf = ctx.create_buffer(N)
    q = ctx.create_queue()
    gate = UserEvent("late")
    ev = q.enqueue_write_buffer(buf, np.ones(N, np.float32),
                                wait_for=[gate])
    q.flush()
    threading.Timer(0.05, gate.complete).start()
    buf2 = ctx.create_buffer(N)
    _ = buf2.data
    buf2.release()
    assert ctx.pool_stats()[ctx.devices[0].info.name]["pooled_bytes"] > 0
    ctx.release(timeout=5.0)
    assert ev.succeeded
    assert ctx.pool_stats()[ctx.devices[0].info.name]["pooled_bytes"] == 0


# ---------------------------------------------------------------------------
# the Chrome trace
# ---------------------------------------------------------------------------

def traced_run(ctx, KB, mod):
    """A fused chain, a map and a native command on context queues, one
    of them made before the trace window and one inside it."""
    from importlib import import_module
    ex = import_module(f"{mod.__name__.split('.')[0]}.core.examples")
    early = ctx.create_queue(ctx.devices[0])
    with ctx.trace() as tr:
        prog = ctx.create_program(ex.build_rmsnorm_ew,
                                  ex.build_residual_add)
        bufs = {nm: ctx.create_buffer(N) for nm in "xwryz"}
        q = ctx.create_queue(ctx.devices[0], fusion="flush")
        for nm in "xwr":
            q.enqueue_write_buffer(bufs[nm], np.ones(N, np.float32))
        k1 = prog.create_kernel("rmsnorm_ew")
        k1.set_args(x=bufs["x"], w=bufs["w"], y=bufs["y"], inv_rms=0.5)
        k2 = prog.create_kernel("residual_add")
        k2.set_args(y=bufs["y"], r=bufs["r"], z=bufs["z"])
        q.enqueue_nd_range(k1, (N,), (LSZ,))
        q.enqueue_nd_range(k2, (N,), (LSZ,))
        region = q.enqueue_map_buffer(bufs["z"], "r")
        q.enqueue_unmap_buffer(region)
        q.finish()
        early.enqueue_native(lambda: None, name="native")
        early.finish()
        tr.counter("pages", 3, process="host")
    late = ctx.create_queue(ctx.devices[0])
    late.enqueue_native(lambda: None)
    late.finish()
    return tr


def skeleton(events):
    import re
    return sorted({(e["ph"], re.sub(r"\d+", "N", str(e.get("cat", ""))),
                    re.sub(r"\d+", "N", str(e.get("name", ""))))
                   for e in events})


def test_trace_validates_and_matches_the_reference_skeleton():
    tr = traced_run(_ctx(), TKB, trt)
    jtr = traced_run(_jctx(), JKB, jrt)
    events = tr.trace_events()
    counts = trt.validate_trace(events)
    assert counts == jrt.validate_trace(jtr.trace_events())
    assert counts["X"] == 9 and counts["s"] == counts["f"]
    assert skeleton(events) == skeleton(jtr.trace_events())
    slices = [e for e in events if e["ph"] == "X"]
    fused = [e for e in slices if "fused_from" in e["args"]]
    assert len(fused) == 1
    assert fused[0]["args"]["fused_from"] == ["ndrange:rmsnorm_ew",
                                              "ndrange:residual_add"]
    for e in slices:
        a = e["args"]
        assert a["end_ns"] >= a["start_ns"] >= a["queued_ns"]
        assert e["dur"] == pytest.approx((a["end_ns"] - a["start_ns"]) / 1e3)
    ts = [e["ts"] for e in events]
    assert ts == sorted(ts) and ts[0] == 0


def test_trace_export_writes_chrome_json(tmp_path):
    tr = traced_run(_ctx(), TKB, trt)
    path = str(tmp_path / "out.json")
    doc = tr.export(path)
    with open(path) as f:
        loaded = json.load(f)
    assert loaded["displayTimeUnit"] == "ms"
    assert loaded["traceEvents"] == json.loads(
        json.dumps(doc["traceEvents"], default=float))
    trt.validate_trace(loaded["traceEvents"])


@pytest.mark.parametrize("bad,match", [
    ({"ph": "Z", "name": "?", "ts": 0}, "unknown ph"),
    ({"ph": "X", "name": "k", "pid": 1, "tid": 1, "ts": 3.0}, "missing"),
    ({"ph": "i", "name": "k", "pid": 1, "tid": 1, "ts": -1.0}, "negative ts"),
    ({"ph": "s", "name": "f", "id": 9, "pid": 1, "tid": 1, "ts": 1.0},
     "no finish"),
    ({"ph": "X", "name": "k", "pid": 7, "tid": 1, "ts": 1.0, "dur": 0.0},
     "unnamed pid"),
])
def test_validate_trace_rejects_what_the_reference_rejects(bad, match):
    ok = [{"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
           "ts": 0, "args": {"name": "p"}},
          {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1,
           "ts": 0, "args": {"name": "t"}},
          {"ph": "X", "name": "k", "pid": 1, "tid": 1, "ts": 1.0,
           "dur": 2.0, "args": {}}]
    assert trt.validate_trace(ok) == jrt.validate_trace(ok)
    for validate in (trt.validate_trace, jrt.validate_trace):
        with pytest.raises(ValueError, match=match):
            validate(ok + [bad])


# ---------------------------------------------------------------------------
# stateful harness: the port's buffers, views, maps and residency
# ---------------------------------------------------------------------------

NB = 64                           # elements of a tracked buffer (256 bytes)


class PortMemoryModel:
    """Real objects of the port — context-pooled lazy :class:`Buffer`\\ s
    with a :class:`ResidencyTracker` bound, :class:`SubBuffer` views,
    writes and kernel launches through views, host-bounce maps — beside a
    numpy model of every buffer (``canon``) and of the copies two other
    devices hold.  Each op checks its own contract; :meth:`check` checks
    that every device tensor equals its model, that the arena is sound,
    and that no other device's copy is stale after ``acquire_spans``."""

    def __init__(self):
        self.ctx = _ctx()
        self.dev = self.ctx.devices[0]
        # out of order: a refused command must not fail the next ones
        self.q = self.ctx.create_queue(self.dev, out_of_order=True)
        self.tracker = ResidencyTracker()
        self.kernel = self.ctx.create_program(bld(k_axpy, TKB)).create_kernel()
        self.bufs, self.canon, self.copies = [], [], []
        self.maps = []            # (region, buffer index, lo, hi, values)
        self.stamp = 0

    def _next(self, n):
        self.stamp += 1
        return np.full(n, self.stamp % 97, np.float32)

    def _blocked(self, i, lo, hi, writable):
        return any(j == i and a < hi and lo < b and (writable or r.writable)
                   for r, j, a, b, _ in self.maps)

    def create(self):
        buf = self.ctx.create_buffer(NB)
        buf.bind_residency(self.tracker, len(self.bufs), "host")
        self.bufs.append(buf)
        self.canon.append(np.zeros(NB, np.float32))
        self.copies.append({})
        return len(self.bufs) - 1

    def view(self, i, lo, n):
        lo = min(lo, NB - 1)
        n = max(1, min(n, NB - lo))
        return i, lo, lo + n

    def write(self, view):
        i, lo, hi = view
        vals = self._next(hi - lo)
        sub = create_sub_buffer(self.bufs[i], lo * 4, (hi - lo) * 4)
        ev = self.q.enqueue_write_buffer(sub, vals)
        blocked = self._blocked(i, lo, hi, True)
        self._finish(ev, blocked)
        if not blocked:
            self.canon[i][lo:hi] = vals

    def launch(self, i):
        k = self.kernel.clone().set_args(x=self.bufs[i])
        ev = self.q.enqueue_nd_range(k, (NB,), (LSZ,))
        blocked = self._blocked(i, 0, NB, True)
        self._finish(ev, blocked)
        if not blocked:
            self.canon[i] = self.canon[i] * np.float32(2) + np.float32(1)

    def map(self, view, flags):
        i, lo, hi = view
        sub = create_sub_buffer(self.bufs[i], lo * 4, (hi - lo) * 4)
        region = self.q.enqueue_map_buffer(sub, flags)
        blocked = self._blocked(i, lo, hi, flags != "r")
        self._finish(region.event, blocked)
        if blocked:
            return None
        if flags != "wi":
            assert region.array.tobytes() == \
                self.canon[i][lo:hi].tobytes(), "map read stale bytes"
        vals = self._next(hi - lo)
        region.array[:] = vals
        self.maps.append((region, i, lo, hi, vals))
        assert host(self.bufs[i]).tobytes() == self.canon[i].tobytes(), \
            "a mapped write reached the device before unmap"
        return region

    def unmap(self, region):
        entry = next(m for m in self.maps if m[0] is region)
        self.maps.remove(entry)
        _, i, lo, hi, vals = entry
        self._finish(self.q.enqueue_unmap_buffer(region), False)
        if region.writable:
            self.canon[i][lo:hi] = vals

    def migrate(self, i, dev):
        spans = self.tracker.acquire_spans(i, dev, NB * 4)
        copy = self.copies[i].setdefault(dev, np.zeros(NB, np.float32))
        for lo, hi in spans:
            copy[lo // 4:hi // 4] = self.canon[i][lo // 4:hi // 4]
        assert copy.tobytes() == self.canon[i].tobytes(), \
            f"device {dev} copy of buffer {i} stale after migration"

    def _finish(self, ev, blocked):
        if blocked:
            with pytest.raises(CommandError):
                self.q.finish()
            assert isinstance(ev.error, MapError), ev.error
        else:
            self.q.finish()
            assert ev.succeeded

    def check(self):
        for buf, canon in zip(self.bufs, self.canon):
            assert host(buf).tobytes() == canon.tobytes()
        self.dev.allocator.check_invariants()

    def close(self):
        for region, *_ in list(self.maps):
            self.unmap(region)
        for buf in self.bufs:
            buf.release()
        self.ctx.release()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_memory_random_walk(seed):
    rng = random.Random(seed)
    drv = PortMemoryModel()
    regions = []
    for _ in range(120):
        op = rng.choice(["create", "write", "launch", "map", "unmap",
                         "migrate"])
        if op == "create" or not drv.bufs:
            drv.create()
            continue
        i = rng.randrange(len(drv.bufs))
        view = drv.view(i, rng.randrange(NB), rng.randint(1, NB))
        if op == "write":
            drv.write(view)
        elif op == "launch":
            drv.launch(i)
        elif op == "map":
            r = drv.map(view, rng.choice(["r", "w", "rw", "wi"]))
            if r is not None:
                regions.append(r)
        elif op == "unmap" and regions:
            drv.unmap(regions.pop(rng.randrange(len(regions))))
        elif op == "migrate":
            drv.migrate(i, rng.choice(["d0", "d1"]))
        drv.check()
    drv.close()


if HAVE_HYPOTHESIS:
    class PortMemoryMachine(RuleBasedStateMachine):
        """Hypothesis over :class:`PortMemoryModel`, derandomized: it
        draws the same examples every run, so it can add no flaky
        failure of its own (ROADMAP C.6)."""

        bufs = Bundle("bufs")
        views = Bundle("views")
        maps = Bundle("maps")

        @initialize()
        def init(self):
            self.drv = PortMemoryModel()

        def teardown(self):
            self.drv.close()

        @rule(target=bufs)
        def create(self):
            return self.drv.create()

        @rule(target=views, i=bufs, lo=st.integers(0, NB - 1),
              n=st.integers(1, NB))
        def view(self, i, lo, n):
            return self.drv.view(i, lo, n)

        @rule(view=views)
        def write(self, view):
            self.drv.write(view)

        @rule(i=bufs)
        def launch(self, i):
            self.drv.launch(i)

        @rule(target=maps, view=views,
              flags=st.sampled_from(["r", "w", "rw", "wi"]))
        def map(self, view, flags):
            region = self.drv.map(view, flags)
            return region if region is not None else multiple()

        @rule(region=consumes(maps))
        def unmap(self, region):
            self.drv.unmap(region)

        @rule(i=bufs, dev=st.sampled_from(["d0", "d1"]))
        def migrate(self, i, dev):
            self.drv.migrate(i, dev)

        @invariant()
        def sound(self):
            if hasattr(self, "drv"):
                self.drv.check()

    PortMemoryMachine.TestCase.settings = settings(
        derandomize=True, max_examples=15, stateful_step_count=25,
        deadline=None)
    TestPortMemoryMachine = PortMemoryMachine.TestCase
