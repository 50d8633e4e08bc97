"""The port's DAG fusion (``repro_torch.core.fusion`` and the queue's
rewrite) held against the reference's on the same numpy inputs.

The rmsnorm -> residual -> quantize chain (``core/examples.py``) at
n = 4096 goes through both packages: the stitched function's canonical
IR, ``dag_stats()``, the launch counts and the result bytes must be the
reference's, fused and unfused, on the port's ``vector`` and ``loop``
targets.  Tolerance: bitwise — both sides compute IEEE float32 op for op
and the result is quantized to integers.  The legality negatives leave
the DAG unfused in both packages alike.  A chain that fails IR stitching
runs unfused and is counted; a fused command whose launch raises fails
its mirrored events, and their dependents fail with
``DependencyError``.
"""

import os
import warnings

import numpy as np
import pytest

pytest.importorskip("jax")

import repro.core.examples as jex  # noqa: E402
import repro.core.fusion as jfusion  # noqa: E402
import repro.runtime as jrt  # noqa: E402
from repro.core import canonical_ir as j_canonical_ir  # noqa: E402

import repro_torch.core.examples as tex  # noqa: E402
import repro_torch.core.fusion as tfusion  # noqa: E402
import repro_torch.runtime as trt  # noqa: E402
from repro_torch.core import canonical_ir, ir_hash  # noqa: E402
from repro_torch.core.cache import CompilationCache  # noqa: E402
from repro_torch.core.passes import kernel_fusibility  # noqa: E402
from repro_torch.runtime import (CommandError, DependencyError,  # noqa: E402
                                 Platform, create_sub_buffer)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "fused_chain.txt")
N = 4096
LSZ = (64,)
CHAIN = ("rmsnorm_ew", "residual_add", "quantize")
PKGS = {"port": (trt, tex, tfusion), "ref": (jrt, jex, jfusion)}


def edges(fusion):
    return [fusion.ChainEdge(0, 1, "y", "y", True),
            fusion.ChainEdge(1, 2, "z", "z", True)]


ALIASES = [[(0, "y"), (1, "y")], [(1, "z"), (2, "z")]]


def builders(ex):
    return [ex.build_rmsnorm_ew, ex.build_residual_add, ex.build_quantize]


def context(pkg):
    if pkg == "port":
        return trt.Context(platform=Platform(torch_device="cpu"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return jrt.Context()


def host(buf):
    d = buf.data
    return d.cpu().numpy() if hasattr(d, "cpu") else np.asarray(d)


def inputs(n=N, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(n).astype(np.float32) for _ in range(3))


def run_chain(pkg, fusion, target=None, n=N, ctx=None, read=True):
    """The chain on a fresh queue of a fresh (or given) context; returns
    q, the buffers, the three kernel events and the queue."""
    mod, ex, _ = PKGS[pkg]
    ctx = ctx or context(pkg)
    xh, wh, rh = inputs(n)
    prog = ctx.create_program(*builders(ex))
    bufs = {nm: ctx.create_buffer(n) for nm in "xwryzq"}
    queue = ctx.create_queue(ctx.devices[0], fusion=fusion)
    for nm, h in zip("xwr", (xh, wh, rh)):
        queue.enqueue_write_buffer(bufs[nm], h)
    k1 = prog.create_kernel("rmsnorm_ew")
    k1.set_args(x=bufs["x"], w=bufs["w"], y=bufs["y"], inv_rms=0.5)
    k2 = prog.create_kernel("residual_add")
    k2.set_args(y=bufs["y"], r=bufs["r"], z=bufs["z"])
    k3 = prog.create_kernel("quantize")
    k3.set_args(z=bufs["z"], q=bufs["q"], scale=16.0)
    events = [queue.enqueue_nd_range(k, (n,), LSZ, target=target)
              for k in (k1, k2, k3)]
    out = np.zeros(n, np.float32)
    if read:
        queue.enqueue_read_buffer(bufs["q"], out)
    queue.finish()
    return out, bufs, events, queue


# ---------------------------------------------------------------------------
# the stitched IR
# ---------------------------------------------------------------------------

def test_stitched_chain_ir_is_the_references():
    got, bmap, smap = tfusion.stitch_functions(
        [b() for b in builders(tex)], edges(tfusion), ALIASES)
    want, jbmap, jsmap = jfusion.stitch_functions(
        [b() for b in builders(jex)], edges(jfusion), ALIASES)
    assert canonical_ir(got) == j_canonical_ir(want)
    with open(GOLDEN) as f:
        assert canonical_ir(got) + "\n" == f.read()
    assert (bmap, smap) == (jbmap, jsmap)
    assert [a.name for a in got.buffer_args] == ["k0_x", "k0_w", "k1_r",
                                                 "k2_q"]


@pytest.mark.parametrize("name", CHAIN + ("dct", "reduce2", "condbar"))
def test_fusibility_facts_are_the_references(name):
    t = kernel_fusibility(getattr(tex, f"build_{name}")())
    j = getattr(jex, f"build_{name}")()
    from repro.core.passes import kernel_fusibility as j_facts
    j = j_facts(j)
    assert t.elementwise == j.elementwise
    assert [(f.name, f.loads, f.stores, f.gid_only) for f in t.footprints] \
        == [(f.name, f.loads, f.stores, f.gid_only) for f in j.footprints]


def test_stitch_keeps_store_for_non_elided_edge():
    fused, bmap, _ = tfusion.stitch_functions(
        [tex.build_rmsnorm_ew(), tex.build_residual_add()],
        [tfusion.ChainEdge(0, 1, "y", "y", False)], [[(0, "y"), (1, "y")]])
    assert (0, "y") in bmap
    stores = sorted(i.attrs["buffer"] for blk in fused.blocks.values()
                    for i in blk.instrs if i.op == "store")
    assert stores == ["k0_y", "k1_z"]


def test_stitch_rejects_non_elementwise_segment():
    with pytest.raises(tfusion.FusionError) as ei:
        tfusion.stitch_functions(
            [tex.build_rmsnorm_ew(), tex.build_reduce2()],
            [tfusion.ChainEdge(0, 1, "y", "inp", False)],
            [[(0, "y"), (1, "inp")]])
    assert ei.value.code == -9997
    assert isinstance(ei.value, trt.BuildError)


def test_fused_spec_caches_by_topology():
    cache = CompilationCache()
    args = (builders(tex), ["a", "b", "c"], edges(tfusion), ALIASES)
    s1 = tfusion.build_fused_spec(*args, cache=cache)
    assert tfusion.build_fused_spec(*args, cache=cache) is s1
    assert cache.stats.fused_builds == 1 and cache.stats.fused_hits == 1
    plain = [tfusion.ChainEdge(e.producer, e.consumer, e.prod_arg,
                               e.cons_arg, False) for e in edges(tfusion)]
    s3 = tfusion.build_fused_spec(builders(tex), ["a", "b", "c"], plain,
                                  ALIASES, cache=cache)
    assert s3 is not s1 and cache.fused_cache_size() == 2
    assert s1.program.ir_hash(s1.kernel_name) == ir_hash(
        tfusion.stitch_functions([b() for b in builders(tex)],
                                 edges(tfusion), ALIASES)[0])


# ---------------------------------------------------------------------------
# the queue's rewrite, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fusion", ["off", "flush", "eager"])
@pytest.mark.parametrize("target", [None, "loop"])
def test_chain_matches_reference(fusion, target):
    got, bufs, _, q = run_chain("port", fusion, target)
    ref, jbufs, _, jq = run_chain("ref", fusion,
                                  None if target is None else "vector")
    assert got.tobytes() == ref.tobytes()
    assert q.dag_stats() == jq.dag_stats()
    assert q.stats["launches"] == jq.stats["launches"]
    assert bufs["y"].materialized == jbufs["y"].materialized
    assert bufs["z"].materialized == jbufs["z"].materialized
    assert q.stats["stitch_failures"] == 0
    if fusion != "off":
        assert q.dag_stats()["fused_chains"] == 1
        assert q.dag_stats()["bytes_elided"] == 2 * 2 * N * 4
        assert q.stats["launches"] == 1 and not bufs["y"].materialized


def test_kill_switch_runs_the_chain_unfused(monkeypatch):
    fused, _, _, _ = run_chain("port", "flush")
    monkeypatch.setenv("REPRO_FUSE", "0")
    killed, bufs, _, q = run_chain("port", "flush")
    ref, _, _, jq = run_chain("ref", "flush")
    assert q.dag_stats() == jq.dag_stats()
    assert q.dag_stats()["fused_chains"] == 0
    assert q.stats["launches"] == 3 and bufs["y"].materialized
    assert killed.tobytes() == fused.tobytes() == ref.tobytes()


def test_original_events_complete_and_share_profiling():
    _, _, events, queue = run_chain("port", "flush")
    assert all(e.succeeded for e in events)
    assert len({e.start_ns for e in events}) == 1
    assert len({e.end_ns for e in events}) == 1


def test_fused_event_provenance_names_constituents():
    ctx = context("port")
    prog = ctx.create_program(*builders(tex)[:2])
    bufs = {nm: ctx.create_buffer(N) for nm in "xwryz"}
    queue = ctx.create_queue(ctx.devices[0], fusion="flush")
    k1 = prog.create_kernel("rmsnorm_ew")
    k1.set_args(x=bufs["x"], w=bufs["w"], y=bufs["y"], inv_rms=0.5)
    k2 = prog.create_kernel("residual_add")
    k2.set_args(y=bufs["y"], r=bufs["r"], z=bufs["z"])
    e1 = queue.enqueue_nd_range(k1, (N,), LSZ)
    e2 = queue.enqueue_nd_range(k2, (N,), LSZ)
    queue.flush()
    fused = [e for e in queue.events() if e.fused_from]
    assert len(fused) == 1 and fused[0].fused_from == [e1, e2]
    assert fused[0].name == "fused:rmsnorm_ew+residual_add"
    queue.finish()


def test_repeat_chains_hit_the_fused_tier_and_plan_cache():
    ctx = context("port")
    stats = ctx.devices[0].compile_cache.stats
    q0, _, _, _ = run_chain("port", "flush", ctx=ctx)
    builds, plans = stats.fused_builds, stats.plan_builds
    q1, _, _, _ = run_chain("port", "flush", ctx=ctx)
    q2, _, _, _ = run_chain("port", "flush", ctx=ctx)
    assert q0.tobytes() == q1.tobytes() == q2.tobytes()
    assert stats.fused_builds == builds and stats.plan_builds == plans
    assert stats.fused_hits >= 2


def test_eager_mode_warms_the_fused_tier_at_enqueue():
    ctx = context("port")
    stats = ctx.devices[0].compile_cache.stats
    prog = ctx.create_program(*builders(tex))
    bufs = {nm: ctx.create_buffer(N) for nm in "xwryzq"}
    queue = ctx.create_queue(ctx.devices[0], fusion="eager")
    k1 = prog.create_kernel("rmsnorm_ew")
    k1.set_args(x=bufs["x"], w=bufs["w"], y=bufs["y"], inv_rms=0.5)
    k2 = prog.create_kernel("residual_add")
    k2.set_args(y=bufs["y"], r=bufs["r"], z=bufs["z"])
    before = stats.fused_hits + stats.fused_misses
    queue.enqueue_nd_range(k1, (N,), LSZ)
    queue.enqueue_nd_range(k2, (N,), LSZ)
    assert stats.fused_hits + stats.fused_misses > before
    queue.finish()
    assert queue.dag_stats()["fused_chains"] == 1


def test_pending_chain_spec_is_the_spec_the_rewrite_launches():
    """The spec a caller builds ahead from the pending window is the one
    the flush-time rewrite then finds in the fused tier: a hit, no second
    stitch, one launch."""
    ctx = context("port")
    stats = ctx.devices[0].compile_cache.stats
    prog = ctx.create_program(*builders(tex))
    bufs = {nm: ctx.create_buffer(N) for nm in "xwryzq"}
    queue = ctx.create_queue(ctx.devices[0], fusion="flush")
    k1, k2, k3 = (prog.create_kernel(nm) for nm in CHAIN)
    k1.set_args(x=bufs["x"], w=bufs["w"], y=bufs["y"], inv_rms=0.5)
    k2.set_args(y=bufs["y"], r=bufs["r"], z=bufs["z"])
    k3.set_args(z=bufs["z"], q=bufs["q"], scale=16.0)
    queue.enqueue_nd_range(k1, (N,), LSZ)
    assert queue.pending_chain_spec() is None
    queue.enqueue_nd_range(k2, (N,), LSZ)
    queue.enqueue_nd_range(k3, (N,), LSZ)
    spec = queue.pending_chain_spec()
    assert spec.elided == ((0, "y"), (1, "z"))
    builds, hits = stats.fused_builds, stats.fused_hits
    queue.finish()
    assert stats.fused_builds == builds and stats.fused_hits == hits + 1
    assert queue.dag_stats()["fused_chains"] == 1
    assert queue.stats["launches"] == 1
    assert not bufs["y"].materialized and not bufs["z"].materialized


def test_invalid_fusion_mode_rejected():
    ctx = context("port")
    with pytest.raises(trt.InvalidArgError, match="fusion mode"):
        ctx.create_queue(ctx.devices[0], fusion="sometimes")


# ---------------------------------------------------------------------------
# legality negatives: each leaves the DAG unfused, as in the reference
# ---------------------------------------------------------------------------

def _pair(pkg, scenario):
    """Two kernels of the chain (or a non-elementwise one) enqueued under
    ``scenario``; returns (dag_stats, launches, y materialized, y read
    back or None)."""
    mod, ex, _ = PKGS[pkg]
    ctx = context(pkg)
    second = ex.build_dct if scenario == "non_elementwise" \
        else ex.build_residual_add
    prog = ctx.create_program(ex.build_rmsnorm_ew, second)
    bufs = {nm: ctx.create_buffer(N) for nm in "xwryz"}
    queue = ctx.create_queue(ctx.devices[0], fusion="flush")
    xh, wh, rh = inputs()
    for nm, h in zip("xwr", (xh, wh, rh)):
        queue.enqueue_write_buffer(bufs[nm], h)
    k1 = prog.create_kernel("rmsnorm_ew")
    k1.set_args(x=bufs["x"], w=bufs["w"], y=bufs["y"], inv_rms=0.5)
    if scenario == "non_elementwise":
        k2 = prog.create_kernel("dct")
        k2.set_args(inp=bufs["y"], coef=bufs["r"], out=bufs["z"], width=1)
    elif scenario == "independent":
        k2 = prog.create_kernel("rmsnorm_ew").set_args(
            x=bufs["r"], w=bufs["w"], y=bufs["z"], inv_rms=0.5)
    else:
        y2 = bufs["y"]
        if scenario == "aliased_view":
            _ = bufs["y"].data
            y2 = mod.create_sub_buffer(bufs["y"], 0, N * 4)
        k2 = prog.create_kernel("residual_add")
        k2.set_args(y=y2, r=bufs["r"], z=bufs["z"])
    g1 = (N // 2,) if scenario == "ndrange" else (N,)
    l2 = (32,) if scenario == "local_size" else LSZ
    queue.enqueue_nd_range(k1, (N,), LSZ)
    if scenario == "barrier":
        queue.enqueue_barrier()
    e2 = queue.enqueue_nd_range(k2, g1, l2)
    y_out = None
    if scenario == "observed":
        y_out = np.zeros(N, np.float32)
        queue.enqueue_read_buffer(bufs["y"], y_out, wait_for=[e2])
    queue.finish()
    return (queue.dag_stats(), queue.stats["launches"],
            bufs["y"].materialized, y_out)


SCENARIOS = ["barrier", "ndrange", "local_size", "non_elementwise",
             "observed", "aliased_view", "independent"]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_legality_matches_reference(scenario):
    got = _pair("port", scenario)
    ref = _pair("ref", scenario)
    assert got[:3] == ref[:3]
    if scenario == "observed":
        # fusion stays legal, elision does not: y holds the unfused value
        assert got[0]["fused_chains"] == 1 and got[0]["bytes_elided"] == 0
        xh, wh, _ = inputs()
        assert got[3].tobytes() == (xh * wh * np.float32(0.5)).tobytes()
        assert got[3].tobytes() == ref[3].tobytes()
    else:
        assert got[0]["fused_chains"] == 0 and got[1] == 2


# ---------------------------------------------------------------------------
# failures: stitching, and the fused launch
# ---------------------------------------------------------------------------

def test_stitch_failure_runs_unfused_and_is_counted(monkeypatch):
    from repro_torch.runtime import queue as qmod

    def refuse(*a, **kw):
        raise tfusion.FusionError("planted")
    monkeypatch.setattr(qmod, "build_fused_spec", refuse)
    got, bufs, events, q = run_chain("port", "flush")
    ref, _, _, _ = run_chain("ref", "off")
    assert got.tobytes() == ref.tobytes()
    assert q.stats["stitch_failures"] == 1 and q.stats["launches"] == 3
    assert q.dag_stats()["fused_chains"] == 0
    assert all(e.succeeded for e in events) and bufs["y"].materialized


class _Raises:
    """A fused binary whose launch raises, as a failed build or launch
    of the stitched kernel on the card would."""

    def launch_ndrange(self, *a, **kw):
        raise trt.BuildError("planted launch failure")


def test_failed_fused_launch_fails_originals_and_dependents():
    ctx = context("port")
    dev = ctx.devices[0]
    prog = ctx.create_program(*builders(tex))
    opts = prog.options
    spec = tfusion.build_fused_spec(
        [prog.builder(n) for n in CHAIN], list(CHAIN), edges(tfusion),
        ALIASES, cache=dev.compile_cache,
        key=tfusion.make_fused_key([prog.ir_hash(n) for n in CHAIN],
                                   edges(tfusion), ALIASES, **opts),
        **opts)
    spec.program.binary_for = lambda *a, **kw: _Raises()
    bufs = {nm: ctx.create_buffer(N) for nm in "xwryzq"}
    queue = ctx.create_queue(dev, fusion="flush")
    k1, k2, k3 = (prog.create_kernel(n) for n in CHAIN)
    k1.set_args(x=bufs["x"], w=bufs["w"], y=bufs["y"], inv_rms=0.5)
    k2.set_args(y=bufs["y"], r=bufs["r"], z=bufs["z"])
    k3.set_args(z=bufs["z"], q=bufs["q"], scale=16.0)
    events = [queue.enqueue_nd_range(k, (N,), LSZ) for k in (k1, k2, k3)]
    out = np.zeros(N, np.float32)
    after = queue.enqueue_read_buffer(bufs["q"], out, wait_for=[events[1]])
    with pytest.raises(CommandError):
        queue.finish()
    assert queue.dag_stats()["fused_chains"] == 1
    for ev in events:
        assert ev.failed and isinstance(ev.error, trt.BuildError)
        assert "planted" in str(ev.error)
    assert isinstance(after.error, DependencyError)
    assert queue.stats["stitch_failures"] == 0


def test_fusion_skips_a_mapped_intermediate():
    """A mapped chained buffer is no fusion edge (``map_count``): the
    chain runs unfused and its launch over the map is refused."""
    ctx = context("port")
    prog = ctx.create_program(*builders(tex)[:2])
    bufs = {nm: ctx.create_buffer(N) for nm in "xwryz"}
    mq = ctx.create_queue()
    region = mq.enqueue_map_buffer(create_sub_buffer(bufs["y"], 0, 64), "r")
    region.get()
    queue = ctx.create_queue(fusion="flush")
    k1 = prog.create_kernel("rmsnorm_ew")
    k1.set_args(x=bufs["x"], w=bufs["w"], y=bufs["y"], inv_rms=0.5)
    k2 = prog.create_kernel("residual_add")
    k2.set_args(y=bufs["y"], r=bufs["r"], z=bufs["z"])
    e1 = queue.enqueue_nd_range(k1, (N,), LSZ)
    queue.enqueue_nd_range(k2, (N,), LSZ)
    with pytest.raises(CommandError):
        queue.finish()
    assert queue.dag_stats()["fused_chains"] == 0
    assert isinstance(e1.error, trt.MapError)
    mq.enqueue_unmap_buffer(region)
    mq.finish()
