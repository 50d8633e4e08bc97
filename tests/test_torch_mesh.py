"""The port's replicated serving mesh (``repro_torch.serving.mesh``) held
against the reference's (``repro.serving.mesh``) on the CPU.

* ``tests/test_mesh_props.py``'s seeded random walk and its seven
  failure-ladder scenarios run through both meshes at once, op for op,
  over per-replica deterministic ``StubExecutor``\\ s under the same
  virtual clock: after every op both meshes must have retired the same
  requests in the same order, with the same streams, states and error
  types, and hold the same ``migrations`` list and ``mesh_stats()``
  (router weights included).  Each mesh is also held to the reference
  harness's invariants after every op: exact-once retirement, streams
  that are oracle prefixes, zero drops, KV pages that match the resident
  slots and are zero on a dead replica, no new work on an unhealthy one.
* A hypothesis ``MeshMachine`` drives the same pair, derandomized (a
  fixed example-generation seed), so it adds no flakiness of its own.
* smollm's smoke configuration in float32 on ``TorchExecutor``\\ s, the
  weights carried over from the reference's by ``params_from_jax``: two
  replicas with one killed mid-decode give token streams equal to one
  engine's and to the reference mesh's on ``JaxExecutor``\\ s with
  ``BASELINE_RULES``; the dead replica's caches are dropped and
  ``recover_replica`` serves again from fresh ones.
* ``repro_torch.launch.serve --trace`` exports one process row, a
  ``kv_pages_live`` counter track and one slice per command.
"""

import itertools
import json
import random
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import repro.runtime as jrt  # noqa: E402
import repro.serving as jserving  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import errors as jerrors  # noqa: E402
from repro.distributed.sharding import BASELINE_RULES  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.runtime.bufalloc import OutOfMemory as JOutOfMemory  # noqa: E402
from repro.training.straggler import \
    StragglerConfig as JStragglerConfig  # noqa: E402

import repro_torch.runtime as trt  # noqa: E402
import repro_torch.serving as tserving  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import errors as terrors  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.runtime.bufalloc import \
    OutOfMemory as TOutOfMemory  # noqa: E402
from repro_torch.training.straggler import \
    StragglerConfig as TStragglerConfig  # noqa: E402

try:
    from hypothesis import settings
    from hypothesis import strategies as st
    from hypothesis.stateful import (RuleBasedStateMachine, initialize,
                                     invariant, rule)
    HAVE_HYPOTHESIS = True
except ImportError:               # plain tests below still run
    HAVE_HYPOTHESIS = False

REPLICAS = 3
SLOTS = 2
MAX_SEQ = 64
PAGE_TOKENS = 4
MAX_PROMPT = 8
MAX_NEW = 12

PKGS = {
    "ref": types.SimpleNamespace(
        serving=jserving, DeviceLostError=jerrors.DeviceLostError,
        ReproError=jerrors.ReproError, OutOfMemory=JOutOfMemory,
        StragglerConfig=JStragglerConfig, platform=lambda: {}),
    "port": types.SimpleNamespace(
        serving=tserving, DeviceLostError=terrors.DeviceLostError,
        ReproError=terrors.ReproError, OutOfMemory=TOutOfMemory,
        StragglerConfig=TStragglerConfig,
        platform=lambda: {"platform": trt.Platform(torch_device="cpu")}),
}


def virtual_clock(tick_s: float = 0.001):
    """A deterministic monotone clock: every call advances one tick."""
    counter = itertools.count()
    return lambda: next(counter) * tick_s


def make_mesh(pkg, n_replicas=REPLICAS, **kw):
    p = PKGS[pkg]
    kw.setdefault("straggler_cfg",
                  p.StragglerConfig(window=6, slow_factor=3.0,
                                    persist_steps=2))
    kw.setdefault("timer", virtual_clock())
    return p.serving.ServingMesh(
        n_replicas=n_replicas, batch_slots=SLOTS, max_seq=MAX_SEQ,
        page_tokens=PAGE_TOKENS,
        executor_factory=lambda i: p.serving.StubExecutor(
            batch_slots=SLOTS, max_seq=MAX_SEQ),
        **p.platform(), **kw)


class MeshDriver:
    """``tests/test_mesh_props.py``'s machine body over one package's
    mesh: a real mesh plus the closed-form oracle.  Requests are tracked
    by *object identity*; ``order`` lists the submission index of each
    retirement."""

    def __init__(self, pkg, n_replicas=REPLICAS, **kw):
        self.pkg = PKGS[pkg]
        self.mesh = make_mesh(pkg, n_replicas, **kw)
        self.requests = []        # every request ever submitted
        self.retired = set()      # id(obj) observed terminal, once
        self.order = []           # submission index per retirement
        self.allowed_errors = (self.pkg.DeviceLostError,
                               self.pkg.OutOfMemory)

    # -- ops -------------------------------------------------------------------
    def submit(self, plen, max_new, seed):
        S = self.pkg.serving
        rng = np.random.default_rng(seed)
        r = S.Request(prompt=rng.integers(0, 500, plen).astype(np.int32),
                      max_new_tokens=max_new)
        states = {rep.index: rep.engine.scheduler_stats["waiting"]
                  for rep in self.mesh.replicas}
        self.mesh.submit(r)
        healthy_exists = any(rep.state == S.ReplicaState.HEALTHY
                             for rep in self.mesh.replicas)
        for rep in self.mesh.replicas:
            if rep.engine.scheduler_stats["waiting"] > states[rep.index]:
                assert rep.state != S.ReplicaState.DEAD
                if healthy_exists:
                    assert rep.state == S.ReplicaState.HEALTHY, \
                        f"submit routed to {rep.state} replica"
        self.requests.append(r)
        return r

    def step(self):
        for r in self.mesh.step():
            self._retire(r)

    def kill(self, i, keep_one=True):
        alive = self.mesh.alive()
        if keep_one and len(alive) <= 1:
            return
        self.mesh.kill_replica(alive[i % len(alive)].index)

    def recover(self, i):
        dead = [r for r in self.mesh.replicas
                if r.state == self.pkg.serving.ReplicaState.DEAD]
        if dead:
            self.mesh.recover_replica(dead[i % len(dead)].index)

    def stall(self, i, seconds):
        rep = self.mesh.replicas[i % len(self.mesh.replicas)]
        rep.step_time_override = seconds or None

    def drain(self):
        try:
            for r in self.mesh.drain():
                self._retire(r)
        except self.pkg.ReproError:
            assert not self.mesh.alive()
        for r in self.requests:
            if id(r) not in self.retired and \
                    r.state == self.pkg.serving.RequestState.FAILED:
                self._retire(r)

    # -- the oracle ------------------------------------------------------------
    def _oracle(self, r):
        return self.pkg.serving.StubExecutor.expected_tokens(
            r.prompt, r.max_new_tokens, eos_token=r.eos_token)

    def _retire(self, r):
        RS = self.pkg.serving.RequestState
        assert id(r) not in self.retired, "request retired twice"
        self.retired.add(id(r))
        self.order.append(next(k for k, q in enumerate(self.requests)
                               if q is r))
        if r.done:
            assert r.state == RS.FINISHED
            assert r.out_tokens == self._oracle(r), \
                "stream diverged from the oracle after migration"
        else:
            assert r.state == RS.FAILED
            assert isinstance(r.error, self.allowed_errors), r.error

    def check_invariants(self):
        RS = self.pkg.serving.ReplicaState
        locations = {}
        for rep in self.mesh.replicas:
            eng = rep.engine
            kv = eng.kv_stats
            live_pages = sum(len(s.pages) for s in eng._slots
                             if s is not None)
            assert kv["pages_live"] == live_pages
            if rep.state == RS.DEAD:
                assert kv["pages_live"] == 0
                assert eng.scheduler_stats["waiting"] == 0
                assert eng.scheduler_stats["running"] == 0
            for r in eng._waiting:
                assert id(r) not in locations, "request in two places"
                locations[id(r)] = f"waiting:{rep.key}"
            for s in eng._slots:
                if s is None:
                    continue
                assert id(s.request) not in locations
                locations[id(s.request)] = f"running:{rep.key}"
                oracle = self._oracle(s.request)
                assert s.request.out_tokens == \
                    oracle[:len(s.request.out_tokens)], \
                    "running stream is not an oracle prefix"
        for r in self.mesh._orphans:
            assert id(r) not in locations
            locations[id(r)] = "orphan"
        for r in self.requests:
            here = id(r) in locations
            done = id(r) in self.retired
            assert here or done, "request dropped"
            assert not (here and done), "request both live and retired"
        assert self.mesh.mesh_stats["drops"] == 0

    def check_drained(self):
        assert {id(r) for r in self.requests} == self.retired, \
            "drain left requests behind"
        for rep in self.mesh.replicas:
            assert rep.engine.kv_stats["pages_live"] == 0, \
                f"{rep.key} leaked KV pages"

    # -- what the two packages must agree on -----------------------------------
    def observable(self):
        m = self.mesh
        return {
            "order": list(self.order),
            "streams": [list(r.out_tokens or []) for r in self.requests],
            "states": [r.state for r in self.requests],
            "errors": [type(r.error).__name__ if r.error else None
                       for r in self.requests],
            "migrations": [dict(x) for x in m.migrations],
            "stats": m.mesh_stats,
            "replicas": [(r.state, r.steps, r.load) for r in m.replicas],
            "orphans": len(m._orphans),
            "step": m.current_step,
        }


class PairDriver:
    """The same ops on the reference's mesh and the port's, compared after
    every op; each mesh also checks the harness's invariants."""

    def __init__(self, n_replicas=REPLICAS, **kw):
        self.ref = MeshDriver("ref", n_replicas, **kw)
        self.port = MeshDriver("port", n_replicas, **kw)

    def _both(self, name, *args):
        outs = []
        for d in (self.ref, self.port):
            try:
                outs.append(("ok", getattr(d, name)(*args)))
            except Exception as e:     # compared across the packages
                outs.append(("raised", type(e).__name__))
        (kj, vj), (kt, vt) = outs
        assert kj == kt, (name, outs)
        if kj == "raised":
            assert vj == vt, (name, outs)
        self.compare()
        return outs[1][1] if kt == "ok" else None

    def submit(self, plen, max_new, seed):
        return self._both("submit", plen, max_new, seed)

    def step(self):
        self._both("step")

    def kill(self, i, keep_one=True):
        self._both("kill", i, keep_one)

    def recover(self, i):
        self._both("recover", i)

    def stall(self, i, seconds):
        self._both("stall", i, seconds)

    def drain(self):
        self._both("drain")

    def kill_replica(self, i):
        self.ref.mesh.kill_replica(i)
        self.port.mesh.kill_replica(i)

    def compare(self):
        a, b = self.ref.observable(), self.port.observable()
        for k in a:
            assert a[k] == b[k], (k, a[k], b[k])

    def check_invariants(self):
        self.ref.check_invariants()
        self.port.check_invariants()

    def check_drained(self):
        self.ref.check_drained()
        self.port.check_drained()


# --------------------------------------------------------------------------
# the reference harness's seeded random walk, through both meshes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_mesh_random_walk_matches_reference(seed):
    rnd = random.Random(seed)
    d = PairDriver()
    for _ in range(80):
        op = rnd.random()
        if op < 0.35 and len(d.port.requests) < 30:
            d.submit(rnd.randint(2, MAX_PROMPT), rnd.randint(1, MAX_NEW),
                     rnd.randint(0, 10**6))
        elif op < 0.42:
            d.kill(rnd.randint(0, 9))
        elif op < 0.50:
            d.recover(rnd.randint(0, 9))
        elif op < 0.56:
            d.stall(rnd.randint(0, 9), rnd.choice([0.0, 0.05, 0.5]))
        else:
            d.step()
        d.check_invariants()
    d.drain()
    d.check_invariants()
    d.check_drained()


# --------------------------------------------------------------------------
# the reference harness's failure-ladder scenarios, through both meshes
# --------------------------------------------------------------------------

def _submit_n(d, n, seed=0, max_new=6):
    rng = random.Random(seed)
    return [d.submit(rng.randint(2, MAX_PROMPT), max_new,
                     rng.randint(0, 10**6)) for _ in range(n)]


def test_kill_during_prefill_migrates_and_matches_reference():
    d = PairDriver()
    reqs = _submit_n(d, 6, seed=1)
    victim = next(rep for rep in d.port.mesh.replicas if rep.load > 0)
    d.kill_replica(victim.index)
    d.step()
    d.check_invariants()
    assert victim.state == tserving.ReplicaState.DEAD
    assert victim.engine.kv_stats["pages_live"] == 0
    d.drain()
    d.check_drained()
    assert all(r.done and r.out_tokens == d.port._oracle(r) for r in reqs)
    stats = d.port.mesh.mesh_stats
    assert stats["migrated"] >= 1 and stats["drops"] == 0
    assert isinstance(d.port.mesh.last_device_loss, terrors.DeviceLostError)


def test_kill_during_decode_migrates_and_matches_reference():
    d = PairDriver()
    reqs = _submit_n(d, 6, seed=2, max_new=10)
    d.step()
    victim = next(rep for rep in d.port.mesh.replicas if rep.load > 0)
    mid_flight = [s.request for s in victim.engine._slots
                  if s is not None and s.request.out_tokens]
    assert mid_flight
    d.kill_replica(victim.index)
    d.step()
    d.check_invariants()
    assert victim.engine.device_lost is not None
    d.drain()
    d.check_drained()
    assert all(r.done and r.out_tokens == d.port._oracle(r) for r in reqs)


def test_kill_all_then_recover_requeues_orphans():
    d = PairDriver(n_replicas=2)
    reqs = _submit_n(d, 5, seed=3)
    d.step()
    for i in range(2):
        d.kill_replica(i)
    d.step()
    d.check_invariants()
    assert not d.port.mesh.alive()
    assert len(d.port.mesh._orphans) == len(reqs)
    d.ref.mesh.recover_replica(0)
    d.port.mesh.recover_replica(0)
    d.compare()
    d.check_invariants()
    assert not d.port.mesh._orphans
    d.drain()
    d.check_drained()
    assert all(r.done and r.out_tokens == d.port._oracle(r) for r in reqs)


def test_all_replicas_dead_surfaces_typed_never_hangs():
    d = PairDriver(n_replicas=2)
    reqs = _submit_n(d, 4, seed=4)
    for i in range(2):
        d.kill_replica(i)
    d.step()
    with pytest.raises(jerrors.DeviceLostError):
        d.ref.mesh.drain()
    with pytest.raises(terrors.DeviceLostError):
        d.port.mesh.drain()
    assert all(isinstance(r.error, terrors.DeviceLostError) for r in reqs)
    with pytest.raises(terrors.DeviceLostError):
        d.port.submit(4, 2, 0)
    with pytest.raises(jerrors.DeviceLostError):
        d.ref.submit(4, 2, 0)
    d.drain()
    d.check_drained()


def test_oom_on_mesh_surfaces_typed_out_of_memory():
    d = PairDriver(n_replicas=1, kv_budget_bytes=PAGE_TOKENS * 64 * 1)
    r = d.submit(MAX_PROMPT, 8, 5)
    d.drain()
    d.check_invariants()
    d.check_drained()
    assert r.state == tserving.RequestState.FAILED
    assert isinstance(r.error, TOutOfMemory)


def test_straggler_drains_then_rejoins():
    d = PairDriver()
    d.stall(0, 0.5)
    _submit_n(d, 6, seed=6, max_new=8)
    flagged = False
    for _ in range(30):
        d.step()
        d.check_invariants()
        if d.port.mesh.replicas[0].state == tserving.ReplicaState.DRAINING:
            flagged = True
            r = d.submit(4, 2, 7)
            assert not any(w is r for w in
                           d.port.mesh.replicas[0].engine._waiting)
            break
    assert flagged, "persistent straggler never drained"
    d.stall(0, 0.0)
    d.drain()
    d.check_drained()
    assert d.port.mesh.replicas[0].state == tserving.ReplicaState.HEALTHY


def test_router_prefers_fast_replicas():
    loads = {}
    for pkg in ("ref", "port"):
        mesh = make_mesh(pkg)
        for _ in range(6):
            mesh._model.observe(0, 1, 0.8)
            mesh._model.observe(1, 1, 0.8)
            mesh._model.observe(2, 1, 0.1)
        counts = {0: 0, 1: 0, 2: 0}
        rng = np.random.default_rng(8)
        seq = []
        for _ in range(12):
            r = PKGS[pkg].serving.Request(
                prompt=rng.integers(0, 500, 4).astype(np.int32),
                max_new_tokens=2)
            mesh.submit(r)
            seq.append([rep.load for rep in mesh.replicas])
            for rep in mesh.replicas:
                counts[rep.index] = max(counts[rep.index], rep.load)
        assert counts[2] == max(counts.values())
        loads[pkg] = (seq, mesh.mesh_stats)
        mesh.drain()
    assert loads["port"] == loads["ref"]


# --------------------------------------------------------------------------
# what only the port has: devices, errors, released caches
# --------------------------------------------------------------------------

def test_replica_devices_and_the_card_default(monkeypatch):
    mesh = make_mesh("port", n_replicas=2)
    names = [rep.device.info.name for rep in mesh.replicas]
    assert [rep.device.info.driver for rep in mesh.replicas] == \
        ["vector", "vector"]
    assert len(set(names)) == 2
    assert all(rep.context.devices == [rep.device] for rep in mesh.replicas)
    monkeypatch.setattr(trt.platform, "_default_platform", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(trt.DeviceNotFoundError):
        tserving.ServingMesh(
            n_replicas=2, batch_slots=SLOTS, max_seq=MAX_SEQ,
            executor_factory=lambda i: tserving.StubExecutor(
                batch_slots=SLOTS, max_seq=MAX_SEQ))
    with pytest.raises(terrors.InvalidArgError):
        make_mesh("port", n_replicas=0)


# --------------------------------------------------------------------------
# the hypothesis state machine, derandomized, over both meshes
# --------------------------------------------------------------------------

if HAVE_HYPOTHESIS:

    class MeshMachine(RuleBasedStateMachine):
        @initialize()
        def setup(self):
            self.d = PairDriver()

        @rule(plen=st.integers(2, MAX_PROMPT),
              max_new=st.integers(1, MAX_NEW),
              seed=st.integers(0, 10**6))
        def submit(self, plen, max_new, seed):
            if len(self.d.port.requests) < 40 and self.d.port.mesh.alive():
                self.d.submit(plen, max_new, seed)

        @rule()
        def step(self):
            self.d.step()

        @rule(n=st.integers(2, 5))
        def step_many(self, n):
            for _ in range(n):
                self.d.step()

        @rule(i=st.integers(0, 9))
        def kill(self, i):
            self.d.kill(i)

        @rule(i=st.integers(0, 9))
        def recover(self, i):
            self.d.recover(i)

        @rule(i=st.integers(0, 9),
              s=st.sampled_from([0.0, 0.05, 0.5]))
        def stall(self, i, s):
            self.d.stall(i, s)

        @invariant()
        def invariants(self):
            if hasattr(self, "d"):
                self.d.check_invariants()

        def teardown(self):
            if hasattr(self, "d"):
                self.d.drain()
                self.d.check_invariants()
                self.d.check_drained()

    TestMeshMachine = MeshMachine.TestCase
    TestMeshMachine.settings = settings(
        derandomize=True, max_examples=15, stateful_step_count=30,
        deadline=None)


# --------------------------------------------------------------------------
# the model: smollm's smoke configuration in float32
# --------------------------------------------------------------------------

ARCH = "smollm-135m"
M_SLOTS, M_SEQ = 2, 48


def _model_params(seed=3):
    jcfg = jconfigs.get_smoke(ARCH, dtype="float32")
    tcfg = tconfigs.get_smoke(ARCH, dtype="float32")
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           tcfg)


def _model_requests(Request, vocab):
    rng = np.random.default_rng(21)
    return [Request(prompt=rng.integers(0, vocab, int(n)).astype(np.int32),
                    max_new_tokens=int(m))
            for n, m in zip((5, 9, 3, 12, 7, 4), (8, 6, 9, 5, 7, 8))]


def _kill_mid_decode(mesh):
    """Step until replica 1 holds residents past their second decoded
    token, then arm its device loss and drain; returns the requests the
    loss migrated."""
    for _ in range(50):
        mesh.step()
        slots = [s for s in mesh.replicas[1].engine._slots if s is not None]
        if slots and all(len(s.request.out_tokens) > 2 for s in slots):
            break
    else:
        raise AssertionError("replica 1 never held decoding residents")
    mesh.replicas[1].engine.inject_fault(stage="device")
    mesh.drain()
    return list(mesh.last_migrated)


def test_two_replicas_one_killed_mid_decode_stream_equal_one_engine():
    """Token streams equal: the port's mesh with replica 1 killed mid-
    decode, one port engine, and the reference's mesh on JaxExecutors
    killed at the same step."""
    jcfg, tcfg, jp, tp = _model_params()
    alone = tserving.ServingEngine(
        tcfg, tp, batch_slots=M_SLOTS, max_seq=M_SEQ,
        context=trt.Context(platform=trt.Platform(torch_device="cpu")))
    one = _model_requests(tserving.Request, tcfg.vocab)
    alone.generate(one)

    port = tserving.ServingMesh(
        tcfg, tp, n_replicas=2, batch_slots=M_SLOTS, max_seq=M_SEQ,
        timer=virtual_clock(), platform=trt.Platform(torch_device="cpu"))
    reqs = _model_requests(tserving.Request, tcfg.vocab)
    for r in reqs:
        port.submit(r)
    tr = port.attach_trace()
    moved = _kill_mid_decode(port)

    ref = jserving.ServingMesh(
        jcfg, jp, BASELINE_RULES, n_replicas=2, batch_slots=M_SLOTS,
        max_seq=M_SEQ, timer=virtual_clock(), platform=jrt.Platform())
    jreqs = _model_requests(jserving.Request, jcfg.vocab)
    for r in jreqs:
        ref.submit(r)
    _kill_mid_decode(ref)

    assert moved and all(r.done for r in reqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in one]
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert port.migrations == ref.migrations
    stats = port.mesh_stats
    assert stats["drops"] == 0 and stats["device_losses"] == 1
    assert stats["migrated"] == len(moved) > 0
    assert [r["pages_live"] for r in stats["replicas"]] == [0, 0]
    # the dead replica's caches and executor tensors are gone
    dead = port.replicas[1].engine
    assert dead._state is None and dead._exec.params is None
    doc = tr.trace_events()
    flows = [e["name"] for e in doc
             if e["ph"] == "s" and e["name"].startswith("migrate:")]
    assert sorted(flows) == \
        sorted(f"migrate:r{m['request']}" for m in port.migrations)
    assert trt.validate_trace(doc)["s"] >= len(moved)

    # a recovered replica serves again from fresh caches
    port.recover_replica(1)
    assert port.replicas[1].engine._state is None
    more = _model_requests(tserving.Request, tcfg.vocab)[:4]
    for r in more:
        port.submit(r)
    port.drain()
    assert [r.out_tokens for r in more] == [r.out_tokens for r in one[:4]]
    assert port.replicas[1].steps > 0 and \
        port.replicas[1].engine.compile_stats["prefill_calls"] > 0


def test_serve_cli_trace(tmp_path, capsys):
    out = tmp_path / "serve.json"
    run = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--requests", "3", "--max-new", "4",
                       "--trace", str(out)])
    assert "trace:" in capsys.readouterr().out
    doc = json.loads(out.read_text())
    ev = doc["traceEvents"]
    procs = [e for e in ev if e["ph"] == "M" and e["name"] == "process_name"]
    assert len(procs) == 1
    pid = procs[0]["pid"]
    kv = [e for e in ev if e["ph"] == "C" and e["name"] == "kv_pages_live"]
    assert len(kv) == run["engine"].scheduler_stats["steps"]
    assert all(e["pid"] == pid for e in kv)
    assert kv[-1]["args"]["value"] == 0
    slices = [e for e in ev if e["ph"] == "X"]
    assert len(slices) == run["engine"].dag_stats["events"] > 0
    assert trt.validate_trace(ev)["X"] == len(slices)
