"""Replicated serving mesh: a front-end router over N engine replicas.

The port of ``repro.serving.mesh``, with the same router, failure ladder
and trace.  :class:`ServingMesh` owns ``n_replicas`` independent
:class:`~repro_torch.serving.engine.ServingEngine` replicas — each on its
own :class:`~repro_torch.runtime.context.Context` over its own device —
and routes ``submit()`` across them so callers see one engine with N
replicas' throughput and none of their failures.

**Devices.** Each replica gets a fresh device of the platform
(:meth:`~repro_torch.runtime.platform.Platform.co_devices`): a ``cuda``
device when the platform is on a card — two replicas on one H100 are two
``cuda`` devices of it, sharing its SMs and memory — and a ``vector``
device on a CPU platform.  The mesh runs on the card unless asked
otherwise: the default platform is the card's, and with no card and no
``platform`` it raises
:class:`~repro_torch.runtime.platform.DeviceNotFoundError`; tests pass
``Platform(torch_device="cpu")``.  The model runs where its ``params``
are.  The reference's per-replica sharding ``rules`` have no counterpart
here: the port's engine takes none.

**Router policy** (docs/mesh.md §Router): a request goes to the healthy
replica with the best ``weight / (1 + queued_work)`` score, where the
weight is the :class:`~repro_torch.runtime.scheduler.ThroughputModel`
EWMA fed by per-replica step timings (host wall time around
``eng.step()``) — a replica that steps slowly is de-weighted before the
straggler monitor ever flags it.  DRAINING replicas (flagged by
:class:`~repro_torch.training.straggler.StragglerMonitor`) receive new
work only when no HEALTHY replica remains; DEAD replicas never do.

**Failure ladder** (docs/mesh.md §Failure ladder): a
:class:`~repro_torch.core.errors.DeviceLostError` (or injected
``inject_fault(stage="device")``) mid-group fails every resident of that
replica with the typed error, drains its KV pages to zero, and marks it
DEAD.  The mesh then *migrates*: residents lost mid-flight plus the
replica's still-waiting admissions are requeued on one sibling replica
at the FRONT of its queue (greedy decode makes the recompute give the
same stream), order preserved.  Zero requests are dropped; the typed
error is surfaced on :attr:`ServingMesh.last_device_loss` and counted.
With no live sibling the victims park as orphans until
:meth:`recover_replica`; if every replica is dead, ``submit``/``drain``
raise the typed error instead of hanging.

A dead replica gives back its device memory: once its dispatch queue has
settled (and, on a card, the device's stream has drained), its engine
drops the model's batch caches and its executor's device tensors.
:meth:`recover_replica` builds a fresh engine through the executor
factory, whose caches are made anew on its first step.

**Observability**: :meth:`attach_trace` wires every replica's dispatch
queue into one :class:`~repro_torch.runtime.trace.ChromeTrace` (one
process row per replica), records per-step ``kv_pages_live`` /
queue-depth counter tracks, and emits a flow arrow for every migration.

``tests/test_torch_mesh.py`` holds this module to the reference's on the
same seeded virtual-time walks and scenarios, with the reference's
invariants (exact-once retirement, streams are oracle prefixes, zero
drops, KV pages drain to zero on live *and* dead replicas, unhealthy
replicas never receive new work).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..core.errors import InvalidArgError, ReproError
from ..runtime.context import Context
from ..runtime.events import CommandError
from ..runtime.platform import default_platform
from ..runtime.scheduler import ThroughputModel
from ..runtime.trace import ChromeTrace
from ..training.straggler import StragglerConfig, StragglerMonitor

from .engine import Request, RequestState, ServingEngine

__all__ = ["ServingMesh", "Replica", "ReplicaState"]


class ReplicaState:
    """Replica health ladder: HEALTHY (routable) -> DRAINING (flagged
    slow; finishes residents, new work only as a last resort) -> back to
    HEALTHY once empty, or DEAD (device lost; never routable again until
    :meth:`ServingMesh.recover_replica`)."""

    HEALTHY = "healthy"
    DRAINING = "draining"
    DEAD = "dead"


class Replica:
    """One mesh slot: an engine on its own context/device plus health
    and timing state."""

    __slots__ = ("index", "engine", "context", "device", "state",
                 "step_time_override", "steps", "loss")

    def __init__(self, index: int, engine: ServingEngine,
                 context: Context, device) -> None:
        self.index = index
        self.engine = engine
        self.context = context
        self.device = device
        self.state = ReplicaState.HEALTHY
        # virtual-time hook: when set, observed step duration (fed to
        # the throughput model and straggler monitor) is this value
        # instead of the wall clock — the property harness stalls a
        # replica without sleeping
        self.step_time_override: Optional[float] = None
        self.steps = 0
        self.loss: Optional[BaseException] = None

    @property
    def key(self) -> str:
        return f"r{self.index}"

    @property
    def load(self) -> int:
        s = self.engine.scheduler_stats
        return s["waiting"] + s["running"]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<Replica {self.index} {self.state} load={self.load}>"


class ServingMesh:
    """Front-end router owning N replica serving engines (module
    docstring: devices, router policy, failure ladder, observability).

    Parameters
    ----------
    cfg, params:
        Model config / parameters handed to every replica engine (the
        parameters on the device the model runs on).  Pass ``None`` for
        both when supplying ``executor_factory``.
    n_replicas:
        Replica count; each gets a fresh platform device
        (:meth:`~repro_torch.runtime.platform.Platform.co_devices`:
        ``cuda`` on a card, ``vector`` on a CPU platform) wrapped in its
        own single-device :class:`~repro_torch.runtime.context.Context`.
    executor_factory:
        ``factory(replica_idx) -> BatchExecutor`` — the property harness
        passes per-replica
        :class:`~repro_torch.serving.executor.StubExecutor`\\ s; also how
        :meth:`recover_replica` rebuilds a dead replica's engine.
    ewma_alpha / straggler_cfg:
        Router throughput-EWMA smoothing and straggler thresholds.
    timer:
        Clock used for per-replica step timing (default
        ``time.perf_counter``); injectable for virtual-time tests.
    platform:
        The :class:`~repro_torch.runtime.platform.Platform` the replicas'
        devices come from (default: the card's, raising
        ``DeviceNotFoundError`` without one).
    rules:
        Sharding rules handed to every replica engine, or a list of them,
        one per replica (as the reference's).
    engine_kwargs:
        Everything else (``batch_slots``, ``max_seq``, ``page_tokens``,
        ``kv_budget_bytes``, ``scheduler``, ...) is forwarded verbatim
        to every :class:`~repro_torch.serving.engine.ServingEngine`.
    """

    def __init__(self, cfg=None, params=None, n_replicas: int = 2,
                 executor_factory: Optional[Callable[[int], Any]] = None,
                 ewma_alpha: float = 0.5,
                 straggler_cfg: Optional[StragglerConfig] = None,
                 timer: Callable[[], float] = time.perf_counter,
                 platform=None, rules=None, **engine_kwargs):
        if n_replicas < 1:
            raise InvalidArgError(
                f"mesh needs >= 1 replica, got {n_replicas}")
        self._rules = list(rules) if isinstance(rules, (list, tuple)) \
            else [rules] * n_replicas
        if len(self._rules) != n_replicas:
            raise InvalidArgError(
                f"{len(self._rules)} sharding rules for {n_replicas} "
                f"replicas")
        self.platform = platform or default_platform()
        self._factory = executor_factory
        self._cfg, self._params = cfg, params
        self._engine_kwargs = dict(engine_kwargs)
        self._timer = timer
        self._model = ThroughputModel(alpha=ewma_alpha)
        self._monitor = StragglerMonitor(straggler_cfg
                                         or StragglerConfig())
        self._trace: Optional[ChromeTrace] = None

        on_card = self.platform.torch_devices[0].type == "cuda"
        devices = self.platform.co_devices(
            n_replicas, driver="cuda" if on_card else "vector")
        self.replicas: List[Replica] = []
        for i, dev in enumerate(devices):
            ctx = Context(devices=[dev], platform=self.platform)
            eng = self._make_engine(i, ctx, dev)
            self.replicas.append(Replica(i, eng, ctx, dev))

        self._step_idx = 0
        self._orphans: List[Request] = []
        self.last_device_loss: Optional[BaseException] = None
        self.migrations: List[Dict[str, Any]] = []
        # the Request objects moved by the most recent migration, in
        # requeue order — recovery is measured (steps until each is
        # decoding again on the sibling) from these
        self.last_migrated: List[Request] = []
        self._sched = {"submitted": 0, "completed": 0, "failed": 0,
                       "migrated": 0, "orphaned": 0, "device_losses": 0,
                       "drops": 0, "steps": 0}

    def _make_engine(self, i: int, ctx: Context, dev) -> ServingEngine:
        executor = self._factory(i) if self._factory is not None else None
        return ServingEngine(self._cfg, self._params, context=ctx,
                             device=dev, executor=executor,
                             rules=self._rules[i], **self._engine_kwargs)

    # ======================================================================
    # introspection
    # ======================================================================
    @property
    def current_step(self) -> int:
        return self._step_idx

    def alive(self) -> List[Replica]:
        """Replicas that can still run work (HEALTHY or DRAINING)."""
        return [r for r in self.replicas
                if r.state != ReplicaState.DEAD]

    def _candidates(self) -> List[Replica]:
        """Routable replicas: HEALTHY first; DRAINING only when no
        HEALTHY replica remains; DEAD never."""
        healthy = [r for r in self.replicas
                   if r.state == ReplicaState.HEALTHY]
        if healthy:
            return healthy
        return [r for r in self.replicas
                if r.state == ReplicaState.DRAINING]

    @property
    def mesh_stats(self) -> Dict[str, Any]:
        """Router counters plus per-replica health/load/weight."""
        out: Dict[str, Any] = dict(self._sched)
        cands = self.alive()
        w = self._model.weights([r.index for r in cands]) if cands else []
        weights = {r.key: round(wi, 4) for r, wi in zip(cands, w)}
        out["replicas"] = [
            {"key": r.key, "state": r.state, "load": r.load,
             "steps": r.steps, "weight": weights.get(r.key, 0.0),
             "pages_live": r.engine.kv_stats["pages_live"]}
            for r in self.replicas]
        out["orphans"] = len(self._orphans)
        return out

    # ======================================================================
    # submission / routing
    # ======================================================================
    def _best(self, cands: List[Replica]) -> Replica:
        """The best throughput per unit of queued work; the lowest index
        breaks ties, so routing is deterministic under equal weights."""
        weights = self._model.weights([r.index for r in cands])
        return max(zip(weights, cands),
                   key=lambda wc: (wc[0] / (1 + wc[1].load),
                                   -wc[1].index))[1]

    def _route(self) -> Replica:
        cands = self._candidates()
        if not cands:
            raise self.last_device_loss or ReproError(
                "no live replica in the mesh")
        return self._best(cands)

    def submit(self, request: Request,
               replica: Optional[int] = None) -> int:
        """Admit one request, routed to the best live replica (module
        docstring: router policy).  ``replica`` pins it (tests).  Raises
        the typed device-loss error when every replica is dead."""
        if replica is not None:
            rep = self.replicas[replica]
            if rep.state == ReplicaState.DEAD:
                raise (rep.loss or ReproError(f"{rep.key} is dead"))
        else:
            rep = self._route()
        rid = rep.engine.submit(request)
        self._sched["submitted"] += 1
        return rid

    # ======================================================================
    # fault hooks (test/chaos API)
    # ======================================================================
    def kill_replica(self, i: int,
                     error: Optional[BaseException] = None) -> None:
        """Arm a replica-level device loss on replica ``i`` — it fires
        through that replica's next DAG round (kill-during-prefill /
        -decode, depending on what the round is doing), after which
        :meth:`step` observes the terminal engine and migrates."""
        self.replicas[i].engine.inject_fault(stage="device", error=error)

    def recover_replica(self, i: int) -> None:
        """Bring a DEAD replica back with a *fresh* engine (same
        context/device — the model server restarted; its executor comes
        from the factory and its caches are made on its first step);
        parked orphans requeue onto it immediately, order preserved."""
        rep = self.replicas[i]
        if rep.state != ReplicaState.DEAD:
            return
        rep.engine = self._make_engine(i, rep.context, rep.device)
        rep.state = ReplicaState.HEALTHY
        rep.loss = None
        self._monitor.forget(rep.key)
        if self._trace is not None:
            self._trace.attach_queue(
                rep.engine._queue, process=self._proc(rep),
                thread=f"dispatch-gen{rep.steps}")
        orphans, self._orphans = self._orphans, []
        for req in orphans:
            rep.engine.submit(req)

    # ======================================================================
    # stepping
    # ======================================================================
    def _observe(self, rep: Replica, running_before: int,
                 dt: float) -> None:
        if rep.step_time_override is not None:
            dt = rep.step_time_override
        self._model.observe(rep.index, max(1, running_before), dt)
        self._monitor.record(rep.key, dt)

    def _release(self, rep: Replica) -> None:
        """Give back a dead replica's device memory: settle its dispatch
        queue (every command of the fatal round has run or been
        cancelled) and, on a card, the device's stream, so no kernel
        still reads the caches; then drop the engine's batch state (the
        model's caches) and, where its executor has a ``release``
        (:meth:`~repro_torch.serving.executor.TorchExecutor.release`),
        the executor's own device tensors.  The dead engine never steps
        again."""
        eng = rep.engine
        try:
            eng._queue.finish()
        except CommandError:
            pass            # the round's failures are already surfaced
        if rep.device.torch_device.type == "cuda":
            torch.cuda.synchronize(rep.device.torch_device)
        eng._state = None
        release = getattr(eng._exec, "release", None)
        if release is not None:
            release()

    def _migrate(self, rep: Replica,
                 lost: List[Request]) -> None:
        """Requeue a dead replica's in-flight + waiting requests on one
        sibling, at the FRONT of its queue, order preserved (greedy
        decode recomputes the same stream)."""
        err = rep.engine.device_lost
        rep.state = ReplicaState.DEAD
        rep.loss = err
        self.last_device_loss = err
        self._sched["device_losses"] += 1
        self._monitor.forget(rep.key)
        self._release(rep)
        victims = lost + rep.engine.release_waiting()
        for req in victims:
            req.state = RequestState.WAITING
            req.done = False
            req.error = None
            req.out_tokens = []
        cands = self._candidates()
        if not cands:
            self._orphans.extend(victims)
            self._sched["orphaned"] += len(victims)
            return
        sibling = self._best(cands)
        # front-requeue in reverse so victims[0] decodes first again
        for req in reversed(victims):
            sibling.engine.submit(req, front=True)
        self._sched["migrated"] += len(victims)
        self.last_migrated = list(victims)
        if self._trace is not None:
            for req in victims:
                src = self._trace.instant(
                    f"lost:r{req.id}", process=self._proc(rep),
                    args={"error": type(err).__name__})
                dst = self._trace.instant(
                    f"requeue:r{req.id}", process=self._proc(sibling))
                self._trace.flow(f"migrate:r{req.id}", src, dst)
        for req in victims:
            self.migrations.append(
                {"step": self._step_idx, "request": req.id,
                 "src": rep.key, "dst": sibling.key,
                 "error": type(err).__name__})

    def step(self) -> List[Request]:
        """One mesh step: step every live replica, feed the router's
        throughput EWMA and the straggler monitor with the step timings,
        migrate off any replica whose device was lost, and apply the
        straggler verdicts.  Returns the requests that *retired* this
        step (finished or terminally failed) — a migrated request is not
        retired and does not appear."""
        self._step_idx += 1
        self._sched["steps"] += 1
        retired: List[Request] = []
        for rep in self.replicas:
            if rep.state == ReplicaState.DEAD:
                continue
            eng = rep.engine
            running_before = eng.scheduler_stats["running"]
            t0 = self._timer()
            finished = eng.step()
            self._observe(rep, running_before, self._timer() - t0)
            rep.steps += 1
            if self._trace is not None:
                self._trace.counter("kv_pages_live",
                                    eng.kv_stats["pages_live"],
                                    process=self._proc(rep))
                self._trace.counter("waiting",
                                    eng.scheduler_stats["waiting"],
                                    process=self._proc(rep))
            if eng.device_lost is not None:
                # residents failed by the loss migrate; requests that
                # failed the same step from their *own* injected fault
                # carry a different error object and retire as failed
                lost = [r for r in finished
                        if r.error is eng.device_lost]
                other = [r for r in finished
                         if r.error is not eng.device_lost]
                self._migrate(rep, lost)
                finished = other
            for r in finished:
                if r.error is not None:
                    self._sched["failed"] += 1
                else:
                    self._sched["completed"] += 1
                retired.append(r)
        # straggler ladder: persistent outliers drain (no new work while
        # a healthy sibling exists); an empty drained replica rejoins
        flagged = set(self._monitor.check())
        healthy = sum(1 for r in self.replicas
                      if r.state == ReplicaState.HEALTHY)
        for rep in self.replicas:
            if rep.state == ReplicaState.HEALTHY and \
                    rep.key in flagged and healthy > 1:
                rep.state = ReplicaState.DRAINING
                healthy -= 1
            elif rep.state == ReplicaState.DRAINING and rep.load == 0:
                rep.state = ReplicaState.HEALTHY
                self._monitor.forget(rep.key)
                healthy += 1
        return retired

    def drain(self, max_steps: Optional[int] = None) -> List[Request]:
        """Step until no live replica holds work and no orphan is
        parked; returns the retired requests in retirement order.
        Raises the typed device-loss error — after failing every parked
        orphan with it — when all replicas are dead with work pending
        (never a hang)."""
        done: List[Request] = []
        stalled = 0
        while True:
            pending = sum(r.load for r in self.alive())
            if pending == 0 and not self._orphans:
                return done
            if not self.alive():
                err = self.last_device_loss or ReproError(
                    "mesh has no live replicas")
                orphans, self._orphans = self._orphans, []
                for req in orphans:
                    req.state = RequestState.FAILED
                    req.error = err
                    self._sched["failed"] += 1
                raise err
            if max_steps is not None and self._step_idx >= max_steps:
                return done
            out = self.step()
            done.extend(out)
            emitted = any(
                s is not None and s.request.out_tokens
                for rep in self.alive() for s in rep.engine._slots)
            stalled = 0 if (out or emitted) else stalled + 1
            if stalled > 4 * len(self.replicas) + 16:
                raise RuntimeError(
                    f"mesh made no progress for {stalled} steps "
                    f"({pending} pending, "
                    f"{len(self._orphans)} orphans)")

    # ======================================================================
    # observability
    # ======================================================================
    def _proc(self, rep: Replica) -> str:
        return f"replica{rep.index}:{rep.device.info.name}"

    def attach_trace(self, tr: Optional[ChromeTrace] = None
                     ) -> ChromeTrace:
        """Wire every replica's dispatch queue into one
        :class:`~repro_torch.runtime.trace.ChromeTrace` — one process row
        per replica, flow arrows for migrations, counter tracks for
        ``kv_pages_live`` and queue depth.  Export with
        ``tr.export("out.json")`` and load in chrome://tracing
        (docs/mesh.md §Reading a mesh trace)."""
        tr = tr or ChromeTrace(name="mesh")
        self._trace = tr
        for rep in self.replicas:
            tr.attach_queue(rep.engine._queue,
                            process=self._proc(rep), thread="dispatch")
        return tr

    def detach_trace(self) -> None:
        if self._trace is not None:
            self._trace.detach_all()
            self._trace = None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        states = ",".join(f"{r.key}={r.state}" for r in self.replicas)
        return f"<ServingMesh {states}>"
