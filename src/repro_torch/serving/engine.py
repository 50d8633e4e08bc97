"""Continuous-batching serving engine (docs/serving.md).

The engine schedules at *request* granularity over a fixed set of decode
slots — the EngineCL-style host scheduler the ROADMAP calls for, built on
the runtime pieces underneath it (event DAG, size-class ``BufferPool``,
host ``Context``):

* **Admission queue**: ``submit(request)`` enqueues; ``step()`` runs one
  scheduler step; ``drain()`` steps until idle.  ``generate(requests)``
  is the compatible one-shot wrapper (submit all + drain).
* **Continuous batching**: a request that hits EOS / ``max_tokens`` is
  evicted mid-decode and its slot is refilled from the waiting queue *on
  the same step* — a long generation no longer stalls its batch
  neighbours the way the old fixed-group engine did.
* **Paged KV**: each request's cache footprint is accounted as
  fixed-size pages (``page_tokens`` tokens each) allocated from the
  context's size-class :class:`~repro.runtime.memory.BufferPool`, grown
  lazily as the request decodes and freed page-by-page on eviction —
  replacing the old per-group monolithic block.
* **Preemption**: when page growth hits the KV budget (or the arena),
  the lowest-priority running request (latest arrival breaks ties)
  releases its pages and re-enters the waiting queue at the front —
  recompute-style preemption, no request dropped; the typed
  :class:`~repro.runtime.bufalloc.OutOfMemory` is surfaced via
  ``last_oom`` / ``kv_stats``.  A request that cannot fit even alone
  fails with the typed error instead of livelocking.
* **DAG dispatch** (docs/runtime.md): each step's prefill commands and
  the decode command are independent nodes on an out-of-order
  :class:`~repro.runtime.queue.CommandQueue`, so refill prefills overlap
  the decode step on the worker pool.  A failing command surfaces its
  *original typed* exception on the affected request's ``error`` while
  sibling requests keep running (see :meth:`inject_fault`).

Determinism: decode computes every slot row independently (per-row KV
positions, per-row length masking — ``repro.models.layers``), so each
request's token stream is bitwise-identical to serial one-request-at-a-
time execution regardless of slot assignment, co-tenants, preemption, or
arrival interleaving.  ``tests/test_serving_props.py`` state-machines
that invariant against a single-slot oracle.

``scheduler="fixed"`` keeps the paging and DAG machinery but only
refills when *every* slot is empty — the old synchronized-group
behaviour, kept as the benchmark baseline (``benchmarks/bench_serving.py``)
and as the regression reference for the short-tail bugfix (tails are
masked empty slots now, never duplicated requests).

Model work goes through a :class:`~repro.serving.executor.BatchExecutor`
(:class:`~repro_torch.serving.executor.TorchExecutor` by default, the
port of the reference's jitted ``JaxExecutor``);
the deterministic :class:`~repro.serving.executor.StubExecutor` drives
the property harness without tracing anything.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

from ..core.errors import InvalidArgError
from ..runtime.bufalloc import OutOfMemory
from ..runtime.events import CommandError
from ..runtime.memory import BufferPool
from ..runtime.queue import CommandQueue

from .executor import BatchExecutor


class RequestState:
    """Lifecycle states of a request (docs/serving.md §Request lifecycle):
    WAITING -> RUNNING -> FINISHED, with RUNNING -> WAITING on preemption
    and -> FAILED on a typed error."""

    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    FAILED = "failed"


@dataclasses.dataclass
class Request:
    """One generation request: a prompt and a token budget.

    ``out_tokens`` accumulates generated tokens; ``done`` is set on
    successful completion, ``error`` carries the typed
    :class:`~repro.core.errors.ReproError` on failure.  ``priority``
    orders preemption victims (lower preempts first); ``eos_token``
    stops generation early.  ``id``/``submit_step``/``finish_step``/
    ``preemptions`` are scheduler bookkeeping filled in by the engine.
    """

    prompt: np.ndarray                   # (S,) int32
    max_new_tokens: int = 16
    priority: int = 0
    eos_token: Optional[int] = None
    out_tokens: Optional[List[int]] = None
    done: bool = False
    error: Optional[BaseException] = None
    state: str = RequestState.WAITING
    id: int = -1
    submit_step: int = -1
    finish_step: int = -1
    preemptions: int = 0


class _Slot:
    """One decode slot: the resident request plus its KV pages."""

    __slots__ = ("request", "pages", "cap_tokens", "last_tok", "inserted")

    def __init__(self, request: Request):
        self.request = request
        self.pages: List[Any] = []      # BufferPool chunks
        self.cap_tokens = 0             # tokens the pages cover
        self.last_tok = 0               # input token for the next decode
        self.inserted = False           # prefill fragment spliced in?


class ServingEngine:
    """Continuous-batching request scheduler over ``batch_slots`` decode
    slots (module docstring has the full picture).

    Parameters
    ----------
    cfg, params:
        Model config / parameters for the default
        :class:`~repro_torch.serving.executor.TorchExecutor`; pass
        ``None`` for both when supplying ``executor``.
    batch_slots:
        Decode batch width (concurrently-running requests).
    max_seq:
        KV-cache capacity per slot; a request is force-finished when
        ``len(prompt) + generated`` reaches it.
    dag_workers:
        Worker threads of the dispatch queue; >=2 lets refill prefills
        overlap the decode command.
    device / context:
        Runtime placement, exactly as before: the dispatch queue and the
        KV page pool come from the host
        :class:`~repro.runtime.context.Context` (engines sharing a
        context share KV free lists); a foreign device falls back to
        engine-owned resources.
    scheduler:
        ``"continuous"`` (default) or ``"fixed"`` — the refill-barrier
        baseline (slots refill only when all are empty).
    page_tokens:
        Tokens per KV page (paging granularity).
    kv_budget_bytes:
        Optional engine-level cap on summed page bytes; growth past it
        triggers preemption.  ``None`` leaves only the arena as the
        limit.
    executor:
        A :class:`~repro.serving.executor.BatchExecutor` override (the
        property harness passes a
        :class:`~repro.serving.executor.StubExecutor`).
    rules / mesh:
        Sharding rules for the default executor's model (the reference
        takes ``rules`` third; here a keyword), and a one-device
        :class:`DeviceMesh` to place its parameters and caches on
        (:class:`~repro_torch.serving.executor.TorchExecutor`).
    """

    def __init__(self, cfg, params,
                 batch_slots: int = 4, max_seq: int = 256,
                 aux_inputs: Optional[Dict] = None,
                 dag_workers: int = 2, device=None, context=None,
                 scheduler: str = "continuous", page_tokens: int = 16,
                 kv_budget_bytes: Optional[int] = None,
                 executor: Optional[BatchExecutor] = None,
                 prefill_bucket: int = 8, fusion: str = "flush",
                 rules=None, mesh=None):
        if scheduler not in ("continuous", "fixed"):
            raise InvalidArgError(
                f"scheduler must be 'continuous' or 'fixed', "
                f"got {scheduler!r}")
        self.cfg, self.params, self.rules = cfg, params, rules
        self.B, self.S = batch_slots, max_seq
        self.aux = aux_inputs or {}
        self.scheduler = scheduler

        if executor is None:
            from .executor import TorchExecutor
            executor = TorchExecutor(cfg, params, batch_slots,
                                     max_seq, aux_inputs=aux_inputs,
                                     prefill_bucket=prefill_bucket,
                                     rules=rules, mesh=mesh)
        if executor.batch_slots != batch_slots or \
                executor.max_seq != max_seq:
            raise InvalidArgError(
                f"executor shape ({executor.batch_slots}, "
                f"{executor.max_seq}) does not match engine "
                f"({batch_slots}, {max_seq})")
        self._exec = executor

        # runtime resources from the host Context (docs/host_api.md);
        # a caller-supplied device outside the context's platform falls
        # back to engine-owned queue + pool, as before
        if context is None:
            from ..runtime.context import default_context
            context = default_context()
        self.context = context
        if device is None:
            device = context.devices[0]
        try:
            self._queue = context.create_queue(
                device, out_of_order=True, workers=max(1, dag_workers),
                fusion=fusion)
            self._kv_pool = context.pool_for(device, min_class=4096)
        except InvalidArgError:
            self._queue = CommandQueue(device, out_of_order=True,
                                       workers=max(1, dag_workers),
                                       fusion=fusion)
            self._kv_pool = BufferPool(device.allocator, min_class=4096)

        # paged KV accounting: page_bytes covers page_tokens tokens of
        # one slot's cache row (docs/serving.md §KV paging)
        self._kv_bytes = executor.cache_bytes(self.B, self.S)
        per_slot = executor.cache_bytes(1, self.S)
        self._bytes_per_token = max(1, -(-per_slot // self.S))
        self.page_tokens = max(1, int(page_tokens))
        self._page_bytes = self._bytes_per_token * self.page_tokens
        self._kv_budget = kv_budget_bytes
        self._kv_used = 0
        self._kv_alloc_failures = 0
        self.last_oom: Optional[OutOfMemory] = None

        # scheduler state
        self._waiting: deque = deque()
        self._slots: List[Optional[_Slot]] = [None] * self.B
        self._state: Any = None          # executor batch state (lazy)
        self._req_ids = itertools.count()
        self._step_idx = 0
        self._faults: Dict[int, Dict[str, Any]] = {}
        # replica-level device loss (docs/serving.md §Failure handling):
        # _device_fault is the armed error (fires through the next DAG
        # round), device_lost the terminal state once it has fired
        self._device_fault: Optional[BaseException] = None
        self.device_lost: Optional[BaseException] = None
        self._sched = {"submitted": 0, "completed": 0, "failed": 0,
                       "preemptions": 0, "evictions": 0, "steps": 0,
                       "pages_allocated": 0, "pages_freed": 0}
        self._dag_accum = {"steps": 0, "events": 0, "prefill_events": 0,
                           "decode_events": 0, "wall_s": 0.0,
                           "busy_s": 0.0}

    # ======================================================================
    # introspection
    # ======================================================================
    @property
    def current_step(self) -> int:
        return self._step_idx

    @property
    def kv_stats(self) -> Dict[str, int]:
        """KV page-pool counters: steady-state serving pops pages from
        the size-class free list (hits) and eviction returns them
        page-by-page (frees — per request, not per group)."""
        out = dict(self._kv_pool.stats())
        out["kv_bytes_per_group"] = self._kv_bytes   # full-batch footprint
        out["bytes_per_token"] = self._bytes_per_token
        out["page_bytes"] = self._page_bytes
        out["page_tokens"] = self.page_tokens
        out["kv_used_bytes"] = self._kv_used
        out["pages_live"] = self._kv_used // self._page_bytes
        out["alloc_failures"] = self._kv_alloc_failures
        return out

    @property
    def compile_stats(self) -> Dict[str, int]:
        """Call and (re)compile counters proving steady-state serving does
        zero tracing work (docs/caching.md §Steady-state serving)."""
        out = {"prefill_calls": 0, "decode_steps": 0,
               "prefill_compiles": 0, "decode_compiles": 0}
        out.update(self._exec.compile_stats())
        return out

    @property
    def scheduler_stats(self) -> Dict[str, int]:
        """Scheduler counters: admissions, evictions, preemptions, and
        the current queue/slot occupancy."""
        out = dict(self._sched)
        out["waiting"] = len(self._waiting)
        out["running"] = sum(1 for s in self._slots if s is not None)
        return out

    @property
    def dag_stats(self) -> Dict[str, Any]:
        """What the dispatch DAG did since the last :meth:`generate` (or
        engine creation): event counts, wall time, summed busy time, and
        the overlap factor busy/wall (>1 means prefill overlapped
        decode).  ``fusion`` nests the dispatch queue's DAG-fusion
        counters (docs/runtime.md §Kernel fusion) — decode-step kernel
        chains enqueued through the queue fuse like any other."""
        out = dict(self._dag_accum)
        out["overlap"] = (out["busy_s"] / out["wall_s"]) \
            if out["wall_s"] > 0 else 1.0
        out["fusion"] = self._queue.dag_stats()
        return out

    # ======================================================================
    # submission
    # ======================================================================
    def submit(self, request: Request, front: bool = False) -> int:
        """Admit a request to the waiting queue; returns its id.

        Validates the prompt against slot capacity — a prompt that can
        never fit (``len(prompt) >= max_seq``) is rejected with a typed
        :class:`~repro.core.errors.InvalidArgError` instead of wedging
        the queue.  ``front=True`` admits at the *front* of the queue
        (the serving mesh requeues requests migrated off a lost replica
        this way, so they restart before later arrivals).  An engine
        whose device was lost re-raises the typed ``device_lost`` error
        instead of accepting work it can never run."""
        if self.device_lost is not None:
            raise self.device_lost
        plen = int(len(request.prompt))
        if plen < 1:
            raise InvalidArgError("empty prompt")
        if plen >= self.S:
            raise InvalidArgError(
                f"prompt length {plen} >= max_seq {self.S}: no room to "
                f"generate")
        request.id = next(self._req_ids)
        request.state = RequestState.WAITING
        request.out_tokens = []
        request.done = False
        request.error = None
        request.submit_step = self._step_idx
        request.finish_step = -1
        self._sched["submitted"] += 1
        if front:
            self._waiting.appendleft(request)
        else:
            self._waiting.append(request)
        return request.id

    def inject_fault(self, request: Optional[Request] = None,
                     stage: str = "decode",
                     error: Optional[BaseException] = None) -> None:
        """Arm a device-side failure (test/chaos hook, ROADMAP item 3).

        Per-request stages (``request`` required): ``stage="prefill"``
        makes the request's prefill command raise; ``stage="decode"``
        enqueues a failing DAG command attributed to the request on its
        next decode step.  The typed error (default
        :class:`~repro.core.errors.DeviceLostError`) surfaces on the
        request's ``error`` while siblings complete.

        ``stage="device"`` (``request`` must be ``None``) arms a
        *replica-level* device loss: during the next scheduler step
        every command of the DAG round — staged prefills and the shared
        decode — raises the error, so every resident request fails at
        once with the same typed error object, pages drain to zero, the
        queue's unflushed commands are cancelled, and the engine goes
        terminal (``device_lost``).  Waiting requests are untouched —
        the serving mesh (:mod:`repro.serving.mesh`) reclaims them with
        :meth:`release_waiting` and requeues everything on a sibling."""
        if stage == "device":
            if request is not None:
                raise InvalidArgError(
                    "device-level loss takes the whole replica down; "
                    "pass request=None (per-request faults are the "
                    "prefill/decode stages)")
            if error is None:
                from ..core.errors import DeviceLostError
                error = DeviceLostError("injected device loss")
            self._device_fault = error
            return
        if stage not in ("prefill", "decode"):
            raise InvalidArgError(f"unknown fault stage {stage!r}")
        if request is None:
            raise InvalidArgError(
                f"stage {stage!r} faults one request; pass it (device "
                f"loss is stage='device')")
        if request.id < 0:
            raise InvalidArgError("submit the request before injecting "
                                  "a fault")
        if error is None:
            from ..core.errors import DeviceLostError
            error = DeviceLostError(
                f"injected {stage} fault for request {request.id}")
        self._faults[request.id] = {"stage": stage, "error": error}

    def release_waiting(self) -> List[Request]:
        """Hand back (and clear) the admission queue — the serving mesh
        calls this after a device loss to migrate not-yet-started
        requests to a sibling replica.  Requests stay in WAITING state
        and carry no error; re-``submit`` re-initializes them."""
        out = list(self._waiting)
        self._waiting.clear()
        return out

    # ======================================================================
    # KV paging
    # ======================================================================
    def _grow(self, slot: _Slot, want_tokens: int) -> None:
        """Grow a slot's pages to cover ``want_tokens`` cache positions;
        raises the typed OutOfMemory on budget or arena exhaustion."""
        while slot.cap_tokens < want_tokens:
            if self._kv_budget is not None and \
                    self._kv_used + self._page_bytes > self._kv_budget:
                raise OutOfMemory(
                    f"KV budget exhausted: {self._kv_used} used + "
                    f"{self._page_bytes} page > {self._kv_budget} budget")
            chunk = self._kv_pool.alloc(self._page_bytes)
            slot.pages.append(chunk)
            slot.cap_tokens += self.page_tokens
            self._kv_used += self._page_bytes
            self._sched["pages_allocated"] += 1

    def _free_pages(self, slot: _Slot) -> None:
        """Return a slot's KV pages to the pool, page by page."""
        for chunk in slot.pages:
            self._kv_pool.free(chunk)
            self._kv_used -= self._page_bytes
            self._sched["pages_freed"] += 1
        slot.pages = []
        slot.cap_tokens = 0

    def _tokens_needed(self, req: Request) -> int:
        """Cache positions the request occupies after its next token."""
        return min(len(req.prompt) + len(req.out_tokens) + 1, self.S)

    def _preempt_one(self, requester: Request) -> Optional[int]:
        """Preempt the lowest-priority occupied slot whose priority does
        not exceed the requester's (latest arrival breaks ties); the
        victim's pages are freed and it re-enters the waiting queue at
        the front (recompute-style — deterministic decode regenerates
        the same tokens).  Returns the freed slot index, or None if every
        other resident outranks the requester."""
        candidates = [
            (s.request.priority, -s.request.id, i)
            for i, s in enumerate(self._slots)
            if s is not None and s.request.priority <= requester.priority]
        if not candidates:
            return None
        _, _, vi = min(candidates)
        slot = self._slots[vi]
        victim = slot.request
        self._free_pages(slot)
        self._slots[vi] = None
        victim.state = RequestState.WAITING
        victim.out_tokens = []
        victim.preemptions += 1
        self._waiting.appendleft(victim)
        self._sched["preemptions"] += 1
        return vi

    def _ensure_capacity(self, i: int) -> bool:
        """Pre-decode page growth for slot ``i``, preempting on OOM.
        Returns False when the slot lost its resident (self-preempted or
        failed)."""
        while True:
            slot = self._slots[i]
            if slot is None:
                return False
            try:
                self._grow(slot, self._tokens_needed(slot.request))
                return True
            except OutOfMemory as e:
                self.last_oom = e
                self._kv_alloc_failures += 1
                others = sum(1 for j, s in enumerate(self._slots)
                             if s is not None and j != i)
                if others == 0:
                    # sole resident: every live page is already its own,
                    # so no preemption can help — fail with the typed
                    # error rather than livelock
                    self._fail_slot(i, e)
                    return False
                vi = self._preempt_one(slot.request)
                if vi is None or vi == i:
                    # every other resident outranks this request (or it
                    # preempted itself): yield the slot and retry later
                    if vi is None:
                        self._preempt_self(i)
                    return False

    def _preempt_self(self, i: int) -> None:
        slot = self._slots[i]
        self._free_pages(slot)
        self._slots[i] = None
        r = slot.request
        r.state = RequestState.WAITING
        r.out_tokens = []
        r.preemptions += 1
        self._waiting.appendleft(r)
        self._sched["preemptions"] += 1

    # ======================================================================
    # request completion / failure
    # ======================================================================
    def _finish_request(self, req: Request) -> None:
        req.state = RequestState.FINISHED
        req.done = True
        req.finish_step = self._step_idx
        self._sched["completed"] += 1

    def _evict(self, i: int) -> Request:
        """Free slot ``i``'s pages and mark its request finished."""
        slot = self._slots[i]
        self._free_pages(slot)
        self._slots[i] = None
        self._sched["evictions"] += 1
        self._finish_request(slot.request)
        return slot.request

    def _fail_slot(self, i: int, error: BaseException) -> Request:
        slot = self._slots[i]
        self._free_pages(slot)
        self._slots[i] = None
        return self._fail_request(slot.request, error)

    def _fail_request(self, req: Request, error: BaseException) -> Request:
        req.state = RequestState.FAILED
        req.error = error
        req.finish_step = self._step_idx
        self._sched["failed"] += 1
        self._faults.pop(req.id, None)
        return req

    def _should_finish(self, slot: _Slot) -> bool:
        r = slot.request
        if len(r.out_tokens) >= r.max_new_tokens:
            return True
        if r.eos_token is not None and r.out_tokens and \
                r.out_tokens[-1] == r.eos_token:
            return True
        # cache full: force-finish (truncated) rather than overrun
        return len(r.prompt) + len(r.out_tokens) >= self.S

    # ======================================================================
    # admission
    # ======================================================================
    def _admit(self, i: int, req: Request) -> Optional[_Slot]:
        """Reserve slot ``i`` for ``req``: allocate pages for the prompt
        plus the prefill's first token.  Returns None (pages rolled
        back, request NOT requeued) when the allocation fails — the
        caller decides between deferral and failure."""
        slot = _Slot(req)
        try:
            self._grow(slot, min(len(req.prompt) + 1, self.S))
        except OutOfMemory as e:
            self.last_oom = e
            self._kv_alloc_failures += 1
            self._free_pages(slot)
            return None
        self._slots[i] = slot
        req.state = RequestState.RUNNING
        return slot

    def _refill_slots(self, finished: List[Request]) -> List[tuple]:
        """Pop waiting requests into free slots (continuous mode; fixed
        mode only when every slot is empty — the refill barrier).
        Zero-budget requests complete immediately without a slot.
        Returns ``(slot_idx, request)`` pairs needing prefill."""
        if self.scheduler == "fixed" and \
                any(s is not None for s in self._slots):
            return []
        staged = []
        for i in range(self.B):
            if self._slots[i] is not None:
                continue
            while self._waiting:
                req = self._waiting.popleft()
                if req.max_new_tokens <= 0:
                    self._finish_request(req)
                    finished.append(req)
                    continue
                if self._admit(i, req) is None:
                    if all(s is None for s in self._slots):
                        # nothing resident to wait on: the request can
                        # never fit — fail typed instead of wedging
                        finished.append(
                            self._fail_request(req, self.last_oom))
                        continue
                    self._waiting.appendleft(req)   # defer
                    return staged
                staged.append((i, req))
                break
            if not self._waiting and self._slots[i] is None:
                break
        return staged

    # ======================================================================
    # the DAG round
    # ======================================================================
    def _make_prefill_cmd(self, i: int, req: Request):
        holder: Dict[str, Any] = {}

        def cmd():
            if self._device_fault is not None:
                # replica-level loss: every command of the round fails
                # with the same typed error object (kill-during-prefill)
                raise self._device_fault
            fault = self._faults.get(req.id)
            if fault is not None and fault["stage"] == "prefill":
                self._faults.pop(req.id, None)
                raise fault["error"]
            frag, tok = self._exec.prefill(np.asarray(req.prompt,
                                                      np.int32), i)
            holder["frag"], holder["tok"] = frag, tok

        return holder, cmd

    def _install_prefill(self, i: int, req: Request,
                         holder: Dict[str, Any],
                         finished: List[Request]) -> None:
        """Splice a completed prefill into its slot and emit token 0."""
        if self._state is None:
            self._state = self._exec.init_state()
        self._state = self._exec.insert(self._state, holder["frag"], i)
        slot = self._slots[i]
        slot.inserted = True
        tok = int(holder["tok"])
        req.out_tokens.append(tok)
        slot.last_tok = tok
        if self._should_finish(slot):
            finished.append(self._evict(i))

    def _run_round(self, staged: List[tuple], events: List,
                   finished: List[Request]) -> None:
        """One DAG round: staged prefills + (optionally) one decode
        command for the already-resident slots, all independent nodes on
        the out-of-order queue, then failure surfacing and state
        updates."""
        q = self._queue
        prefills = []
        for i, req in staged:
            holder, cmd = self._make_prefill_cmd(i, req)
            ev = q.enqueue_native(cmd, name=f"prefill:r{req.id}")
            prefills.append((i, req, holder, ev))
            events.append(ev)
            self._dag_accum["prefill_events"] += 1

        staged_idx = {i for i, _ in staged}
        decode_rows = [i for i in range(self.B)
                       if self._slots[i] is not None
                       and self._slots[i].inserted
                       and i not in staged_idx]
        decode_ev = None
        decode_holder: Dict[str, Any] = {}
        if decode_rows:
            toks = np.zeros(self.B, np.int64)
            occ = np.zeros(self.B, bool)
            for i in decode_rows:
                toks[i] = self._slots[i].last_tok
                occ[i] = True

            def decode_cmd():
                if self._device_fault is not None:
                    # replica-level loss mid-decode: the shared decode
                    # command fails, taking every decoding row with it
                    raise self._device_fault
                st, out = self._exec.decode(self._state, toks, occ)
                self._state = st
                decode_holder["out"] = out

            decode_ev = q.enqueue_native(
                decode_cmd, name=f"decode:s{self._step_idx}")
            events.append(decode_ev)
            self._dag_accum["decode_events"] += 1

        # armed decode-stage faults: a separately-enqueued failing
        # command attributed to the request (a device-side failure
        # mid-group that must not take the siblings down)
        fault_evs = []
        for rid, fault in list(self._faults.items()):
            if fault["stage"] != "decode":
                continue
            owner = next((i for i in decode_rows
                          if self._slots[i] is not None
                          and self._slots[i].request.id == rid), None)
            if owner is None:
                continue
            self._faults.pop(rid, None)

            def fault_cmd(err=fault["error"]):
                raise err

            ev = q.enqueue_native(fault_cmd, name=f"fault:r{rid}")
            fault_evs.append((owner, ev))
            events.append(ev)

        try:
            q.finish()
        except CommandError:
            pass   # surfaced per-event below, onto the affected request

        # failure surfacing: each failed event maps to exactly the
        # request(s) it belongs to, carrying the original typed error
        for i, req, holder, ev in prefills:
            if ev.failed:
                finished.append(self._fail_slot(i, ev.error))
        for i, ev in fault_evs:
            if ev.failed and self._slots[i] is not None:
                finished.append(self._fail_slot(i, ev.error))
        if decode_ev is not None and decode_ev.failed:
            # the shared decode command failed: every decoding request
            # is affected (the staged prefills are independent nodes and
            # carry on)
            for i in decode_rows:
                if self._slots[i] is not None:
                    finished.append(self._fail_slot(i, decode_ev.error))
        elif decode_ev is not None:
            out = decode_holder["out"]
            for i in decode_rows:
                slot = self._slots[i]
                if slot is None:      # failed via an injected fault
                    continue
                tok = int(out[i])
                slot.request.out_tokens.append(tok)
                slot.last_tok = tok
                if self._should_finish(slot):
                    finished.append(self._evict(i))

        for i, req, holder, ev in prefills:
            if ev.failed or self._slots[i] is None:
                continue
            self._install_prefill(i, req, holder, finished)

    # ======================================================================
    # the scheduler step
    # ======================================================================
    def step(self) -> List[Request]:
        """One scheduler step; returns the requests that finished (or
        failed) during it.

        Phases: (1) pre-decode page growth for residents, preempting on
        OOM; (2) refill free slots from the waiting queue; (3) one DAG
        round — refill prefills overlap the decode command; (4) evict
        finished requests; (5) *same-step* refill of slots freed by
        eviction, so a newly-admitted request has its first token before
        the step returns."""
        if self.device_lost is not None:
            return []          # terminal: the mesh routes around us
        self._step_idx += 1
        self._sched["steps"] += 1
        t0 = time.perf_counter()
        events: List = []
        finished: List[Request] = []
        if self._state is None:
            self._state = self._exec.init_state()

        # 1. page growth (continuous + fixed both page)
        for i in range(self.B):
            if self._slots[i] is not None and self._slots[i].inserted:
                self._ensure_capacity(i)

        # 2+3. refill, then the overlapped DAG round
        staged = self._refill_slots(finished)
        self._run_round(staged, events, finished)

        # 5. same-step refill: evictions (and preemption-freed slots)
        # refill immediately — each refill is its own small DAG round
        # (prefill + insert), repeated until slots or queue run dry
        if self.scheduler == "continuous":
            guard = 0
            while self._waiting and self._device_fault is None and \
                    any(s is None for s in self._slots) and \
                    guard <= 2 * self.B + len(self._waiting):
                guard += 1
                staged = self._refill_slots(finished)
                if not staged:
                    break
                self._run_round(staged, events, finished)

        # an armed device loss fired through the round above: finalize.
        # Any still-resident slot (e.g. admitted but never commanded this
        # round) fails with the same typed error, the queue's unflushed
        # commands are cancelled so finish(timeout) never reports work
        # migrated to a sibling as "stuck", and the engine goes terminal.
        if self._device_fault is not None:
            err, self._device_fault = self._device_fault, None
            self.device_lost = err
            for i in range(self.B):
                if self._slots[i] is not None:
                    finished.append(self._fail_slot(i, err))
            self._queue.cancel_pending(err)

        wall = time.perf_counter() - t0
        busy = sum((e.end_ns - e.start_ns) for e in events
                   if e.start_ns and e.end_ns) / 1e9
        self._dag_accum["steps"] += 1
        self._dag_accum["events"] += len(events)
        self._dag_accum["wall_s"] += wall
        self._dag_accum["busy_s"] += busy
        return finished

    def drain(self, max_steps: Optional[int] = None) -> List[Request]:
        """Step until the queue and every slot are empty; returns the
        requests that finished (or failed), in completion order."""
        done: List[Request] = []
        stalled = 0
        while self._waiting or any(s is not None for s in self._slots):
            if self.device_lost is not None:
                # a lost device can never drain its queue: surface the
                # typed error instead of spinning (the mesh migrates the
                # waiting requests before this can trigger)
                raise self.device_lost
            if max_steps is not None and self._sched["steps"] >= max_steps:
                break
            out = self.step()
            done.extend(out)
            # progress = tokens emitted or requests retired; a scheduler
            # that does neither for several consecutive steps is wedged
            emitted = any(s is not None and s.request.out_tokens
                          for s in self._slots)
            if out or emitted:
                stalled = 0
            else:
                stalled += 1
                if stalled > 2 * self.B + 8:
                    raise RuntimeError(
                        "serving scheduler made no progress for "
                        f"{stalled} steps ({len(self._waiting)} waiting)")
        return done

    # ======================================================================
    # compatible one-shot entry point
    # ======================================================================
    def generate(self, requests: List[Request], greedy: bool = True
                 ) -> List[Request]:
        """Submit every request and drain the scheduler; returns the
        completed requests (the pre-scheduler signature, kept for
        callers that batch up-front)."""
        for k in self._dag_accum:
            self._dag_accum[k] = 0 if isinstance(self._dag_accum[k], int) \
                else 0.0
        for r in requests:
            self.submit(r)
        self.drain()
        return [r for r in requests if r.done]


__all__ = ["ServingEngine", "Request", "RequestState"]
