"""First-class events: the cl_event analogue (paper §3, docs/runtime.md).

Every enqueue operation returns an :class:`Event` that moves through the
OpenCL execution-status ladder

    QUEUED -> SUBMITTED -> RUNNING -> COMPLETE        (CL_QUEUED..CL_COMPLETE)

recording a monotonic nanosecond timestamp at each transition — the
``CL_PROFILING_COMMAND_{QUEUED,SUBMIT,START,END}`` counters of
``clGetEventProfilingInfo``.  A command that raises is *terminated with an
error* (OpenCL's negative execution status); waiters observe the exception
and dependent commands fail with :class:`DependencyError` instead of
running — error propagation along the event DAG.

Events are the edges of the runtime's dependency DAG: the command queue
(:mod:`repro.runtime.queue`) resolves ``wait_for`` lists through
:meth:`Event.add_callback`, which fires exactly once when the event reaches
a terminal state (immediately, if it already has).  Because an event exists
before anything can wait on it, the graph is acyclic by construction.

:class:`UserEvent` is the ``clCreateUserEvent`` analogue: host code gates
enqueued commands on an event it completes explicitly.
"""

from __future__ import annotations

import enum
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional

from ..core.errors import ReproError, register_error

_event_ids = itertools.count()


class EventStatus(enum.IntEnum):
    """OpenCL command execution status (numeric values mirror CL_*)."""

    QUEUED = 3      # command is in a queue, not yet submitted for execution
    SUBMITTED = 2   # dependencies resolved; handed to a device worker
    RUNNING = 1     # command function is executing
    COMPLETE = 0    # finished successfully

    # errors are represented separately (Event.error); Event.status returns
    # a negative int for terminated commands, matching OpenCL's convention


#: status of a command terminated by an error (OpenCL: any negative value)
ERROR_STATUS = -1


@register_error
class CommandError(ReproError, RuntimeError):
    """A command's function raised; the original exception is ``__cause__``.
    Part of the typed :class:`~repro.core.errors.ReproError` hierarchy;
    a failed event's ``status`` surfaces the error's ``code`` (OpenCL's
    negative-status convention)."""

    code = -9998
    code_name = "REPRO_COMMAND_FAILED"


@register_error
class DependencyError(CommandError):
    """A command was abandoned because one of its wait-list events failed
    (CL_EXEC_STATUS_ERROR_FOR_EVENTS_IN_WAIT_LIST)."""

    code = -14
    code_name = "CL_EXEC_STATUS_ERROR_FOR_EVENTS_IN_WAIT_LIST"


class Event:
    """A future for one enqueued command, with status + profiling info.

    Attributes
    ----------
    queued_ns, submit_ns, start_ns, end_ns:
        ``time.monotonic_ns()`` captured at each status transition (the
        clGetEventProfilingInfo counters).  ``None`` until the transition
        happens; monotonically non-decreasing in transition order.
    error:
        The exception that terminated the command, or ``None``.
    kind:
        The command class this event belongs to — the
        ``CL_EVENT_COMMAND_TYPE`` analogue: ``"kernel"`` (NDRange
        launches), ``"transfer"`` (buffer reads/writes/migrations),
        ``"map"`` (map/unmap), ``"marker"``, ``"native"``, ``"user"``,
        or the generic ``"command"``.  The scheduler and the memory
        benchmark use it to attribute profile windows to migration vs
        compute (docs/memory.md §Migration).
    fused_from:
        Provenance for the DAG fusion rewrite (docs/runtime.md §Kernel
        fusion): the original per-kernel events a fused super-command
        replaced, in chain order.  Empty for ordinary commands.  The
        originals remain live DAG nodes (dependents wait on them; they
        complete when the fused command does), and ``finish(timeout)``
        expands this list when naming a stuck command.
    """

    def __init__(self, name: str, queue: Optional[object] = None,
                 kind: str = "command"):
        self.id = next(_event_ids)
        self.name = name
        self.queue = queue
        self.kind = kind
        self.fused_from: List["Event"] = []
        self.error: Optional[BaseException] = None
        self.queued_ns: Optional[int] = time.monotonic_ns()
        self.submit_ns: Optional[int] = None
        self.start_ns: Optional[int] = None
        self.end_ns: Optional[int] = None
        self._status: EventStatus = EventStatus.QUEUED
        self._terminal = threading.Event()
        self._lock = threading.Lock()
        self._callbacks: List[Callable[["Event"], None]] = []

    # -- status ---------------------------------------------------------------
    @property
    def status(self) -> int:
        """Current execution status; negative once terminated by an
        error — the typed :class:`~repro.core.errors.ReproError` code
        when the failure carries one (e.g. -14 for a DependencyError),
        else the generic :data:`ERROR_STATUS`."""
        if self.error is not None:
            code = getattr(self.error, "code", ERROR_STATUS)
            return int(code) if int(code) < 0 else ERROR_STATUS
        return int(self._status)

    @property
    def done(self) -> bool:
        """True once the event reached a terminal state (success or error)."""
        return self._terminal.is_set()

    @property
    def succeeded(self) -> bool:
        return self.done and self.error is None

    @property
    def failed(self) -> bool:
        return self.done and self.error is not None

    # -- transitions (called by the owning queue) ------------------------------
    def _transition(self, status: EventStatus) -> None:
        """Advance the status ladder, stamping the profiling counter."""
        now = time.monotonic_ns()
        fire = False
        with self._lock:
            assert int(status) < int(self._status), \
                f"event {self.name}: illegal transition " \
                f"{self._status.name} -> {status.name}"
            self._status = status
            if status is EventStatus.SUBMITTED:
                self.submit_ns = now
            elif status is EventStatus.RUNNING:
                self.start_ns = now
            elif status is EventStatus.COMPLETE:
                self.end_ns = now
                fire = True
        if fire:
            self._finish()

    def complete(self) -> None:
        """Mark the command complete (terminal, successful).

        Called by the queue when the command function returns; user code
        only calls this on :class:`UserEvent`.
        """
        now = time.monotonic_ns()
        with self._lock:
            if self._terminal.is_set():
                return
            self._status = EventStatus.COMPLETE
            if self.submit_ns is None:
                self.submit_ns = now
            if self.start_ns is None:
                self.start_ns = now
            self.end_ns = now
        self._finish()

    def fail(self, error: BaseException) -> None:
        """Terminate the command with an error (negative OpenCL status)."""
        now = time.monotonic_ns()
        with self._lock:
            if self._terminal.is_set():
                return
            self.error = error
            if self.submit_ns is None:
                self.submit_ns = now
            if self.start_ns is None:
                self.start_ns = now
            self.end_ns = now
        self._finish()

    def _finish(self) -> None:
        with self._lock:
            cbs, self._callbacks = self._callbacks, []
            self._terminal.set()
        for cb in cbs:
            cb(self)

    # -- waiting / chaining ----------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until terminal (clWaitForEvents for one event).

        Returns False on timeout.  Raises :class:`CommandError` (with the
        original exception as ``__cause__``) if the command failed.
        """
        if not self._terminal.wait(timeout):
            return False
        if self.error is not None:
            if isinstance(self.error, CommandError):
                raise self.error
            raise CommandError(
                f"command {self.name!r} failed: {self.error}") \
                from self.error
        return True

    def add_callback(self, fn: Callable[["Event"], None]) -> None:
        """Invoke ``fn(self)`` exactly once when the event is terminal.

        Fires immediately (in the calling thread) if the event is already
        terminal; otherwise fires in the thread that completes the event —
        the clSetEventCallback contract the DAG scheduler builds on.
        """
        with self._lock:
            if not self._terminal.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    # -- profiling -------------------------------------------------------------
    @property
    def profile(self) -> Dict[str, Optional[int]]:
        """The four profiling counters, in nanoseconds (monotonic clock)."""
        return {"queued_ns": self.queued_ns, "submit_ns": self.submit_ns,
                "start_ns": self.start_ns, "end_ns": self.end_ns}

    @property
    def duration_us(self) -> Optional[float]:
        """RUNNING->terminal wall time in microseconds (None if not done)."""
        if self.end_ns is None or self.start_ns is None:
            return None
        return (self.end_ns - self.start_ns) / 1e3

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        st = "ERROR" if self.failed else self._status.name
        return f"<Event #{self.id} {self.name!r} {st}>"


class UserEvent(Event):
    """clCreateUserEvent analogue: a host-controlled gate in the DAG.

    Created in the SUBMITTED state (as in OpenCL); commands whose wait
    lists include it stay queued until the host calls :meth:`complete`
    (or :meth:`fail`, which propagates to dependents).
    """

    def __init__(self, name: str = "user"):
        super().__init__(name, queue=None, kind="user")
        self._status = EventStatus.SUBMITTED
        self.submit_ns = time.monotonic_ns()


def chunk_counters(events, kind: Optional[str] = None
                   ) -> List[Dict[str, object]]:
    """Per-event profiling rows for a set of chunk events.

    Returns one dict per *terminal* event (optionally filtered by
    ``kind``): ``name``, ``kind``, ``ok``, the four
    ``clGetEventProfilingInfo`` counters, plus two derived fields —
    ``duration_s`` (RUNNING -> terminal) and ``queue_s``
    (QUEUED -> RUNNING, the scheduling delay).  Events still in flight
    are skipped, so the rows are safe to take mid-launch.

    This is the extraction layer between raw event profiles and
    consumers that reason about chunk timing: the co-execution
    throughput model (:class:`~repro.runtime.scheduler.ThroughputModel`)
    feeds on ``duration_s`` of completed ``"kernel"`` chunks, and the
    stats tests cross-check :class:`~repro.runtime.scheduler.CoExecStats`
    against these rows."""
    rows: List[Dict[str, object]] = []
    for ev in events:
        if kind is not None and ev.kind != kind:
            continue
        if not ev.done:
            continue
        duration_s = None
        if ev.start_ns is not None and ev.end_ns is not None:
            duration_s = (ev.end_ns - ev.start_ns) / 1e9
        queue_s = None
        if ev.queued_ns is not None and ev.start_ns is not None:
            queue_s = (ev.start_ns - ev.queued_ns) / 1e9
        row: Dict[str, object] = {"name": ev.name, "kind": ev.kind,
                                  "ok": ev.succeeded}
        row.update(ev.profile)
        row["duration_s"] = duration_s
        row["queue_s"] = queue_s
        rows.append(row)
    return rows


def wait_for_events(events, timeout: Optional[float] = None) -> bool:
    """clWaitForEvents: block until every event is terminal.

    Returns False if the timeout expires first; raises if any event
    failed (after all waits resolve or time out).
    """
    deadline = None if timeout is None else time.monotonic() + timeout
    for ev in events:
        budget = None if deadline is None \
            else max(0.0, deadline - time.monotonic())
        if not ev._terminal.wait(budget):
            return False
    for ev in events:
        ev.wait(0)  # raises on failure
    return True
