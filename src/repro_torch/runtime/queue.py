"""Command queues over an explicit event dependency DAG (paper §2/§3).

The trimmed port of ``repro.runtime.queue``: the DAG of native (host
function) commands, which is what the serving engine builds its rounds
from.  Commands are enqueued with optional ``wait_for`` event lists and
return an :class:`~repro_torch.runtime.events.Event`.  In-order queues
add an implicit dependency on the previously enqueued command;
out-of-order queues execute any command whose dependencies are resolved.

Scheduling is **push-based**: ``flush()`` submits every flushed command
whose wait list is already resolved, and each event completion decrements
its dependents' outstanding-dependency counters, submitting newly-ready
commands from the completing thread — no polling loop.  A failing command
terminates its event with the error and every transitive dependent fails
with ``DependencyError`` without running.

The queue accepts the reference's ``fusion`` modes.  Fusion stitches
chains of kernel commands, and this queue takes native commands only
(which the reference never fuses either), so :meth:`dag_stats` keeps its
counters at zero.  Buffer and kernel enqueues, fusion and the trace sink
wait for the port's buffers (ROADMAP A.4).
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

from ..core.errors import InvalidArgError
from .events import (CommandError, DependencyError, Event, EventStatus,
                     UserEvent, wait_for_events)
from .platform import Device

#: the reference's queue fusion modes, accepted for the same arguments
FUSION_MODES = ("off", "flush", "eager")


class _Command:
    """One node of the DAG: a host thunk plus its event and wait list."""

    __slots__ = ("fn", "event", "deps", "remaining", "submitted",
                 "failed_dep")

    def __init__(self, fn: Callable[[], None], event: Event,
                 deps: Sequence[Event]):
        self.fn = fn
        self.event = event
        self.deps: List[Event] = list(deps)
        self.remaining = 0            # unresolved deps (set when armed)
        self.submitted = False
        self.failed_dep: Optional[Event] = None


class CommandQueue:
    """cl_command_queue analogue: a DAG scheduler over one device.

    Parameters
    ----------
    device:
        The :class:`~repro_torch.runtime.platform.Device` the queue
        belongs to.
    out_of_order:
        ``False`` (default) chains every command after the previous one;
        ``True`` runs any command whose ``wait_for`` list is resolved,
        concurrently up to ``workers``.
    workers:
        Size of the worker pool.
    fusion:
        ``"off"``, ``"flush"`` (default) or ``"eager"``, validated as the
        reference validates it; native commands are never fused.
    """

    def __init__(self, device: Device, out_of_order: bool = False,
                 workers: int = 2, fusion: str = "flush"):
        if fusion not in FUSION_MODES:
            raise InvalidArgError(
                f"fusion mode {fusion!r} not in {FUSION_MODES}")
        self.device = device
        self.out_of_order = out_of_order
        self.fusion = fusion
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._lock = threading.Lock()
        self._pending: List[_Command] = []     # enqueued, not yet flushed
        self._armed: set = set()               # flushed, deps unresolved
        self._issued: List[Event] = []         # all live events (for finish)
        self._last_event: Optional[Event] = None
        self._ooo_barrier: Optional[Event] = None
        self._compiles0 = device.compile_cache.stats.compiles

    # -- introspection -----------------------------------------------------------
    @property
    def stats(self) -> Dict[str, int]:
        """Kernel launches through this queue (none: it takes native
        commands only) and pipeline compiles on its device's cache since
        queue creation."""
        return {"launches": 0,
                "enqueue_compiles":
                    self.device.compile_cache.stats.compiles
                    - self._compiles0}

    def events(self) -> List[Event]:
        """Snapshot of live (not yet pruned) events, in enqueue order."""
        with self._lock:
            return list(self._issued)

    def dag_stats(self) -> Dict[str, object]:
        """The reference's DAG-fusion counters; zero here, since native
        commands are not fused."""
        return {"mode": self.fusion, "fused_chains": 0,
                "commands_eliminated": 0, "bytes_elided": 0}

    # -- enqueue APIs -------------------------------------------------------------
    def _enqueue(self, name: str, fn: Callable[[], None],
                 wait_for: Optional[Sequence[Event]],
                 kind: str = "command") -> Event:
        """Core enqueue: record a command node and return its event.

        The full ``wait_for`` list is always preserved on the command (an
        in-order queue *adds* the previous command, it never replaces the
        explicit list)."""
        ev = Event(name, queue=self, kind=kind)
        deps = list(wait_for or [])
        with self._lock:
            if not self.out_of_order and self._last_event is not None:
                deps.append(self._last_event)
            if self.out_of_order and self._ooo_barrier is not None:
                if self._ooo_barrier.succeeded:
                    # a completed barrier gates nothing anymore; clearing
                    # it keeps long-lived queues at zero steady-state cost
                    # (a FAILED barrier stays: dependents must still fail)
                    self._ooo_barrier = None
                else:
                    deps.append(self._ooo_barrier)
            cmd = _Command(fn, ev, deps)
            self._pending.append(cmd)
            self._last_event = ev
            self._issued.append(ev)
        return ev

    def enqueue_native(self, fn: Callable[[], None],
                       wait_for: Optional[Sequence[Event]] = None,
                       name: str = "native", kind: str = "native") -> Event:
        """clEnqueueNativeKernel analogue: run a host function as a DAG
        node.  The serving engine builds its rounds out of these."""
        return self._enqueue(name, fn, wait_for, kind=kind)

    def enqueue_marker(self, wait_for: Optional[Sequence[Event]] = None
                       ) -> Event:
        """clEnqueueMarkerWithWaitList: an empty command that completes
        when ``wait_for`` does — or, with no list, when everything
        enqueued so far has completed.  Markers do not block later
        commands; use them to hand one queue's progress to another."""
        if wait_for is None:
            with self._lock:
                wait_for = list(self._issued)
        return self._enqueue("marker", lambda: None, wait_for,
                             kind="marker")

    def enqueue_barrier(self, wait_for: Optional[Sequence[Event]] = None
                        ) -> Event:
        """clEnqueueBarrierWithWaitList: like a marker, but on an
        out-of-order queue every *subsequently enqueued* command also
        waits for it."""
        ev = self.enqueue_marker(wait_for)
        ev.name = "queue-barrier"
        if self.out_of_order:
            with self._lock:
                self._ooo_barrier = ev
        return ev

    # -- DAG execution ------------------------------------------------------------
    def flush(self) -> None:
        """clFlush: submit the DAG built so far and return immediately.

        Every command enqueued before this call is *armed*: commands with
        resolved wait lists go to the worker pool now, the rest are
        submitted automatically (from the completing thread) as their
        dependencies finish."""
        with self._lock:
            armed, self._pending = self._pending, []
            # successfully completed events need no further tracking;
            # pruning keeps _issued bounded on long-lived queues.  Failed
            # events stay until the next finish() reports them.
            self._issued = [e for e in self._issued if not e.succeeded]
            self._issued.extend(c.event for c in armed)
        for cmd in armed:
            self._arm(cmd)

    def _arm(self, cmd: _Command) -> None:
        """Register dependency callbacks; submit if already ready."""
        cmd.remaining = len(cmd.deps)
        if cmd.remaining == 0:
            with self._lock:
                cmd.submitted = True
            self._submit(cmd)
            return
        with self._lock:
            # tracked so cancel_pending can abandon a command whose
            # dependencies will never resolve (e.g. a lost device)
            self._armed.add(cmd)
        for dep in cmd.deps:
            # fires immediately if the dep is already terminal
            dep.add_callback(lambda ev, c=cmd: self._dep_resolved(c, ev))

    def _dep_resolved(self, cmd: _Command, dep: Event) -> None:
        with self._lock:
            if dep.failed and cmd.failed_dep is None:
                cmd.failed_dep = dep
            cmd.remaining -= 1
            ready = cmd.remaining == 0 and not cmd.submitted
            if ready:
                cmd.submitted = True
                self._armed.discard(cmd)
        if ready:
            self._submit(cmd)

    def _submit(self, cmd: _Command) -> None:
        if cmd.event.done:
            return                # cancelled while waiting on deps
        cmd.event._transition(EventStatus.SUBMITTED)
        self._pool.submit(self._run_command, cmd)

    def _run_command(self, cmd: _Command) -> None:
        if cmd.event.done:
            return                # cancelled between submit and run
        if cmd.failed_dep is not None:
            cmd.event.fail(DependencyError(
                f"command {cmd.event.name!r} abandoned: dependency "
                f"{cmd.failed_dep.name!r} failed"))
            return
        cmd.event._transition(EventStatus.RUNNING)
        try:
            cmd.fn()
        except BaseException as e:  # noqa: BLE001 - must reach waiters
            cmd.event.fail(e)
        else:
            cmd.event.complete()

    def cancel_pending(self, error: Optional[BaseException] = None
                       ) -> List[Event]:
        """Abandon every command that cannot have started running: the
        still-unflushed enqueue window plus armed commands whose wait
        lists are unresolved.  Their events fail with ``error`` (default
        a :class:`~repro_torch.runtime.events.DependencyError`) without the
        command functions ever executing.  This is the device-loss path.
        Returns the cancelled events; commands already submitted to a
        worker run (or fail) normally."""
        with self._lock:
            pending, self._pending = self._pending, []
            waiting = [c for c in self._armed
                       if not c.submitted and not c.event.done]
            for c in waiting:
                c.submitted = True     # dep callbacks must not submit
            self._armed.difference_update(waiting)
        victims = pending + waiting
        for c in victims:
            c.event.fail(error if error is not None else DependencyError(
                f"command {c.event.name!r} cancelled before execution"))
        return [c.event for c in victims]

    def finish(self, timeout: Optional[float] = None) -> None:
        """clFinish: flush and wait for completion of *every* issued
        command.

        Raises :class:`CommandError` if any command failed, or
        ``RuntimeError`` if ``timeout`` (seconds) expires."""
        self.flush()
        with self._lock:
            issued = list(self._issued)
        try:
            if not wait_for_events(issued, timeout):
                stuck = [e.name for e in issued if not e.done]
                raise RuntimeError(
                    f"CommandQueue.finish timed out after {timeout}s; "
                    f"incomplete commands: {stuck[:8]}")
        finally:
            with self._lock:
                self._issued = [e for e in self._issued if not e.done]

    def __del__(self):  # pragma: no cover - interpreter shutdown ordering
        try:
            self._pool.shutdown(wait=False)
        except Exception:
            pass


__all__ = ["CommandQueue", "CommandError", "DependencyError", "Event",
           "EventStatus", "UserEvent", "wait_for_events", "FUSION_MODES"]
