"""Chrome-trace export of the event DAG (docs/mesh.md §Observability).

Every :class:`~repro.runtime.events.Event` already carries the four
``clGetEventProfilingInfo`` counters (``queued_ns / submit_ns /
start_ns / end_ns``), a ``kind`` (the CL_EVENT_COMMAND_TYPE analogue)
and ``fused_from`` provenance.  This module turns a run's events into
the Chrome Trace Event Format (the ``chrome://tracing`` /
https://ui.perfetto.dev JSON), so a production operator can *see* queue
depth, prefill/decode overlap, fusion, and migration stalls per request
instead of reading counters:

* one **process** row per device (or serving replica), one **thread**
  row per command queue — ``ph:"X"`` complete slices spanning
  RUNNING→terminal, with the full profile counters in ``args``;
* **flow arrows** (``ph:"s"``/``ph:"f"``) for every DAG dependency edge
  between recorded events, and for cross-replica request *migrations*
  (emitted by the serving mesh);
* **counter tracks** (``ph:"C"``) for per-queue depth (derived from the
  recorded events — no sampling thread) plus any caller-fed series
  (the serving engines feed ``kv_pages_live``);
* ``ph:"M"`` metadata naming every process/thread row.

Collection is push-based and cheap: :meth:`ChromeTrace.attach_queue`
installs the collector as the queue's ``trace_sink``; the queue calls
:meth:`on_command` once per enqueued command (fused super-commands
included), and everything else — timestamps, status, provenance — is
read off the events at export time.  :func:`validate_trace` is the
schema gate (required fields per phase, monotone/non-negative
timestamps, flow-event pairing) shared by tests/test_trace.py, the
bench_mesh CI gate, and the docs-job check.

Entry points: ``Context.trace()`` wraps a host-API region
(docs/host_api.md), ``ServingMesh.attach_trace`` wires a whole replica
mesh, and ``launch/serve.py --trace out.json`` records a serving run.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .events import Event

__all__ = ["ChromeTrace", "validate_trace"]

_flow_ids = itertools.count(1)


class ChromeTrace:
    """Collects events (live, via queue ``trace_sink``) plus manual
    instants / flows / counters, and exports Chrome-trace JSON.

    Processes and threads are named, not numbered: every API takes a
    ``process`` (device / replica) and optional ``thread`` (queue) name
    and the collector assigns stable integer pid/tid values, emitting
    ``process_name`` / ``thread_name`` metadata at export."""

    def __init__(self, name: str = "repro"):
        self.name = name
        self._lock = threading.Lock()
        self._pids: Dict[str, int] = {}
        self._tids: Dict[Tuple[int, str], int] = {}
        # (event, dep events snapshot, pid, tid) per recorded command
        self._commands: List[Tuple[Event, Tuple[Event, ...], int, int]] = []
        self._track: Dict[int, Tuple[int, int]] = {}   # event id -> pid/tid
        self._rows: Dict[int, Tuple[int, int]] = {}    # id(queue) -> pid/tid
        self._extra: List[dict] = []                   # manual raw events
        self._queues: List[object] = []

    # -- naming ---------------------------------------------------------------
    def _pid(self, process: str) -> int:
        pid = self._pids.get(process)
        if pid is None:
            pid = len(self._pids) + 1
            self._pids[process] = pid
        return pid

    def _tid(self, pid: int, thread: str) -> int:
        tid = self._tids.get((pid, thread))
        if tid is None:
            tid = sum(1 for (p, _t) in self._tids if p == pid) + 1
            self._tids[(pid, thread)] = tid
        return tid

    # -- live collection ------------------------------------------------------
    def attach_queue(self, queue, process: Optional[str] = None,
                     thread: Optional[str] = None) -> None:
        """Install this collector as ``queue.trace_sink``.  One trace
        row per device queue: ``process`` defaults to the queue's device
        name, ``thread`` to ``queue<N>`` within that process."""
        with self._lock:
            pid = self._pid(process or queue.device.info.name)
            if thread is None:
                thread = f"queue{sum(1 for (p, _t) in self._tids if p == pid)}"
            self._rows[id(queue)] = (pid, self._tid(pid, thread))
            self._queues.append(queue)
        queue.trace_sink = self

    def detach_all(self) -> None:
        """Stop collecting from every attached queue (recorded events
        stay; export still works)."""
        with self._lock:
            queues, self._queues = self._queues, []
        for q in queues:
            if q.trace_sink is self:
                q.trace_sink = None

    def on_command(self, event: Event, deps: Sequence[Event],
                   queue) -> None:
        """Queue sink protocol: called once per enqueued command (and
        once per fused super-command) with its resolved wait list."""
        with self._lock:
            row = self._rows.get(id(queue))
            if row is None:        # queue never attached: own device row
                pid = self._pid(queue.device.info.name)
                row = (pid, self._tid(pid, "queue"))
                self._rows[id(queue)] = row
            pid, tid = row
            self._commands.append((event, tuple(deps), pid, tid))
            self._track[event.id] = (pid, tid)

    # -- manual events --------------------------------------------------------
    def instant(self, name: str, process: str,
                thread: Optional[str] = None,
                ts_ns: Optional[int] = None,
                args: Optional[dict] = None) -> Tuple[int, int, int]:
        """An ``ph:"i"`` instant marker; returns ``(pid, tid, ts_ns)``
        so callers can anchor flow arrows on it."""
        ts = time.monotonic_ns() if ts_ns is None else int(ts_ns)
        with self._lock:
            pid = self._pid(process)
            tid = self._tid(pid, thread or "events")
            self._extra.append({"ph": "i", "name": name, "s": "t",
                                "pid": pid, "tid": tid, "_ts_ns": ts,
                                "args": args or {}})
        return pid, tid, ts

    def flow(self, name: str, src: Tuple[int, int, int],
             dst: Tuple[int, int, int], cat: str = "migration") -> int:
        """A paired ``ph:"s"`` → ``ph:"f"`` flow arrow between two
        ``(pid, tid, ts_ns)`` anchors (e.g. two :meth:`instant`
        results).  Returns the flow id."""
        fid = next(_flow_ids)
        s_pid, s_tid, s_ts = src
        d_pid, d_tid, d_ts = dst
        with self._lock:
            self._extra.append({"ph": "s", "name": name, "cat": cat,
                                "id": fid, "pid": s_pid, "tid": s_tid,
                                "_ts_ns": int(s_ts)})
            self._extra.append({"ph": "f", "bp": "e", "name": name,
                                "cat": cat, "id": fid, "pid": d_pid,
                                "tid": d_tid,
                                "_ts_ns": max(int(d_ts), int(s_ts))})
        return fid

    def counter(self, name: str, value, process: str,
                ts_ns: Optional[int] = None) -> None:
        """One sample of a ``ph:"C"`` counter track (e.g. the serving
        engine's ``kv_pages_live``)."""
        ts = time.monotonic_ns() if ts_ns is None else int(ts_ns)
        with self._lock:
            pid = self._pid(process)
            self._extra.append({"ph": "C", "name": name, "pid": pid,
                                "tid": 0, "_ts_ns": ts,
                                "args": {"value": value}})

    # -- export ---------------------------------------------------------------
    def trace_events(self) -> List[dict]:
        """The ``traceEvents`` list: metadata + slices + DAG flows +
        derived queue-depth counters + manual events, sorted by ``ts``
        (microseconds relative to the earliest recorded timestamp)."""
        with self._lock:
            commands = list(self._commands)
            extra = [dict(e) for e in self._extra]
            pids = dict(self._pids)
            tids = dict(self._tids)
            track = dict(self._track)

        done = [(ev, deps, pid, tid) for ev, deps, pid, tid in commands
                if ev.done and ev.queued_ns is not None
                and ev.start_ns is not None and ev.end_ns is not None]
        stamps = [ev.queued_ns for ev, *_ in done]
        stamps += [e["_ts_ns"] for e in extra]
        t0 = min(stamps) if stamps else 0

        def us(ns: int) -> float:
            return max(0, ns - t0) / 1e3

        out: List[dict] = []
        for name, pid in sorted(pids.items(), key=lambda kv: kv[1]):
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "ts": 0,
                        "args": {"name": name}})
        for (pid, tname), tid in sorted(tids.items(),
                                        key=lambda kv: kv[1]):
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "ts": 0, "args": {"name": tname}})

        depth_marks: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        for ev, deps, pid, tid in done:
            args = {"kind": ev.kind, "ok": ev.succeeded,
                    "status": ev.status,
                    "queued_ns": ev.queued_ns, "submit_ns": ev.submit_ns,
                    "start_ns": ev.start_ns, "end_ns": ev.end_ns,
                    "queue_us": round((ev.start_ns - ev.queued_ns) / 1e3,
                                      3)}
            if ev.fused_from:
                args["fused_from"] = [o.name for o in ev.fused_from]
            if ev.error is not None:
                args["error"] = f"{type(ev.error).__name__}: {ev.error}"
            out.append({"ph": "X", "name": ev.name, "cat": ev.kind,
                        "pid": pid, "tid": tid, "ts": us(ev.start_ns),
                        "dur": max(0, ev.end_ns - ev.start_ns) / 1e3,
                        "args": args})
            marks = depth_marks.setdefault((pid, tid), [])
            marks.append((ev.queued_ns, 1))
            marks.append((ev.end_ns, -1))
            # DAG edges: dep end -> this command's start, on the tracks
            # that recorded both ends
            for dep in deps:
                src = track.get(dep.id)
                if src is None or not dep.done or dep.end_ns is None:
                    continue
                fid = next(_flow_ids)
                out.append({"ph": "s", "name": "dag", "cat": "dag",
                            "id": fid, "pid": src[0], "tid": src[1],
                            "ts": us(dep.end_ns)})
                out.append({"ph": "f", "bp": "e", "name": "dag",
                            "cat": "dag", "id": fid, "pid": pid,
                            "tid": tid,
                            "ts": us(max(ev.start_ns, dep.end_ns))})

        # queue depth: derived counter per (pid, tid), no sampling thread
        for (pid, tid), marks in sorted(depth_marks.items()):
            depth = 0
            for ts_ns, delta in sorted(marks):
                depth += delta
                out.append({"ph": "C", "name": f"queue_depth t{tid}",
                            "pid": pid, "tid": 0, "ts": us(ts_ns),
                            "args": {"value": depth}})

        for e in extra:
            e["ts"] = us(e.pop("_ts_ns"))
            out.append(e)

        out.sort(key=lambda e: (e["ts"], 0 if e["ph"] == "M" else 1))
        return out

    def export(self, path: str) -> dict:
        """Write the full Chrome-trace JSON object to ``path`` (load it
        in ``chrome://tracing`` or https://ui.perfetto.dev) and return
        it."""
        doc = {"traceEvents": self.trace_events(),
               "displayTimeUnit": "ms",
               "otherData": {"producer": f"repro:{self.name}"}}
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, default=float)
        return doc


# ---------------------------------------------------------------------------
# schema validation (the golden gate shared by tests / bench / docs job)
# ---------------------------------------------------------------------------

_REQUIRED = {"M": ("name", "pid", "tid", "args"),
             "X": ("name", "pid", "tid", "ts", "dur"),
             "C": ("name", "pid", "ts", "args"),
             "i": ("name", "pid", "tid", "ts"),
             "s": ("name", "id", "pid", "tid", "ts"),
             "f": ("name", "id", "pid", "tid", "ts")}


def validate_trace(events: List[dict]) -> Dict[str, int]:
    """Validate a ``traceEvents`` list against the Chrome Trace Event
    Format subset this exporter emits.  Checks, raising ``ValueError``
    with the offending event on the first violation:

    * every event has a known ``ph`` and that phase's required fields;
    * timestamps are non-negative and ``X`` durations non-negative;
    * every flow start (``ph:"s"``) pairs with exactly one flow finish
      (``ph:"f"``) of the same ``id``, and the finish is not earlier;
    * every ``pid``/``tid`` used by a slice is named by ``M`` metadata.

    Returns per-phase event counts (the golden-schema test snapshots a
    normalized skeleton on top of this)."""
    counts: Dict[str, int] = {}
    named_pids = set()
    named_tids = set()
    starts: Dict[object, dict] = {}
    finishes: Dict[object, dict] = {}
    for e in events:
        ph = e.get("ph")
        if ph not in _REQUIRED:
            raise ValueError(f"unknown ph in trace event: {e}")
        for field in _REQUIRED[ph]:
            if field not in e:
                raise ValueError(f"trace event missing {field!r}: {e}")
        counts[ph] = counts.get(ph, 0) + 1
        if ph != "M":
            if e["ts"] < 0:
                raise ValueError(f"negative ts: {e}")
        if ph == "X":
            if e["dur"] < 0:
                raise ValueError(f"negative dur: {e}")
        if ph == "M":
            if e["name"] == "process_name":
                named_pids.add(e["pid"])
            elif e["name"] == "thread_name":
                named_tids.add((e["pid"], e["tid"]))
        elif ph == "s":
            if e["id"] in starts:
                raise ValueError(f"duplicate flow start id {e['id']}")
            starts[e["id"]] = e
        elif ph == "f":
            if e["id"] in finishes:
                raise ValueError(f"duplicate flow finish id {e['id']}")
            finishes[e["id"]] = e
    for fid, s in starts.items():
        f = finishes.get(fid)
        if f is None:
            raise ValueError(f"flow start {fid} has no finish: {s}")
        if f["ts"] < s["ts"]:
            raise ValueError(
                f"flow {fid} finishes before it starts: {s} -> {f}")
    for fid in finishes:
        if fid not in starts:
            raise ValueError(f"flow finish {fid} has no start")
    for e in events:
        if e["ph"] in ("X", "i"):
            if e["pid"] not in named_pids:
                raise ValueError(f"slice on unnamed pid: {e}")
            if (e["pid"], e["tid"]) not in named_tids:
                raise ValueError(f"slice on unnamed tid: {e}")
    return counts
