"""Multi-device co-execution of one NDRange.

The port of ``repro.runtime.scheduler``.  One launch fans out over
several :class:`~repro_torch.runtime.platform.Device`\\ s — two ``cuda``
devices of one card, the card and a ``vector`` device of the host, or
any other mix:

* the NDRange is split along the **linearized work-group axis** into
  contiguous ``group_range`` chunks (work-groups are the only unit OpenCL
  lets you split on: no cross-group synchronization exists); on a
  ``cuda`` device a chunk is one ``group_range`` sub-launch of the
  hand-written work-group kernel;
* **static** mode pre-assigns one contiguous span per device, sized by
  ``weights`` (compute-power ratios, default equal);
* **steal** mode enqueues many small chunks into a shared deque and lets
  each device's drain command pull the next chunk whenever it finishes
  one — self-scheduling, so a slow device simply takes fewer chunks;
* **adaptive** mode (EngineCL's HGuided) is the N-device asymmetric
  scheduler: a per-device :class:`ThroughputModel` (EWMA of groups/sec
  read off the event profiling counters: at each finished chunk, the
  device's groups over its chunks' seconds so far in the launch — the
  reference observes each chunk alone, and on a card a tail chunk of one
  group times its command, not the device, ROADMAP C.11) drives an
  :class:`AdaptiveSplitter` that hands out geometrically shrinking
  chunks proportional to modeled speed, re-weights across launches, and
  — when the frontier drains — *steals* a straggler's in-flight span so
  a stalled device never strands work.  The stealer writes the same
  bits, so the duplicate is harmless to the merge; but a chunk launches
  in place, so it is not pure as the reference's are (ROADMAP C.9): the
  merge waits for every transfer, and the next launch waits for the
  last one's stragglers before it moves data onto their copies or runs
  a chunk there.  Converged weights persist per device
  class through the :class:`~repro_torch.core.autotune.TuningTable`
  (``<ir-hash>|coexec=<class-vector>`` keys), so a warm second run
  starts near the converged split;
* every chunk runs as a command on the device's own
  :class:`~repro_torch.runtime.queue.CommandQueue`, and a chunk on a CUDA
  device waits for the card before its command completes, so its event
  times the kernel and not its launch; the final merge command *waits
  on all chunk events across queues* — a cross-queue event DAG;
* a :class:`SharedBuffer` keeps its canonical copy on the host and one
  tensor per device; a :class:`~repro_torch.runtime.bufalloc.
  ResidencyTracker` keeps each device copy valid until some launch
  writes it, so N chunk launches on one device trigger exactly one
  migration (a host-to-card copy for a CUDA device);
* migration is **event-ordered**: each pending copy is enqueued as an
  explicit ``transfer`` command on the destination device's queue, and
  chunk commands carry dependency edges on their device's transfer
  events;
* write-invalidation is **span-granular**: the merge records which byte
  spans each device's chunks actually wrote, so a device's copy goes
  stale only over the spans *other* devices wrote — the next launch
  re-migrates those spans, not the whole buffer.

Chunks launch in place on their device's copy, so after the chunks each
participating device's copy differs from the launch's canonical copy
exactly where that device wrote.  The merge brings each such copy to the
host and takes the elements whose **bit patterns** differ from the
canonical copy's.  Results are therefore bitwise identical to a
single-device launch of the same target, signed zeros and NaN payloads
included; the reference compares with ``!=``, which treats -0.0 as 0.0
and any NaN as any NaN, and so drops a chunk's sign flip of a zero or a
NaN (ROADMAP C.10).  (Merging assumes the OpenCL data-race rule:
distinct work-groups write disjoint elements.)
"""

from __future__ import annotations

import itertools
import math
import threading
import time
import warnings
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.autotune import TuningTable, default_table
from ..core.errors import InvalidArgError
from ..core.program import Kernel
from .bufalloc import ResidencyTracker, Span
from .events import UserEvent, chunk_counters, wait_for_events
from .platform import Buffer, Device, create_buffer
from .queue import CommandQueue, Event, _settle

_buf_ids = itertools.count()

#: the integer type of each element width, to compare bit patterns
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}

#: the smallest share of the fastest device's rate a device is given:
#: a ratio of two rates can underflow to 0 (ROADMAP C.6)
_MIN_SHARE = 1e-12


def _changed_mask(sub: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Elements of ``sub`` whose bit patterns differ from ``ref``'s.
    Bits, not ``!=``: a chunk that writes -0.0 over 0.0, or one NaN over
    another, changed the element (ROADMAP C.10), and a NaN it did not
    write is unchanged (NaN != NaN would have every chunk claim it)."""
    if sub.dtype == torch.bool:
        return sub != ref
    bits = _BITS.get(sub.element_size())
    if bits is None or sub.is_complex():
        raise InvalidArgError(
            f"co-execution cannot merge buffers of {sub.dtype}")
    return sub.view(bits) != ref.view(bits)


def _mask_to_byte_spans(mask: torch.Tensor, itemsize: int,
                        max_runs: int = 64) -> Optional[List[Span]]:
    """Contiguous runs of a flattened element mask, as *exact* byte
    spans, or ``None`` when the write pattern is so scattered that span
    bookkeeping would cost more than it saves.

    ``None`` (not a covering envelope) on overflow is deliberate:
    ``commit_spans`` credits the writer as *valid* over its spans, and
    an over-approximation in that direction could wipe another device's
    overlapping invalidation — the caller must fall back to a
    whole-buffer commit instead."""
    m = mask.reshape(-1)
    if m.numel() == 0:
        return []
    # the element indices where the mask flips: run boundaries
    cuts = (torch.nonzero(m[1:] != m[:-1]).flatten() + 1).tolist()
    if len(cuts) > 2 * max_runs:
        return None
    bounds = [0] + cuts + [m.numel()]
    first = bool(m[0])      # runs alternate, starting with m[0]'s value
    spans = [(a * itemsize, b * itemsize)
             for i, (a, b) in enumerate(zip(bounds, bounds[1:]))
             if (i % 2 == 0) == first]
    return spans if len(spans) <= max_runs else None


def _host_tensor(host) -> torch.Tensor:
    """The canonical host copy of a SharedBuffer's initial value: a
    numpy array is shared, a tensor on another device is copied."""
    if isinstance(host, torch.Tensor):
        return host.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(host)))


class SharedBuffer:
    """A buffer logically shared by several devices (cl_mem used from
    multiple queues).

    The canonical copy lives on the host (``self.host``, a CPU tensor);
    each device gets a lazily-allocated
    :class:`~repro_torch.runtime.platform.Buffer` — a flat tensor on the
    device — filled on first use and kept valid across launches by the
    residency tracker.  Migration is span-granular: :meth:`migrate_to`
    copies only the byte spans the tracker reports stale.  ``commit``
    installs a new canonical value (after a merge) and invalidates every
    device copy; :meth:`commit_spans` is the granular variant that
    credits each device with the spans it wrote itself.
    """

    def __init__(self, host, name: str, tracker: ResidencyTracker):
        self.host = _host_tensor(host)
        self.name = name
        # residency is keyed by a per-instance nonce, not the user-chosen
        # name: two SharedBuffers reusing a name on one tracker must not
        # alias each other's residency state (stale device data)
        self._key = f"{name}#{next(_buf_ids)}"
        self.tracker = tracker
        self._device_bufs: Dict[Device, Buffer] = {}
        self._lock = threading.Lock()

    @property
    def nbytes(self) -> int:
        return self.host.numel() * self.host.element_size()

    @property
    def key(self) -> str:
        """The residency-tracker key of this buffer instance."""
        return self._key

    def migrate_to(self, device: Device) -> int:
        """Make the device copy current; returns bytes actually copied.

        Copies exactly the spans the tracker reports stale — the body of
        an event-ordered ``transfer`` command, but also safe to call
        inline (it is idempotent between writes).  The copy happens at
        most once per (buffer, device) between writes, and a copy to a
        CUDA device has landed when this returns."""
        with self._lock:
            buf = self._device_bufs.get(device)
            if buf is None:
                buf = create_buffer(
                    device, self.host.numel(),
                    torch.empty(0, dtype=self.host.dtype).numpy().dtype)
                self._device_bufs[device] = buf
            spans = self.tracker.acquire_spans(self._key, device,
                                               self.nbytes)
            if not spans:
                return 0
            itemsize = self.host.element_size()
            src, dst = self.host.reshape(-1), buf.data
            moved = 0
            for lo, hi in spans:
                dst[lo // itemsize:hi // itemsize].copy_(
                    src[lo // itemsize:hi // itemsize])
                moved += hi - lo
            _settle(device.torch_device)
            return moved

    def resident_tensor(self, device: Device) -> torch.Tensor:
        """The device copy (a flat tensor) as it stands, without
        migrating: :meth:`migrate_to` first."""
        with self._lock:
            return self._device_bufs[device].data

    def clean_on(self, device: Device) -> bool:
        """True when the device copy exists and has no stale spans (a
        transfer command for it would be a no-op)."""
        with self._lock:
            if device not in self._device_bufs:
                return False
        return self.tracker.resident(self._key, device)

    def commit(self, merged: torch.Tensor) -> None:
        """Install a merged result as the canonical host copy; all device
        copies become stale (the next read on any device re-migrates)."""
        with self._lock:
            self.host = merged
            self.tracker.wrote(self._key, "host")

    def commit_spans(self, merged: torch.Tensor,
                     written: Dict[Device, List[Span]]) -> None:
        """Granular commit: install the merged canonical copy, crediting
        each device with the byte spans its own chunks wrote.

        Every device copy goes stale exactly over the spans *other*
        devices wrote (``wrote_span`` pairwise), and the host — which
        holds the full merge — is validated everywhere."""
        with self._lock:
            self.host = merged
            for device, spans in written.items():
                for lo, hi in spans:
                    self.tracker.wrote_span(self._key, device, lo, hi)
            self.tracker.validate(self._key, "host")

    def release(self) -> None:
        """Free every device copy and forget residency."""
        with self._lock:
            for buf in self._device_bufs.values():
                buf.release()
            self._device_bufs.clear()
            self.tracker.drop(self._key)


def split_groups(n_groups: int, shares: Sequence[float]
                 ) -> List[Tuple[int, int]]:
    """Split ``[0, n_groups)`` into contiguous spans proportional to
    ``shares`` (one span per share).

    Shares need not sum to 1 — only the ratios matter.  A zero share is
    legal and yields an empty span (the caller decides whether that
    device participates); so is ``n_groups < len(shares)``, where
    rounding leaves some spans empty.  Degenerate inputs — an empty
    share list, a negative/NaN/infinite share, a non-numeric share, or a
    non-positive total — raise a typed
    :class:`~repro_torch.core.errors.InvalidArgError` (CL_INVALID_VALUE)
    instead of producing overlapping or nonsensical spans."""
    try:
        n = int(n_groups)
    except (TypeError, ValueError):
        raise InvalidArgError(
            f"n_groups must be an integer, got {n_groups!r}") from None
    if n < 0:
        raise InvalidArgError(f"n_groups must be >= 0, got {n}")
    try:
        vals = [float(s) for s in shares]
    except (TypeError, ValueError):
        raise InvalidArgError(
            f"split shares must be numeric, got {shares!r}") from None
    if not vals:
        raise InvalidArgError("split_groups needs at least one share")
    for s in vals:
        if not math.isfinite(s) or s < 0:
            raise InvalidArgError(
                f"split shares must be finite and >= 0, got {vals}")
    total = sum(vals)
    if total <= 0:
        raise InvalidArgError(f"split shares must sum > 0, got {vals}")
    bounds = [0]
    acc = 0.0
    for s in vals[:-1]:
        acc += s
        bounds.append(min(n, round(n * acc / total)))
    bounds.append(n)
    # enforce monotonicity after rounding
    for i in range(1, len(bounds)):
        bounds[i] = max(bounds[i], bounds[i - 1])
    return [(bounds[i], bounds[i + 1]) for i in range(len(vals))]


def device_class(device) -> str:
    """The persistence class of a device: devices of one class share one
    tuning-table weight entry.  Wrappers (e.g.
    :class:`~repro_torch.runtime.platform.ThrottledDevice`) override
    ``coexec_class``; plain devices fall back to their driver kind, so
    e.g. all ``cuda`` devices of a platform learn one weight."""
    cls = getattr(device, "coexec_class", None)
    if cls:
        return str(cls)
    info = getattr(device, "info", None)
    return str(getattr(info, "driver", device))


class ThroughputModel:
    """Per-device online throughput model: an EWMA of observed execution
    rate in work-groups per second, fed by the profiling counters
    stamped on every chunk :class:`~repro_torch.runtime.events.Event`.

    ``weights()`` turns modeled rates into a normalized split: devices
    with no observations yet are assumed average (equal split when
    nothing is known), so a cold N-device launch degrades gracefully to
    the symmetric case.  Degenerate observations — zero/negative
    duration, non-finite rate, failed events — are dropped.  Rates are
    divided by the largest before they are summed, and no share falls
    below ``_MIN_SHARE`` of the fastest device's, so the weights stay
    positive, finite and normalized whatever the rates' range (the
    reference divides the raw rates by their sum, and a weight
    underflows to 0 when the rates are 1e300 apart: ROADMAP C.6).

    Within a launch (:meth:`start_launch`), :meth:`observe_event` folds
    each device's finished chunks into running totals and observes
    their ratio: the device's rate over the launch so far, not the last
    chunk's alone, whose time on the card is mostly its host command
    (ROADMAP C.11).

    A warm start (:meth:`seed`, fed from the tuning table's persisted
    per-class weights) holds only until the first real observation of
    that device, which *replaces* it instead of blending: persisted
    weights are relative shares, not groups/sec.
    """

    def __init__(self, alpha: float = 0.5):
        if not (0.0 < float(alpha) <= 1.0):
            raise InvalidArgError(
                f"EWMA alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self._rate: Dict[object, float] = {}
        self._seeded: set = set()
        # groups and seconds of each device's chunks in this launch
        self._launch: Dict[object, List[float]] = {}
        self._lock = threading.Lock()

    def seed(self, device, rate: float) -> bool:
        """Warm-start a device's modeled rate (any positive scale — only
        ratios matter).  Ignored when invalid or when the device already
        has a measured rate.  Returns True when applied."""
        try:
            r = float(rate)
        except (TypeError, ValueError):
            return False
        if not math.isfinite(r) or r <= 0:
            return False
        with self._lock:
            if device in self._rate and device not in self._seeded:
                return False
            self._rate[device] = r
            self._seeded.add(device)
        return True

    def observe(self, device, groups: int, seconds: float) -> bool:
        """Fold one measured chunk (``groups`` over ``seconds``) into the
        device's EWMA.  Returns False (and changes nothing) for
        degenerate samples."""
        try:
            g, s = float(groups), float(seconds)
        except (TypeError, ValueError):
            return False
        if not (math.isfinite(g) and math.isfinite(s)) or g <= 0 or s <= 0:
            return False
        rate = g / s
        if not math.isfinite(rate) or rate <= 0:
            return False
        with self._lock:
            prev = self._rate.get(device)
            if prev is None or device in self._seeded:
                # first real measurement: replace (see class docstring)
                self._rate[device] = rate
                self._seeded.discard(device)
            else:
                self._rate[device] = \
                    self.alpha * rate + (1 - self.alpha) * prev
        return True

    def start_launch(self) -> None:
        """Start a launch: the running totals :meth:`observe_event` folds
        chunks into begin again at zero."""
        with self._lock:
            self._launch.clear()

    def observe_event(self, device, groups: int, event: Event) -> bool:
        """Fold one completed chunk event, through the profiling-counter
        extraction layer (:func:`~repro_torch.runtime.events.
        chunk_counters`), into the device's totals for this launch, and
        observe the device's groups over its seconds so far."""
        rows = chunk_counters([event])
        if not rows or not rows[0]["ok"]:
            return False
        with self._lock:
            acc = self._launch.setdefault(device, [0, 0.0])
            acc[0] += groups
            acc[1] += rows[0]["duration_s"]
            total_groups, total_s = acc
        return self.observe(device, total_groups, total_s)

    def rate(self, device) -> Optional[float]:
        """Modeled groups/sec for ``device`` (None when never observed
        or seeded)."""
        with self._lock:
            return self._rate.get(device)

    def weights(self, devices: Sequence[object]) -> List[float]:
        """Normalized relative speeds over ``devices``: finite, positive,
        summing to 1.  Unobserved devices get the mean known rate."""
        with self._lock:
            rates = [self._rate.get(d) for d in devices]
        known = [r for r in rates if r is not None]
        top = max(known) if known else 1.0
        fill = sum(r / top for r in known) / len(known) if known else 1.0
        raw = [max(_MIN_SHARE, fill if r is None else r / top)
               for r in rates]
        total = sum(raw)
        return [r / total for r in raw]


class AdaptiveSplitter:
    """HGuided self-scheduling chunker over a shared group frontier
    (EngineCL, Nozal et al.).

    Each call to :meth:`next_chunk` hands the asking device the next
    contiguous span off the frontier, sized
    ``max(min_chunk, remaining * weight / divisor)`` — large chunks
    early (low scheduling overhead), geometrically shrinking toward the
    tail (load balance), proportional to the device's modeled speed
    (asymmetry).  When the frontier is empty but spans are still in
    flight, a finished device **steals** a straggler's span and
    re-executes it: chunks are pure and deterministic, so the duplicate
    writes identical bytes and the merge stays bitwise-correct, while
    the launch no longer waits for the straggler.

    Thread-safe: the co-executor calls it from event-completion
    callbacks on device worker threads.  :meth:`complete` returns True
    exactly once — when the completed spans first cover the whole range
    — which is the co-executor's signal to fire the merge gate.
    """

    def __init__(self, n_groups: int, devices: Sequence[object],
                 model: ThroughputModel, min_chunk: int = 1,
                 divisor: float = 2.0):
        if int(n_groups) < 0:
            raise InvalidArgError(f"n_groups must be >= 0, got {n_groups}")
        if not devices:
            raise InvalidArgError("AdaptiveSplitter needs >= 1 device")
        if int(min_chunk) < 1:
            raise InvalidArgError(f"min_chunk must be >= 1, got {min_chunk}")
        if not math.isfinite(float(divisor)) or float(divisor) < 1.0:
            raise InvalidArgError(f"divisor must be >= 1, got {divisor}")
        self.n_groups = int(n_groups)
        self.devices = list(devices)
        self.model = model
        self.min_chunk = int(min_chunk)
        self.divisor = float(divisor)
        self._next = 0                       # frontier: first unassigned group
        self._lock = threading.Lock()
        # span -> devices currently executing it (dispensed, not completed)
        self._inflight: Dict[Tuple[int, int], List[object]] = {}
        self._done: List[Tuple[int, int]] = []   # merged completed spans
        self._finished = self.n_groups == 0      # empty range: nothing to do
        self.chunks: Dict[object, int] = {d: 0 for d in self.devices}
        self.dispensed: Dict[object, int] = {d: 0 for d in self.devices}
        self.steals: Dict[object, int] = {d: 0 for d in self.devices}

    def next_chunk(self, device) -> Optional[Tuple[int, int]]:
        """The next span for ``device``: a fresh frontier chunk sized by
        modeled speed, else a steal of a straggler's in-flight span, else
        None (nothing useful left for this device)."""
        with self._lock:
            rem = self.n_groups - self._next
            if rem > 0:
                share = self.model.weights(self.devices)[
                    self.devices.index(device)]
                size = max(self.min_chunk,
                           int(math.ceil(rem * share / self.divisor)))
                size = min(size, rem)
                span = (self._next, self._next + size)
                self._next += size
                self._inflight.setdefault(span, []).append(device)
                self.chunks[device] += 1
                self.dispensed[device] += size
                return span
            # frontier drained: steal one straggler span (at most one
            # duplicate per span — a second executor buys nothing)
            for span, owners in self._inflight.items():
                if device not in owners and len(owners) == 1:
                    owners.append(device)
                    self.chunks[device] += 1
                    self.dispensed[device] += span[1] - span[0]
                    self.steals[device] += 1
                    return span
            return None

    def complete(self, device, span: Tuple[int, int]) -> bool:
        """Record that ``device`` finished ``span``.  Returns True exactly
        once: when completed spans first cover ``[0, n_groups)``."""
        with self._lock:
            self._inflight.pop(span, None)
            out: List[Tuple[int, int]] = []
            for a, b in sorted(self._done + [(int(span[0]), int(span[1]))]):
                if out and a <= out[-1][1]:
                    out[-1] = (out[-1][0], max(out[-1][1], b))
                else:
                    out.append((a, b))
            self._done = out
            covered = sum(b - a for a, b in out)
            if not self._finished and covered >= self.n_groups:
                self._finished = True
                return True
            return False

    @property
    def finished(self) -> bool:
        with self._lock:
            return self._finished

    def pending_spans(self) -> List[Tuple[int, int]]:
        """Spans dispensed but not yet completed (stragglers)."""
        with self._lock:
            return list(self._inflight)


class CoExecStats:
    """What one co-executed launch did: chunks and groups per device,
    events (with profiling), migrations — including the event-ordered
    transfer commands — the merge, and wall time."""

    def __init__(self) -> None:
        self.mode = ""
        self.n_groups = 0
        self.chunks_per_device: Dict[str, int] = {}
        self.groups_per_device: Dict[str, int] = {}
        # (device name, lo, hi) of every chunk run, in the order they ran
        self.chunk_spans: List[Tuple[str, int, int]] = []
        # chunks a device executed beyond its own assignment: re-executed
        # straggler spans in "adaptive" mode, chunks pulled from another
        # device's equal-split territory in "steal" mode (0 in "static")
        self.steals_per_device: Dict[str, int] = {}
        # modeled normalized split after the launch ("adaptive" only)
        self.weights: Dict[str, float] = {}
        self.events: List[Event] = []
        self.transfer_events: List[Event] = []
        self.migrations = 0
        self.partial_migrations = 0
        self.bytes_migrated = 0        # host -> devices
        self.bytes_to_device: Dict[str, int] = {}
        self.bytes_to_host = 0         # device copies read back to merge
        self.residency_hits = 0
        # per buffer: "spans" (span-granular commit), "whole" (writes too
        # scattered: whole-buffer invalidate) or "unchanged"
        self.merge_paths: Dict[str, str] = {}
        self.merge_s = 0.0
        self.wall_s = 0.0

    def migration_overlap_s(self) -> float:
        """Seconds of transfer time that ran concurrently with some
        kernel chunk (event-profile window intersection) — the time
        event-ordered migration hid behind compute.  Kernel windows are
        unioned first so concurrent chunks on several devices cannot
        count one transfer interval twice; the result is bounded by the
        summed transfer durations."""
        kernels = sorted((e.start_ns, e.end_ns) for e in self.events
                         if e.kind == "kernel" and e.start_ns and e.end_ns)
        merged: List[Tuple[int, int]] = []
        for ks, ke in kernels:
            if merged and ks <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], ke))
            else:
                merged.append((ks, ke))
        total = 0
        for t in self.transfer_events:
            if not (t.start_ns and t.end_ns):
                continue
            for ks, ke in merged:
                total += max(0, min(t.end_ns, ke) - max(t.start_ns, ks))
        return total / 1e9

    def as_dict(self) -> Dict[str, object]:
        return {"mode": self.mode, "n_groups": self.n_groups,
                "chunks_per_device": dict(self.chunks_per_device),
                "groups_per_device": dict(self.groups_per_device),
                "steals_per_device": dict(self.steals_per_device),
                "weights": dict(self.weights),
                "migrations": self.migrations,
                "partial_migrations": self.partial_migrations,
                "bytes_migrated": self.bytes_migrated,
                "bytes_to_device": dict(self.bytes_to_device),
                "bytes_to_host": self.bytes_to_host,
                "transfer_commands": len(self.transfer_events),
                "residency_hits": self.residency_hits,
                "merge_paths": dict(self.merge_paths),
                "merge_s": self.merge_s,
                "wall_s": self.wall_s}


class CoExecutor:
    """Fans ND-range launches out across multiple devices.

    Parameters
    ----------
    devices:
        The participating devices, of any drivers and torch devices;
        each gets a private out-of-order :class:`CommandQueue`.
    chunks_per_device:
        Granularity of the ``steal`` mode: the NDRange is cut into
        ``chunks_per_device * len(devices)`` chunks for self-scheduling.
    tuning_table:
        Where ``adaptive`` mode persists converged per-device-class
        split weights (and warm-starts from them).  Defaults to the
        process-default :func:`~repro_torch.core.autotune.default_table`;
        pass an explicit table for isolation.
    min_chunk_groups / hguided_divisor / ewma_alpha:
        Adaptive-mode knobs: smallest chunk the splitter dispenses, the
        HGuided shrink divisor (chunk = remaining * weight / divisor),
        and the throughput model's EWMA smoothing factor.
    """

    def __init__(self, devices: Sequence[Device],
                 chunks_per_device: int = 4,
                 tuning_table: Optional[TuningTable] = None,
                 min_chunk_groups: int = 1,
                 hguided_divisor: float = 2.0,
                 ewma_alpha: float = 0.5):
        if not devices:
            raise InvalidArgError("CoExecutor needs at least one device")
        self.devices = list(devices)
        self.chunks_per_device = chunks_per_device
        self.tuning_table = tuning_table
        self.min_chunk_groups = int(min_chunk_groups)
        self.hguided_divisor = float(hguided_divisor)
        # the throughput model outlives launches: that is what
        # "re-weights across launches" means — launch k+1's first split
        # uses launch k's converged rates
        self.throughput = ThroughputModel(alpha=ewma_alpha)
        self.tracker = ResidencyTracker()
        self.queues = {d: CommandQueue(d, out_of_order=True, workers=2)
                       for d in self.devices}
        self._kernels: Dict[tuple, object] = {}
        self.last_stats: Optional[CoExecStats] = None
        # chunk events of the last launch that had not ended when it
        # returned: adaptive mode's stragglers
        self._unfinished: List[Event] = []

    def _table(self) -> TuningTable:
        return self.tuning_table if self.tuning_table is not None \
            else default_table()

    # -- buffers ---------------------------------------------------------------
    def shared_buffer(self, host, name: str) -> SharedBuffer:
        """Wrap a host array or tensor for residency-tracked multi-device
        use.  Reusing the SharedBuffer across launches is what makes
        repeat launches migration-free."""
        return SharedBuffer(host, name, self.tracker)

    # -- kernel compilation (per device: enqueue-time specialization) ----------
    def _kernel_for(self, device: Device, build: Callable,
                    local_size: Sequence[int]):
        key = (device, build, tuple(local_size))
        k = self._kernels.get(key)
        if k is None:
            k = device.compile(build, local_size)
            self._kernels[key] = k
        return k

    # -- the co-executed launch -------------------------------------------------
    def launch(self, kernel: Kernel, global_size: Sequence[int],
               local_size: Sequence[int],
               mode: str = "static",
               weights: Optional[Sequence[float]] = None
               ) -> Dict[str, torch.Tensor]:
        """Co-execute a first-class :class:`~repro_torch.core.program.
        Kernel` over ``global_size``, split across this executor's
        devices.

        Buffer arguments bound on the kernel must be host arrays or
        tensors (wrapped in throwaway :class:`SharedBuffer`\\ s for the
        launch) or :class:`SharedBuffer`\\ s (keep residency across
        calls); a device-bound :class:`~repro_torch.runtime.platform.
        Buffer` is rejected with a typed error — it belongs on a
        single-device queue.  Each device specializes the kernel through
        its own compilation cache and the program's shared plan tier, so
        N devices run region formation once.  Returns the merged buffers
        as CPU tensors, bitwise identical to a single-device launch of
        the same kernel object."""
        buffers, scalars = kernel.launch_args(accept=("host", "shared"))
        kernels = {d: kernel.bind(d, local_size) for d in self.devices}
        return self._co_run(kernels, local_size, global_size, buffers,
                            scalars, mode, weights,
                            persist_key=kernel.ir_hash)

    def run(self, build: Callable, local_size: Sequence[int],
            global_size: Sequence[int],
            buffers: Dict[str, Union[np.ndarray, torch.Tensor,
                                     SharedBuffer]],
            scalars: Optional[Dict[str, object]] = None,
            mode: str = "static",
            weights: Optional[Sequence[float]] = None
            ) -> Dict[str, torch.Tensor]:
        """Deprecated host entry point: co-execute a bare IR builder.
        Superseded by binding arguments on a
        :class:`~repro_torch.core.program.Kernel` and calling
        :meth:`launch` — same split/merge machinery, plus typed argument
        validation and the program's shared plan tier."""
        warnings.warn(
            "CoExecutor.run(build, ...) is deprecated; create a "
            "Program/Kernel via Context and use CoExecutor.launch",
            DeprecationWarning, stacklevel=2)
        kernels = {d: self._kernel_for(d, build, local_size)
                   for d in self.devices}
        return self._co_run(kernels, local_size, global_size, buffers,
                            scalars, mode, weights)

    def _co_run(self, kernels: Dict[Device, object],
                local_size: Sequence[int],
                global_size: Sequence[int],
                buffers: Dict[str, Union[np.ndarray, torch.Tensor,
                                         SharedBuffer]],
                scalars: Optional[Dict[str, object]] = None,
                mode: str = "static",
                weights: Optional[Sequence[float]] = None,
                persist_key: Optional[str] = None
                ) -> Dict[str, torch.Tensor]:
        """Split/merge engine behind :meth:`launch` (and the deprecated
        :meth:`run`): ``kernels`` maps each device to its specialized
        launchable.  Returns the merged buffers (keyed like ``buffers``,
        CPU tensors of their shapes).  ``mode`` is ``"static"`` (one
        weighted span per device), ``"steal"`` (shared chunk deque,
        self-scheduled) or ``"adaptive"`` (throughput-modeled HGuided
        splitter with straggler stealing).  ``persist_key`` is the
        kernel's IR hash; when set, adaptive mode warm-starts from and
        records per-class weights into the tuning table."""
        t0 = time.perf_counter()
        # chunks launch in place on each device's copy, so they are not
        # pure (ROADMAP C.9): a straggler of the last launch may still be
        # reading and writing its copy, and this launch's transfers and
        # chunks on that copy wait until it has ended.  A straggler that
        # failed after its launch returned fails this one
        unfinished, self._unfinished = self._unfinished, []
        wait_for_events(unfinished)
        lsz = tuple(local_size) + (1,) * (3 - len(local_size))
        gsz = tuple(global_size) + (1,) * (3 - len(global_size))
        n_groups = int(np.prod([g // l for g, l in zip(gsz, lsz)]))
        shared: Dict[str, SharedBuffer] = {}
        throwaway: List[SharedBuffer] = []
        for nm, b in buffers.items():
            if isinstance(b, SharedBuffer):
                shared[nm] = b
            else:
                sb = SharedBuffer(b, nm, self.tracker)
                shared[nm] = sb
                throwaway.append(sb)
        # the canonical copies this launch starts from: a merge replaces
        # a SharedBuffer's host tensor, it never writes into it
        base = {nm: sb.host for nm, sb in shared.items()}

        stats = CoExecStats()
        stats.mode = mode
        stats.n_groups = n_groups
        mig0 = self.tracker.migrations
        pmig0 = self.tracker.partial_migrations
        byte0 = self.tracker.bytes_migrated
        hit0 = self.tracker.hits

        ran: List[Device] = []           # devices whose copies chunks wrote
        plock = threading.Lock()

        def migrate(sb: SharedBuffer, device: Device) -> None:
            moved = sb.migrate_to(device)
            if moved:
                with plock:
                    nm = device.info.name
                    stats.bytes_to_device[nm] = \
                        stats.bytes_to_device.get(nm, 0) + moved

        def run_chunk(device: Device, lo: int, hi: int) -> None:
            if hi <= lo:
                return
            # the transfer commands below already moved stale spans;
            # migrating again re-checks residency, so these are hits (and
            # a safety net if a transfer was skipped as clean)
            tensors = {}
            for nm, sb in shared.items():
                migrate(sb, device)
                tensors[nm] = sb.resident_tensor(device)
            kernels[device].launch_ndrange(tensors, global_size, scalars,
                                           group_range=(lo, hi))
            # the chunk's event ends when the card has run it, so the
            # throughput model learns execution rates, not launch rates
            _settle(device.torch_device)
            with plock:
                if device not in ran:
                    ran.append(device)
                name = device.info.name
                stats.chunks_per_device[name] = \
                    stats.chunks_per_device.get(name, 0) + 1
                stats.groups_per_device[name] = \
                    stats.groups_per_device.get(name, 0) + (hi - lo)
                stats.chunk_spans.append((name, lo, hi))

        # -- plan the split -----------------------------------------------------
        if mode == "static":
            shares = list(weights) if weights is not None \
                else [1.0] * len(self.devices)
            if len(shares) != len(self.devices):
                raise InvalidArgError(
                    f"static co-execution needs one weight per device: "
                    f"{len(shares)} weights for {len(self.devices)} devices")
            spans = split_groups(n_groups, shares)
            plan = [(dev, (lo, hi)) for dev, (lo, hi)
                    in zip(self.devices, spans) if hi > lo]
            active = [dev for dev, _ in plan]
        elif mode in ("steal", "adaptive"):
            plan = None
            active = list(self.devices)
        else:
            raise InvalidArgError(f"unknown co-execution mode {mode!r}")

        # -- event-ordered migration -------------------------------------------
        # each stale (buffer, device) pair becomes an explicit transfer
        # command on the destination queue; chunk commands depend on
        # their device's transfers, so migration to one device overlaps
        # with compute (and transfers) on the others
        transfer_events: Dict[Device, List[Event]] = {d: [] for d in active}
        for dev in active:
            q = self.queues[dev]
            for nm, sb in shared.items():
                if sb.clean_on(dev):
                    continue
                ev = q.enqueue_native(
                    lambda s=sb, d=dev: migrate(s, d),
                    name=f"migrate:{nm}->{dev.info.name}",
                    kind="transfer")
                transfer_events[dev].append(ev)

        # -- enqueue chunk commands --------------------------------------------
        chunk_events: List[Event] = []
        elock = threading.Lock()
        splitter: Optional[AdaptiveSplitter] = None
        merge_gate: Optional[UserEvent] = None
        co_key: Optional[str] = None
        if mode == "static":
            for dev, (lo, hi) in plan:
                q = self.queues[dev]
                ev = q.enqueue_native(
                    lambda d=dev, a=lo, b=hi: run_chunk(d, a, b),
                    wait_for=transfer_events[dev],
                    name=f"co-chunk:{dev.info.name}:{lo}-{hi}",
                    kind="kernel")
                chunk_events.append(ev)
        elif mode == "steal":
            n_chunks = max(len(self.devices),
                           self.chunks_per_device * len(self.devices))
            chunk = -(-n_groups // n_chunks)  # ceil; whole work-groups
            todo = deque((lo, min(lo + chunk, n_groups))
                         for lo in range(0, n_groups, max(1, chunk)))
            # equal-split "territories" for steal accounting: a chunk a
            # device pulls from another device's territory is a steal
            own = split_groups(n_groups, [1.0] * len(self.devices)) \
                if n_groups else []

            def owner_of(lo: int) -> Optional[Device]:
                for d, (a, b) in zip(self.devices, own):
                    if a <= lo < b:
                        return d
                return None

            def drain(device: Device) -> None:
                while True:
                    try:
                        lo, hi = todo.popleft()
                    except IndexError:
                        return
                    run_chunk(device, lo, hi)
                    if owner_of(lo) is not device:
                        with plock:
                            nm = device.info.name
                            stats.steals_per_device[nm] = \
                                stats.steals_per_device.get(nm, 0) + 1

            for dev in self.devices:
                q = self.queues[dev]
                ev = q.enqueue_native(
                    lambda d=dev: drain(d),
                    wait_for=transfer_events[dev],
                    name=f"co-drain:{dev.info.name}",
                    kind="kernel")
                chunk_events.append(ev)
        else:  # adaptive: event-driven HGuided dispatch
            table = self._table()
            classes = [device_class(d) for d in self.devices]
            if persist_key:
                co_key = TuningTable.make_coexec_key(persist_key, classes)
                ent = table.get_coexec(co_key)
                if ent:
                    for d, cls in zip(self.devices, classes):
                        w = ent["weights"].get(cls)
                        if w is not None:
                            self.throughput.seed(d, w)
            splitter = AdaptiveSplitter(
                n_groups, self.devices, self.throughput,
                min_chunk=self.min_chunk_groups,
                divisor=self.hguided_divisor)
            # the merge waits on this gate, not on the chunk events: it
            # fires when completed spans first cover [0, n_groups), which
            # may be *before* a stalled straggler finishes its (stolen,
            # already re-executed) span
            merge_gate = UserEvent("co-adaptive-done")
            self.throughput.start_launch()

            def on_chunk_done(ev: Event, device: Device,
                              span: Tuple[int, int]) -> None:
                if ev.failed:
                    merge_gate.fail(ev.error)  # merge sees DependencyError
                    return
                self.throughput.observe_event(device, span[1] - span[0], ev)
                if splitter.complete(device, span):
                    merge_gate.complete()
                elif not merge_gate.done:
                    dispatch(device)

            def dispatch(device: Device) -> None:
                span = splitter.next_chunk(device)
                if span is None:
                    return
                lo, hi = span
                q = self.queues[device]
                ev = q.enqueue_native(
                    lambda d=device, a=lo, b=hi: run_chunk(d, a, b),
                    wait_for=transfer_events[device],
                    name=f"co-adaptive:{device.info.name}:{lo}-{hi}",
                    kind="kernel")
                with elock:
                    chunk_events.append(ev)
                ev.add_callback(
                    lambda e, d=device, s=span: on_chunk_done(e, d, s))
                # callbacks enqueue after the launch-time flush below, so
                # every dynamic enqueue must arm its command itself
                q.flush()

            if splitter.finished:        # n_groups == 0: nothing to run
                merge_gate.complete()
            for dev in active:
                dispatch(dev)

        # the merge waits on every chunk event — across queues — then
        # folds each device's written elements into the canonical copy
        merged: Dict[str, torch.Tensor] = {}

        def merge() -> None:
            t_merge = time.perf_counter()
            # snapshot: in adaptive mode a stalled straggler (whose span
            # was stolen and already merged-in) may still be running; its
            # writes are the stealer's bytes, so whatever of them its copy
            # holds already is equal to the merge
            with plock:
                parts = list(ran)
            for nm, sb in shared.items():
                ref = base[nm].reshape(-1)
                acc = ref.clone()
                itemsize = acc.element_size()
                written: Dict[Device, List[Span]] = {}
                exact = True
                for device in parts:
                    sub = sb.resident_tensor(device)
                    if sub.device.type != "cpu":
                        # through pinned memory: a copy to pageable
                        # memory runs at a fraction of the link's rate
                        host = torch.empty(sub.shape, dtype=sub.dtype,
                                           pin_memory=True)
                        sub = host.copy_(sub)
                        stats.bytes_to_host += sub.numel() * itemsize
                    mask = _changed_mask(sub, ref)
                    if bool(mask.any()):
                        acc = torch.where(mask, sub, acc)
                        spans = _mask_to_byte_spans(mask, itemsize)
                        if spans is None:
                            exact = False
                        else:
                            written.setdefault(device, []).extend(spans)
                acc = acc.reshape(base[nm].shape)
                merged[nm] = acc
                stats.merge_paths[nm] = "whole" if not exact else \
                    "spans" if written else "unchanged"
                if written or not exact:
                    if exact:
                        # span-granular invalidation: each device stays
                        # valid over what it wrote itself and goes stale
                        # only over the spans other devices wrote
                        sb.commit_spans(acc, written)
                    else:
                        # a write pattern too scattered for exact spans:
                        # whole-buffer invalidate (always safe)
                        sb.commit(acc)
            stats.merge_s = time.perf_counter() - t_merge

        q0 = self.queues[self.devices[0]]
        # adaptive: every transfer lands before the merge commits, so a
        # chunk that runs after the gate reads this launch's data
        merge_deps = chunk_events if merge_gate is None else \
            [merge_gate] + [e for evs_ in transfer_events.values()
                            for e in evs_]
        merge_ev = q0.enqueue_native(merge, wait_for=merge_deps,
                                     name="co-merge")
        for q in self.queues.values():
            q.flush()
        try:
            merge_ev.wait()
        finally:
            with elock:
                evs = list(chunk_events)
            stragglers = [e for e in evs if not e.done]
            self._unfinished = stragglers
            if throwaway and stragglers:
                # a stolen straggler is still executing against the
                # throwaway device buffers: release once it lands, off
                # the launch's critical path (its result is already
                # merged — purity makes the duplicate bitwise-identical)
                def release_when_idle(evs=evs):
                    for e in evs:
                        e._terminal.wait(60.0)
                    for sb in throwaway:
                        sb.release()
                q0.enqueue_native(release_when_idle, name="co-release")
                q0.flush()
            else:
                for sb in throwaway:  # one-shot wrappers: free the copies
                    sb.release()

        if splitter is not None:
            for d in self.devices:
                nm = d.info.name
                stats.steals_per_device[nm] = splitter.steals[d]
            stats.weights = {
                d.info.name: w for d, w in
                zip(self.devices, self.throughput.weights(self.devices))}
            if co_key is not None:
                # persist per *class*: same-class devices share (average)
                cls_w: Dict[str, List[float]] = {}
                for d in self.devices:
                    cls_w.setdefault(device_class(d), []).append(
                        stats.weights[d.info.name])
                self._table().record_coexec(
                    co_key, {c: sum(v) / len(v) for c, v in cls_w.items()})
        stats.events = chunk_events + [merge_ev]
        stats.transfer_events = [e for evs_ in transfer_events.values()
                                 for e in evs_]
        stats.migrations = self.tracker.migrations - mig0
        stats.partial_migrations = self.tracker.partial_migrations - pmig0
        stats.bytes_migrated = self.tracker.bytes_migrated - byte0
        stats.residency_hits = self.tracker.hits - hit0
        stats.wall_s = time.perf_counter() - t0
        self.last_stats = stats
        return merged

    def finish(self) -> None:
        """Drain every per-device queue (clFinish over the device set)."""
        for q in self.queues.values():
            q.finish()


__all__ = ["AdaptiveSplitter", "CoExecStats", "CoExecutor", "SharedBuffer",
           "ThroughputModel", "device_class", "split_groups"]
