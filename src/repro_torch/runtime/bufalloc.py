"""Bufalloc — the pocl kernel-buffer allocator (paper §3).

Faithful reimplementation of the design described in the paper:

* a single large *region* is obtained up front (one malloc / static array /
  known device-memory range) — here it models an HBM arena;
* internal book-keeping is a list of **chunks** ordered by start address,
  each with a free/allocated flag and a size;
* the **last chunk is a sentinel** holding all unallocated memory;
* allocation walks the list **first-fit** and splits the found chunk in two:
  one with the exact request size (returned) and one with the remainder;
* an optional **greedy mode** always serves new requests from the sentinel
  (end of region) when possible, so successive allocations of a kernel's
  buffer group land in continuous memory;
* frees coalesce with free neighbours — the workload assumption is
  long-lived buffers allocated and freed in groups, so fragmentation stays
  low by construction.

The serving engine uses a Bufalloc arena for its paged KV cache
(:mod:`repro.serve.kvcache`), and the OpenCL-style runtime uses it for
``clCreateBuffer`` book-keeping on devices without their own allocator.

:class:`ResidencyTracker` extends the same host-side book-keeping across
*devices*: it records which devices currently hold a valid copy of each
shared buffer — and, at **byte-span granularity**, which parts of each
copy are stale — so the multi-device co-execution scheduler
(:mod:`repro.runtime.scheduler`) migrates a buffer to a device **once** —
not once per sub-range launch — re-migrates only the spans another device
wrote, and invalidates exactly the span a write through any aliased
sub-buffer view or mapped region touched (the implicit cl_mem migration
of OpenCL §5.3, "moved to the device on first use, cached until another
device writes", refined to sub-buffer granularity; docs/memory.md).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Hashable, Iterator, List, Optional, Tuple

from ..core.errors import ReproError, register_error


@register_error
class OutOfMemory(ReproError, MemoryError):
    """Arena exhausted (CL_MEM_OBJECT_ALLOCATION_FAILURE).  Part of the
    typed :class:`~repro.core.errors.ReproError` hierarchy."""

    code = -4
    code_name = "CL_MEM_OBJECT_ALLOCATION_FAILURE"


@dataclass
class Chunk:
    start: int
    size: int
    free: bool
    prev: Optional["Chunk"] = None
    next: Optional["Chunk"] = None

    def __repr__(self) -> str:  # pragma: no cover
        return f"<{'F' if self.free else 'A'} @{self.start} +{self.size}>"


class Bufalloc:
    def __init__(self, region_size: int, alignment: int = 64,
                 greedy: bool = False):
        assert region_size > 0 and alignment > 0
        self.region_size = region_size
        self.alignment = alignment
        self.greedy = greedy
        # sentinel last chunk holds all unallocated memory
        self._head = Chunk(0, region_size, True)
        self._sentinel = self._head
        self._allocated = 0
        self.n_allocs = 0
        self.n_frees = 0

    # -- helpers ---------------------------------------------------------------
    def _align(self, n: int) -> int:
        a = self.alignment
        return (n + a - 1) // a * a

    def chunks(self) -> Iterator[Chunk]:
        c = self._head
        while c is not None:
            yield c
            c = c.next

    # -- allocation --------------------------------------------------------------
    def alloc(self, size: int) -> Chunk:
        """First-fit allocation; greedy mode serves from the sentinel."""
        req = self._align(max(size, 1))
        target: Optional[Chunk] = None
        if self.greedy and self._sentinel.free and self._sentinel.size >= req:
            target = self._sentinel
        else:
            for c in self.chunks():
                if c.free and c.size >= req:
                    target = c
                    break
        if target is None:
            raise OutOfMemory(
                f"Bufalloc: {size} bytes requested, "
                f"{self.free_bytes()} free (fragmented into "
                f"{sum(1 for c in self.chunks() if c.free)} chunks)")
        # split: exact-size allocated chunk + remainder chunk
        if target.size > req:
            rest = Chunk(target.start + req, target.size - req, True,
                         prev=target, next=target.next)
            if target.next is not None:
                target.next.prev = rest
            target.next = rest
            target.size = req
            if target is self._sentinel:
                self._sentinel = rest
        elif target is self._sentinel:
            # sentinel fully consumed; new sentinel is the last free chunk
            self._sentinel = target
        target.free = False
        self._allocated += req
        self.n_allocs += 1
        return target

    def free(self, chunk: Chunk) -> None:
        assert not chunk.free, "double free"
        chunk.free = True
        self._allocated -= chunk.size
        self.n_frees += 1
        # coalesce with free neighbours
        if chunk.next is not None and chunk.next.free:
            nxt = chunk.next
            chunk.size += nxt.size
            chunk.next = nxt.next
            if nxt.next is not None:
                nxt.next.prev = chunk
            if nxt is self._sentinel:
                self._sentinel = chunk
        if chunk.prev is not None and chunk.prev.free:
            prv = chunk.prev
            prv.size += chunk.size
            prv.next = chunk.next
            if chunk.next is not None:
                chunk.next.prev = prv
            if chunk is self._sentinel:
                self._sentinel = prv

    def alloc_group(self, sizes: List[int]) -> List[Chunk]:
        """Allocate a kernel's buffer group with successive calls (the
        paper's usage pattern); greedy mode makes these contiguous."""
        out: List[Chunk] = []
        try:
            for s in sizes:
                out.append(self.alloc(s))
        except OutOfMemory:
            for c in out:
                self.free(c)
            raise
        return out

    def free_group(self, chunks: List[Chunk]) -> None:
        for c in chunks:
            self.free(c)

    # -- introspection -------------------------------------------------------------
    def free_bytes(self) -> int:
        return self.region_size - self._allocated

    def allocated_bytes(self) -> int:
        return self._allocated

    def largest_free(self) -> int:
        return max((c.size for c in self.chunks() if c.free), default=0)

    def fragmentation(self) -> float:
        """1 - largest_free/free_bytes (0 = unfragmented)."""
        fb = self.free_bytes()
        if fb == 0:
            return 0.0
        return 1.0 - self.largest_free() / fb

    def check_invariants(self) -> None:
        prev_end = 0
        prev = None
        last = None
        for c in self.chunks():
            assert c.start == prev_end, "chunks must be contiguous"
            assert c.size > 0
            assert c.prev is prev
            prev_end = c.start + c.size
            prev = c
            last = c
        assert prev_end == self.region_size
        # the sentinel is always the last chunk of the region (it starts
        # as the whole-region free chunk and every alloc/free path that
        # splits or merges the tail re-points it there)
        assert last is self._sentinel, "sentinel must be the last chunk"
        # no two adjacent free chunks (coalescing invariant)
        for c in self.chunks():
            if c.free and c.next is not None:
                assert not c.next.free, "adjacent free chunks not coalesced"


# ---------------------------------------------------------------------------
# Byte-span interval arithmetic for span-granular residency
# ---------------------------------------------------------------------------

#: open upper bound for "stale to the end of the buffer" — clipped to the
#: real buffer size whenever a caller provides one (acquire_spans)
SPAN_END = 1 << 62

Span = Tuple[int, int]


def span_union(spans: List[Span], lo: int, hi: int) -> List[Span]:
    """Insert ``[lo, hi)`` into a sorted disjoint span list, merging."""
    if hi <= lo:
        return list(spans)
    out: List[Span] = []
    placed = False
    for s, e in spans:
        if e < lo or (placed and s > hi):
            out.append((s, e))
        elif s > hi:
            if not placed:
                out.append((lo, hi))
                placed = True
            out.append((s, e))
        else:  # overlaps or touches [lo, hi): absorb
            lo, hi = min(lo, s), max(hi, e)
    if not placed:
        out.append((lo, hi))
    out.sort()
    return out


def span_subtract(spans: List[Span], lo: int, hi: int) -> List[Span]:
    """Remove ``[lo, hi)`` from a sorted disjoint span list."""
    if hi <= lo:
        return list(spans)
    out: List[Span] = []
    for s, e in spans:
        if e <= lo or s >= hi:
            out.append((s, e))
            continue
        if s < lo:
            out.append((s, lo))
        if e > hi:
            out.append((hi, e))
    return out


def span_clip(spans: List[Span], size: int) -> List[Span]:
    """Clip a span list to ``[0, size)`` (drops empty leftovers)."""
    return [(s, min(e, size)) for s, e in spans if s < size]


def span_total(spans: List[Span]) -> int:
    return sum(e - s for s, e in spans)


class ResidencyTracker:
    """Which devices hold a valid copy of each shared buffer — and, since
    the hierarchical-memory subsystem (docs/memory.md), *which byte spans*
    of each copy are stale.

    Keys are opaque hashables (the scheduler uses buffer identities);
    devices likewise.  The contract mirrors OpenCL's implicit cl_mem
    migration, refined to sub-buffer granularity:

    * :meth:`acquire` — a device is about to *read* the whole buffer.
      Returns True when a copy is due (no copy at all, or any stale
      span), False on a residency hit.  Binary compatibility shim over
      :meth:`acquire_spans`.
    * :meth:`acquire_spans` — the span-granular read: returns exactly the
      byte spans the caller must copy to make the device copy current
      (``[]`` = hit, ``[(0, size)]`` = full migration, anything else =
      **partial migration** — e.g. re-reading after another device wrote
      a disjoint sub-range).
    * :meth:`wrote` — a launch *wrote* the whole buffer on a device/host;
      every other copy becomes fully stale.
    * :meth:`wrote_span` — a write through an aliased view (sub-buffer,
      mapped region, ``group_range`` sub-launch): the writing device's
      copy becomes valid over ``[lo, hi)`` and every *other* copy becomes
      stale over exactly that span — not the whole buffer.
    * :meth:`validate` — mark a device's copy fully current without
      invalidating anyone (used for the canonical host copy after a
      merge already accounted for per-device writes).
    * :meth:`drop` — forget a buffer entirely (released).

    Thread-safe: sub-range launches acquire concurrently from the
    per-device queue workers.
    """

    def __init__(self) -> None:
        # per key: device -> sorted disjoint list of *stale* byte spans
        # (device present = holds a copy; empty list = fully valid)
        self._copies: Dict[Hashable, Dict[Hashable, List[Span]]] = {}
        self._lock = threading.Lock()
        self.migrations = 0         # copy operations that happened
        self.partial_migrations = 0  # ...of which only stale spans moved
        self.hits = 0               # reads served by a valid copy
        self.bytes_migrated = 0     # bytes actually copied (span API only)

    # -- reads ----------------------------------------------------------------
    def acquire(self, key: Hashable, device: Hashable) -> bool:
        """Record a whole-buffer read of ``key`` on ``device``; True if a
        copy is due (the caller copies the full buffer)."""
        with self._lock:
            copies = self._copies.setdefault(key, {})
            stale = copies.get(device)
            if stale is not None and not stale:
                self.hits += 1
                return False
            copies[device] = []
            self.migrations += 1
            return True

    def acquire_spans(self, key: Hashable, device: Hashable,
                      size: int) -> List[Span]:
        """Span-granular read of a ``size``-byte buffer on ``device``.

        Returns the byte spans the caller must copy from the canonical
        data; the device copy is considered fully valid afterwards."""
        with self._lock:
            copies = self._copies.setdefault(key, {})
            stale = copies.get(device)
            if stale is None:
                copies[device] = []
                self.migrations += 1
                self.bytes_migrated += size
                return [(0, size)]
            due = span_clip(stale, size)
            copies[device] = []
            if not due:
                self.hits += 1
                return []
            self.migrations += 1
            if span_total(due) < size:
                self.partial_migrations += 1
            self.bytes_migrated += span_total(due)
            return due

    # -- writes ---------------------------------------------------------------
    def wrote(self, key: Hashable, device: Hashable) -> None:
        """Record a whole-buffer write on ``device``: it becomes the sole
        valid copy."""
        with self._lock:
            self._copies[key] = {device: []}

    def wrote_span(self, key: Hashable, device: Hashable,
                   lo: int, hi: int) -> None:
        """Record a write of bytes ``[lo, hi)`` on ``device``.

        The writing copy becomes valid over the span; every other copy
        becomes stale over the span *only* — the write-invalidation
        granularity sub-buffers and ``group_range`` sub-launches need."""
        if hi <= lo:
            return
        with self._lock:
            copies = self._copies.setdefault(key, {})
            for dev in list(copies):
                if dev == device:
                    copies[dev] = span_subtract(copies[dev], lo, hi)
                else:
                    copies[dev] = span_union(copies[dev], lo, hi)
            if device not in copies:
                # writer had no copy: valid exactly over what it wrote
                copies[device] = [(s, e) for s, e in
                                  ((0, lo), (hi, SPAN_END)) if e > s]

    def validate(self, key: Hashable, device: Hashable) -> None:
        """Mark ``device``'s copy fully current without staling others."""
        with self._lock:
            self._copies.setdefault(key, {})[device] = []

    # -- introspection ---------------------------------------------------------
    def resident(self, key: Hashable, device: Hashable,
                 size: Optional[int] = None) -> bool:
        """True when ``device`` holds a fully valid copy of ``key``.

        Pass ``size`` to ignore bookkeeping staleness beyond the real
        buffer end (a writer that never held a full copy is marked stale
        to ``SPAN_END`` because the tracker does not know buffer sizes)."""
        with self._lock:
            stale = self._copies.get(key, {}).get(device)
            if stale is None:
                return False
            if size is not None:
                stale = span_clip(stale, size)
            return not stale

    def stale_spans(self, key: Hashable, device: Hashable,
                    size: Optional[int] = None) -> Optional[List[Span]]:
        """The device copy's stale spans (``None`` = no copy at all)."""
        with self._lock:
            stale = self._copies.get(key, {}).get(device)
            if stale is None:
                return None
            return span_clip(stale, size) if size is not None \
                else list(stale)

    def drop(self, key: Hashable) -> None:
        with self._lock:
            self._copies.pop(key, None)

    def stats(self) -> Dict[str, int]:
        """Migration/hit counters plus the number of tracked buffers."""
        with self._lock:
            return {"migrations": self.migrations,
                    "partial_migrations": self.partial_migrations,
                    "hits": self.hits,
                    "bytes_migrated": self.bytes_migrated,
                    "tracked": len(self._copies)}
