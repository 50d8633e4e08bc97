"""Hierarchical buffer memory: sub-buffers, map/unmap through a host
bounce, and size-class pooling over the bufalloc arena (the port of
``repro.runtime.memory``).

Three layers on top of :mod:`repro_torch.runtime.bufalloc` /
:mod:`repro_torch.runtime.platform`:

* :class:`SubBuffer` — ``clCreateSubBuffer`` (OpenCL §5.2): an aliased
  view carved from a parent :class:`~repro_torch.runtime.platform.Buffer`
  at a byte ``origin``, subject to the device's ``mem_base_addr_align``
  rule.  Its payload is a ``narrow`` view of the parent's tensor, so
  reads and writes (kernel launches included) land in place, and a write
  through *any* view invalidates exactly the overlapping span of the
  parent's other device copies (span-granular residency,
  :meth:`~repro_torch.runtime.bufalloc.ResidencyTracker.wrote_span`).
* :class:`MappedRegion` — the object ``CommandQueue.enqueue_map_buffer``
  (OpenCL §5.4.2) publishes.  The buffer lives in device memory, so a map
  is a **host bounce**: the map command copies the span into a host
  staging array (pinned for a CUDA device) and publishes
  :attr:`MappedRegion.array`, a numpy view of it; the unmap command of a
  writable map copies the staging array back to the device and then
  publishes the written span.  Host writes reach the device at unmap
  (OpenCL leaves mapped contents undefined until then).
  ``MAP_WRITE_INVALIDATE`` maps skip the read-back hook and the copy to
  the host — the contents are undefined until the host writes them.
* :class:`BufferPool` — a size-class free-list pool over a
  :class:`~repro_torch.runtime.bufalloc.Bufalloc` arena.  Serving-style
  workloads allocate and free same-sized KV blocks per request; the pool
  turns that steady state into O(1) free-list pops instead of first-fit
  walks over the chunk list.

The command-queue integration (map/unmap as DAG commands, the mapped
launch guard) lives in :mod:`repro_torch.runtime.queue`.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.errors import MapError
from .bufalloc import Bufalloc, Chunk, OutOfMemory
from .platform import Buffer, copy_into


# map flags (clEnqueueMapBuffer map_flags analogues)
MAP_READ = "r"                    # CL_MAP_READ
MAP_WRITE = "w"                   # CL_MAP_WRITE
MAP_READ_WRITE = "rw"
MAP_WRITE_INVALIDATE = "wi"       # CL_MAP_WRITE_INVALIDATE_REGION

_VALID_FLAGS = (MAP_READ, MAP_WRITE, MAP_READ_WRITE, MAP_WRITE_INVALIDATE)


# ---------------------------------------------------------------------------
# Sub-buffers (clCreateSubBuffer, OpenCL §5.2)
# ---------------------------------------------------------------------------

class SubBuffer:
    """An aliased view of ``[origin, origin + nbytes)`` of a parent buffer.

    Duck-compatible with :class:`~repro_torch.runtime.platform.Buffer`
    where the runtime needs it (``data`` get/set, ``mark_written*``,
    ``root``, ``release``) so kernel launches, read/write enqueues, and
    maps accept either.  ``data`` is a view of the parent's *current*
    tensor, recomputed on every access.
    """

    def __init__(self, parent: Buffer, origin: int, nbytes: int):
        if isinstance(parent, SubBuffer):
            # OpenCL: buffer must not itself be a sub-buffer object
            raise MapError("cannot carve a sub-buffer from a sub-buffer")
        align = parent.device.info.mem_base_addr_align
        if origin % align != 0:
            raise MapError(
                f"sub-buffer origin {origin} violates the device "
                f"mem_base_addr_align of {align} bytes "
                f"(CL_MISALIGNED_SUB_BUFFER_OFFSET)")
        if nbytes <= 0 or origin < 0 or origin + nbytes > parent.nbytes:
            raise MapError(
                f"sub-buffer [{origin}, {origin + nbytes}) outside parent "
                f"of {parent.nbytes} bytes (CL_INVALID_BUFFER_SIZE)")
        if origin % parent.itemsize or nbytes % parent.itemsize:
            raise MapError(
                f"sub-buffer [{origin}, {origin + nbytes}) not a whole "
                f"number of {parent.dtype} elements")
        self.parent = parent
        self.device = parent.device
        self.dtype = parent.dtype
        self.itemsize = parent.itemsize
        self.origin = origin
        self.nbytes = nbytes
        self.n_elems = nbytes // parent.itemsize

    @property
    def root(self) -> Buffer:
        return self.parent

    @property
    def data(self) -> torch.Tensor:
        """A view of the parent's tensor (recomputed per access)."""
        return self.parent.data.narrow(0, self.origin // self.itemsize,
                                       self.n_elems)

    @data.setter
    def data(self, value) -> None:
        """Write through the view: in place into the parent's span."""
        copy_into(self.data, value, self.dtype)

    # -- residency: writes through a view invalidate parent-relative spans --
    def mark_written_span(self, lo: int, hi: int) -> None:
        self.parent.mark_written_span(self.origin + lo, self.origin + hi)

    def mark_written(self) -> None:
        self.mark_written_span(0, self.nbytes)

    @property
    def map_count(self) -> int:
        return self.parent.map_count

    def release(self) -> None:
        """Views own no memory; releasing is a no-op (the parent's chunk
        stays allocated until the parent is released)."""

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"<SubBuffer [{self.origin}, {self.origin + self.nbytes}) "
                f"of {self.parent.nbytes}B {self.dtype}>")


def create_sub_buffer(parent: Buffer, origin: int, nbytes: int) -> SubBuffer:
    """clCreateSubBuffer with CL_BUFFER_CREATE_TYPE_REGION: an aliased
    ``[origin, origin + nbytes)`` byte view of ``parent``."""
    return SubBuffer(parent, origin, nbytes)


# ---------------------------------------------------------------------------
# Mapped regions (clEnqueueMapBuffer / clEnqueueUnmapMemObject, §5.4.2)
# ---------------------------------------------------------------------------

class MappedRegion:
    """One active host mapping of a buffer span.

    Created by ``CommandQueue.enqueue_map_buffer``; :attr:`array` is
    ``None`` until the map command completes (wait on :attr:`event`),
    then a numpy view of the region's host staging array, which the map
    filled from the device (except for ``MAP_WRITE_INVALIDATE``).  After
    the unmap command runs, :attr:`array` is ``None`` again; for
    write-flagged maps the staging array went back to the device and the
    span was published to the residency tracker as a span-granular
    invalidation.
    """

    def __init__(self, buf, offset: int, nbytes: int, flags: str):
        if flags not in _VALID_FLAGS:
            raise MapError(f"bad map flags {flags!r}; one of {_VALID_FLAGS}")
        if nbytes <= 0 or offset < 0 or offset + nbytes > buf.nbytes:
            raise MapError(
                f"map [{offset}, {offset + nbytes}) outside buffer of "
                f"{buf.nbytes} bytes (CL_INVALID_VALUE)")
        if offset % buf.itemsize or nbytes % buf.itemsize:
            raise MapError(
                f"map [{offset}, {offset + nbytes}) not a whole number "
                f"of {buf.dtype} elements")
        self.buf = buf
        self.offset = offset                 # bytes, buffer-relative
        self.nbytes = nbytes
        self.flags = flags
        # absolute span within the root allocation (views compose)
        self.abs_span: Tuple[int, int] = (buf.origin + offset,
                                          buf.origin + offset + nbytes)
        self.event = None                    # set by enqueue_map_buffer
        self.unmap_event = None              # set by enqueue_unmap_buffer
        self.array: Optional[np.ndarray] = None
        self._staging: Optional[torch.Tensor] = None   # host bounce
        self._active = False

    @property
    def writable(self) -> bool:
        return self.flags in (MAP_WRITE, MAP_READ_WRITE,
                              MAP_WRITE_INVALIDATE)

    @property
    def active(self) -> bool:
        return self._active

    def span(self) -> torch.Tensor:
        """The mapped elements of the buffer's device tensor (a view)."""
        return self.buf.data.narrow(0, self.offset // self.buf.itemsize,
                                    self.nbytes // self.buf.itemsize)

    def get(self, timeout: Optional[float] = None) -> np.ndarray:
        """Wait for the map command and return the published array.

        Flushes the owning queue first — the ``blocking_map`` semantics
        of clEnqueueMapBuffer (a blocking map implies a flush, otherwise
        the wait could never resolve)."""
        if self.event.queue is not None:
            self.event.queue.flush()
        self.event.wait(timeout)
        return self.array

    def overlaps(self, lo: int, hi: int) -> bool:
        """Does this region's root-absolute span intersect ``[lo, hi)``?"""
        a, b = self.abs_span
        return a < hi and lo < b

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "active" if self._active else \
            ("unmapped" if self.unmap_event is not None else "pending")
        return (f"<MappedRegion {self.flags} "
                f"[{self.abs_span[0]}, {self.abs_span[1]}) {state}>")


# ---------------------------------------------------------------------------
# Size-class buffer pool (serving KV allocations over the arena)
# ---------------------------------------------------------------------------

class BufferPool:
    """Size-class free-list pool over a :class:`Bufalloc` arena.

    ``alloc`` rounds the request up to a power-of-two size class (at
    least ``min_class`` bytes) and serves it from the class free list
    when possible — an O(1) pop with no chunk-list walk, no split, and
    no later coalesce.  Misses fall through to ``arena.alloc``; frees
    return chunks to the class list (bounded by ``max_free_per_class``,
    overflow goes back to the arena).  ``trim`` releases every pooled
    chunk to the arena, and an alloc that hits :class:`OutOfMemory`
    trims and retries once before giving up.

    Rounding to classes trades internal fragmentation (< 2x) for reuse:
    serving's per-request KV blocks are identically sized in steady
    state, so after warm-up every alloc is a hit
    (``benchmarks/bench_memory.py`` gates the throughput ratio).
    """

    def __init__(self, arena: Bufalloc, min_class: int = 256,
                 max_free_per_class: int = 64):
        assert min_class > 0 and max_free_per_class >= 0
        self.arena = arena
        self.min_class = min_class
        self.max_free_per_class = max_free_per_class
        self._free: Dict[int, List[Chunk]] = {}
        # id(chunk) -> (chunk, size class); holding the chunk reference
        # pins the id, so a caller-dropped chunk can never alias a fresh
        # allocation's id and corrupt a free list
        self._class: Dict[int, Tuple[Chunk, int]] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.frees = 0
        self.trims = 0

    def class_of(self, size: int) -> int:
        """The pool size class serving a ``size``-byte request."""
        size = max(int(size), 1)
        return max(self.min_class, 1 << (size - 1).bit_length())

    def alloc(self, size: int) -> Chunk:
        """A chunk of at least ``size`` bytes (exactly one size class)."""
        cls = self.class_of(size)
        with self._lock:
            lst = self._free.get(cls)
            if lst:
                self.hits += 1
                return lst.pop()
            self.misses += 1
            try:
                chunk = self.arena.alloc(cls)
            except OutOfMemory:
                self._trim_locked()
                chunk = self.arena.alloc(cls)   # may re-raise: truly full
            self._class[id(chunk)] = (chunk, cls)
            return chunk

    def free(self, chunk: Chunk) -> None:
        """Return a pool chunk to its class free list."""
        with self._lock:
            entry = self._class.get(id(chunk))
            if entry is None or entry[0] is not chunk:
                raise ValueError("chunk was not allocated by this pool")
            cls = entry[1]
            lst = self._free.setdefault(cls, [])
            if any(c is chunk for c in lst):
                # parking it twice would hand the chunk to two owners
                raise ValueError("double free of pool chunk")
            self.frees += 1
            if len(lst) < self.max_free_per_class:
                lst.append(chunk)
            else:
                del self._class[id(chunk)]
                self.arena.free(chunk)

    def trim(self) -> int:
        """Release every pooled free chunk back to the arena; returns the
        number of bytes returned."""
        with self._lock:
            return self._trim_locked()

    def _trim_locked(self) -> int:
        freed = 0
        for lst in self._free.values():
            for chunk in lst:
                del self._class[id(chunk)]
                freed += chunk.size     # read before free() coalesces it
                self.arena.free(chunk)
            lst.clear()
        if freed:
            self.trims += 1
        return freed

    def pooled_bytes(self) -> int:
        """Bytes currently parked on the free lists (arena-allocated but
        reusable without a first-fit walk)."""
        with self._lock:
            return sum(c.size for lst in self._free.values() for c in lst)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "frees": self.frees, "trims": self.trims,
                    "pooled_bytes": sum(c.size for lst in self._free.values()
                                        for c in lst),
                    "live_classes": sum(1 for lst in self._free.values()
                                        if lst)}


__all__ = [
    "MapError", "MAP_READ", "MAP_WRITE", "MAP_READ_WRITE",
    "MAP_WRITE_INVALIDATE", "SubBuffer", "create_sub_buffer",
    "MappedRegion", "BufferPool",
]
