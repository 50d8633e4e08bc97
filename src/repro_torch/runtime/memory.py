"""Size-class buffer pooling over the bufalloc arena (the trimmed port of
``repro.runtime.memory``).

:class:`BufferPool` is a size-class free-list pool over a
:class:`~repro_torch.runtime.bufalloc.Bufalloc` arena.  Serving-style
workloads allocate and free same-sized KV blocks per request; the pool
turns that steady state into O(1) free-list pops instead of first-fit
walks over the chunk list.  The serving engine pages its KV cache from
one.  Sub-buffers and map/unmap wait for the port's buffers (ROADMAP
A.4).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

from .bufalloc import Bufalloc, Chunk, OutOfMemory


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


__all__ = ["BufferPool"]
