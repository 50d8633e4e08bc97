"""Kernel-compiler compilation cache (docs/caching.md).

pocl compiles one work-group function per (kernel, local size) at enqueue
time and *reuses* it across enqueues — recompilation only happens when the
kernel or the specialization parameters change.  Our pipeline (normalize →
region formation → target lowering) previously re-ran on every
``compile_kernel`` call.  This module memoizes the whole compilation:

* **Key** — ``CacheKey``: a canonical, content-addressed hash of the kernel
  IR (stable across DSL re-definition: SSA value ids and block-name counters
  are renamed away), plus the local size, the target name, and the target
  option tuple.  Two ``build()`` closures producing structurally identical
  CFGs map to the same entry.
* **In-memory tier** — an LRU over compiled :class:`CompiledKernel` objects
  (``capacity`` entries; least-recently-used eviction).
* **Disk tier** (optional) — pickled kernels under ``disk_dir`` for
  cross-process reuse; per-shape jit caches are dropped on pickle and
  rebuilt lazily after load.  Entries that fail to pickle (e.g. exotic
  targets) are silently kept memory-only.

Invalidation is purely content-driven: any IR change, local-size change, or
option change produces a different key.  ``CACHE_SCHEMA_VERSION`` is folded
into every key so that compiler-pipeline changes invalidate stale disk
entries wholesale.

Stats (hits / misses / compiles / evictions / disk traffic) are surfaced
per-device through :meth:`repro.runtime.platform.Device.cache_stats`.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

from .errors import InvalidArgError
from .ir import CondBranch, Function, Jump, Return, Value

# bump when the compiler pipeline changes in ways that invalidate old
# compiled programs (folded into every cache key, incl. disk entries)
# v2: pass-manager pipeline — compiled kernels embed a WorkGroupPlan
# v3: WorkGroupPlan carries fusibility facts (DAG-level kernel fusion)
CACHE_SCHEMA_VERSION = 3


# ---------------------------------------------------------------------------
# Canonical IR text + content hash
# ---------------------------------------------------------------------------

def canonical_value_names(fn: Function) -> Dict[int, str]:
    """SSA value id -> first-reference canonical name (``v0``, ``v1``, ...)
    in the exact order :func:`canonical_ir` prints references: scalar args
    first, then per RPO block its phis (incomings, then the result), each
    instruction's operands then result, and the branch condition.  Shared
    by ``canonical_ir`` and ``WorkGroupPlan.describe`` so slot names in
    plan dumps match the printed IR."""
    names: Dict[int, str] = {}

    def ref(v: object) -> None:
        if isinstance(v, Value) and v.id not in names:
            names[v.id] = f"v{len(names)}"

    for a in fn.scalar_args:
        ref(fn.arg_values[a.name])
    for n in fn.rpo():
        blk = fn.blocks[n]
        for phi in blk.phis:
            # canonical_ir renders the sorted incoming list before the
            # "<result> = phi" text, so incomings take names first
            for v in phi.incomings.values():
                ref(v)
            ref(phi.result)
        for ins in blk.instrs:
            for o in ins.operands:
                ref(o)
            if ins.result is not None:
                ref(ins.result)
        term = blk.terminator
        if isinstance(term, CondBranch):
            ref(term.cond)
    return names


def canonical_ir(fn: Function) -> str:
    """Render ``fn`` to a canonical text form.

    Canonicalization renames every basic block to its reverse-post-order
    index and every SSA value to its first-reference index, so the result is
    independent of the process-global value counter and the builder's block
    name counters — re-running the same DSL code yields the same text.
    """
    order = fn.rpo()
    bmap = {n: f"b{i}" for i, n in enumerate(order)}
    vmap: Dict[int, str] = canonical_value_names(fn)

    def vref(v: object) -> str:
        if isinstance(v, Value):
            if v.id not in vmap:  # unreferenced-elsewhere safety net
                vmap[v.id] = f"v{len(vmap)}"
            return f"{vmap[v.id]}:{v.dtype}"
        return f"lit({type(v).__name__},{v!r})"

    lines = [f"func {fn.name} ndim={fn.ndim}"]
    for a in fn.buffer_args:
        lines.append(f"buf {a.name}:{a.dtype}@{a.space} size={a.size}")
    for a in fn.scalar_args:
        # scalar args bind SSA values; fix their canonical names up front
        lines.append(f"scalar {a.name}:{a.dtype} {vref(fn.arg_values[a.name])}")

    for n in order:
        blk = fn.blocks[n]
        lines.append(f"block {bmap[n]}")
        for phi in blk.phis:
            incs = sorted((bmap.get(p, p), vref(val))
                          for p, val in phi.incomings.items())
            lines.append(f"  {vref(phi.result)} = phi {incs}")
        for ins in blk.instrs:
            ops = ",".join(vref(o) for o in ins.operands)
            attrs = ";".join(f"{k}={v!r}" for k, v in sorted(ins.attrs.items()))
            res = vref(ins.result) if ins.result is not None else "_"
            lines.append(f"  {res} = {ins.op}({ops}) [{attrs}]")
        t = blk.terminator
        if isinstance(t, CondBranch):
            lines.append(f"  condbr {vref(t.cond)} "
                         f"{bmap.get(t.if_true, t.if_true)} "
                         f"{bmap.get(t.if_false, t.if_false)}")
        elif isinstance(t, Jump):
            lines.append(f"  jump {bmap.get(t.target, t.target)}")
        elif isinstance(t, Return):
            lines.append("  return")
        else:
            lines.append(f"  term {t!r}")
    return "\n".join(lines)


def ir_hash(fn: Function) -> str:
    """Content hash of the kernel (sha256 of the canonical IR text)."""
    return hashlib.sha256(canonical_ir(fn).encode()).hexdigest()


@dataclass(frozen=True)
class CacheKey:
    """(what to compile, how to specialize it) — the full cache identity."""

    ir: str                      # canonical IR hash
    local_size: Tuple[int, ...]
    target: str
    options: Tuple[Tuple[str, object], ...]  # sorted (name, value) pairs
    schema: int = CACHE_SCHEMA_VERSION

    @classmethod
    def make(cls, fn: Function, local_size: Sequence[int], target: str,
             **options) -> "CacheKey":
        return cls(ir_hash(fn), tuple(int(x) for x in local_size), target,
                   tuple(sorted(options.items())))

    def digest(self) -> str:
        """Filesystem-safe digest for the disk tier."""
        raw = repr((self.ir, self.local_size, self.target, self.options,
                    self.schema))
        return hashlib.sha256(raw.encode()).hexdigest()


@dataclass(frozen=True)
class PlanKey:
    """Identity of the *target-independent prefix* of a compilation: the
    :class:`repro.core.passes.WorkGroupPlan`.  Deliberately narrower than
    :class:`CacheKey` — no ``local_size`` (lane counts bind at target
    construction), no ``target``, and only the options that feed the
    middle-end (``horizontal``, ``merge_uniform``).  One plan entry is
    therefore shared by every target and local size of a kernel: the
    autotuner's 3-target sweep runs region formation once
    (docs/caching.md §Stage-level plan caching)."""

    ir: str                                   # canonical IR hash
    options: Tuple[Tuple[str, object], ...]   # sorted middle-end options
    schema: int = CACHE_SCHEMA_VERSION

    PLAN_OPTIONS = ("horizontal", "merge_uniform")

    @classmethod
    def make(cls, ir: str, **options) -> "PlanKey":
        opts = {k: v for k, v in options.items() if k in cls.PLAN_OPTIONS}
        return cls(ir, tuple(sorted(opts.items())))


@dataclass(frozen=True)
class FusedKey:
    """Identity of a stitched kernel chain in the fused tier
    (docs/caching.md §Fused-chain caching).

    ``parts`` are the constituent kernels' canonical IR hashes in chain
    order; ``edges`` is the chain topology — one
    ``(producer_seg, consumer_seg, producer_arg, consumer_arg, elided)``
    tuple per forwarded buffer; ``aliases`` records which (segment, arg)
    pairs were bound to one buffer object and therefore folded into one
    fused parameter.  The key is purely structural: two chains of
    structurally identical kernels wired the same way hit the same entry
    regardless of which Buffer objects or queues are involved."""

    parts: Tuple[str, ...]
    edges: Tuple[Tuple[int, int, str, str, bool], ...]
    aliases: Tuple[Tuple[Tuple[int, str], ...], ...]
    options: Tuple[Tuple[str, object], ...]
    schema: int = CACHE_SCHEMA_VERSION


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------

@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    compiles: int = 0
    evictions: int = 0
    disk_hits: int = 0
    disk_writes: int = 0
    tune_decisions: int = 0
    # stage-level plan tier (target-independent prefix sharing)
    plan_hits: int = 0
    plan_misses: int = 0
    plan_builds: int = 0
    # fused tier (stitched kernel chains, keyed by FusedKey)
    fused_hits: int = 0
    fused_misses: int = 0
    fused_builds: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)

    def reset(self) -> None:
        for k in list(self.__dict__):
            setattr(self, k, 0)


class CompilationCache:
    """LRU compilation cache with an optional on-disk pickle tier.

    Thread-safe and single-flight: the command queue compiles from worker
    threads, and concurrent ``get_or_compile`` calls for the same key run
    the pipeline exactly once — the winner compiles outside the lock while
    the others wait on a per-key event and then take the memory hit.
    """

    def __init__(self, capacity: int = 128,
                 disk_dir: Optional[str] = None,
                 plan_capacity: Optional[int] = None):
        if int(capacity) <= 0 or (plan_capacity is not None
                                  and int(plan_capacity) <= 0):
            # a zero-capacity LRU would evict every insert immediately —
            # callers who want no caching pass cache=False instead
            raise InvalidArgError(
                f"CompilationCache capacity must be positive, got "
                f"capacity={capacity!r} plan_capacity={plan_capacity!r}")
        self.capacity = int(capacity)
        self.plan_capacity = int(plan_capacity if plan_capacity is not None
                                 else capacity)
        self.disk_dir = disk_dir
        self._entries: "OrderedDict[CacheKey, object]" = OrderedDict()
        # stage-level tier: WorkGroupPlan per PlanKey, separate from the
        # kernel LRU so plan sharing never evicts compiled kernels (and
        # len(cache) keeps meaning "compiled kernels resident")
        self._plans: "OrderedDict[PlanKey, object]" = OrderedDict()
        # fused tier: FusedSpec per FusedKey (stitched kernel chains) —
        # memory-only, like plans: the compiled fused kernels land in the
        # normal kernel tiers through the usual device.compile path
        self._fused: "OrderedDict[FusedKey, object]" = OrderedDict()
        self._inflight: Dict[object, threading.Event] = {}
        self._lock = threading.Lock()
        self.stats = CacheStats()

    @classmethod
    def from_env(cls, capacity: int = 128) -> "CompilationCache":
        """A cache whose disk tier follows REPRO_KERNEL_CACHE_DIR (the one
        place this env var is interpreted)."""
        return cls(capacity=capacity,
                   disk_dir=os.environ.get("REPRO_KERNEL_CACHE_DIR") or None)

    def note_tune_decision(self) -> None:
        with self._lock:
            self.stats.tune_decisions += 1

    # -- lookup ---------------------------------------------------------------
    def get_or_compile(self, key: CacheKey, compile_fn: Callable[[], object]):
        while True:
            with self._lock:
                ent = self._entries.get(key)
                if ent is not None:
                    self._entries.move_to_end(key)
                    self.stats.hits += 1
                    return ent
                ev = self._inflight.get(key)
                if ev is None:
                    ev = threading.Event()
                    self._inflight[key] = ev
                    owner = True
                else:
                    owner = False
            if not owner:
                # another thread is compiling this key; wait and re-check
                # (re-loop also handles the owner failing: we take over)
                ev.wait()
                continue
            store_to_disk = False
            try:
                ent = self._disk_load(key)
                if ent is not None:
                    with self._lock:
                        self.stats.hits += 1
                        self.stats.disk_hits += 1
                    self._insert(key, ent)
                    return ent
                with self._lock:
                    self.stats.misses += 1
                ent = compile_fn()
                with self._lock:
                    self.stats.compiles += 1
                self._insert(key, ent)
                store_to_disk = True
                return ent
            finally:
                # release waiters as soon as the memory tier is populated;
                # the (potentially slow) disk write must not block them
                with self._lock:
                    self._inflight.pop(key, None)
                ev.set()
                if store_to_disk:
                    self._disk_store(key, ent)

    # -- stage-level plan tier --------------------------------------------------
    def get_or_build_plan(self, key: PlanKey,
                          build_fn: Callable[[], object]):
        """Memoize the target-independent pipeline prefix (the
        :class:`~repro.core.passes.WorkGroupPlan`).  Memory-only — plans
        are embedded in the compiled kernels the disk tier persists —
        and single-flight, like :meth:`get_or_compile`."""
        while True:
            with self._lock:
                ent = self._plans.get(key)
                if ent is not None:
                    self._plans.move_to_end(key)
                    self.stats.plan_hits += 1
                    return ent
                ev = self._inflight.get(key)
                if ev is None:
                    ev = threading.Event()
                    self._inflight[key] = ev
                    owner = True
                else:
                    owner = False
            if not owner:
                ev.wait()
                continue
            try:
                with self._lock:
                    self.stats.plan_misses += 1
                ent = build_fn()
                with self._lock:
                    self.stats.plan_builds += 1
                    self._plans[key] = ent
                    self._plans.move_to_end(key)
                    while len(self._plans) > self.plan_capacity:
                        self._plans.popitem(last=False)
                return ent
            finally:
                with self._lock:
                    self._inflight.pop(key, None)
                ev.set()

    def plan_cache_size(self) -> int:
        with self._lock:
            return len(self._plans)

    # -- fused tier (stitched kernel chains) ------------------------------------
    def get_or_build_fused(self, key: FusedKey,
                           build_fn: Callable[[], object]):
        """Memoize a stitched-chain artifact (a
        :class:`~repro.core.fusion.FusedSpec`) under its structural
        :class:`FusedKey`.  Memory-only and single-flight like the plan
        tier: steady-state fusion of a repeated chain is one dict
        lookup — the stitching, verification, and planning all happened
        on the first flush."""
        while True:
            with self._lock:
                ent = self._fused.get(key)
                if ent is not None:
                    self._fused.move_to_end(key)
                    self.stats.fused_hits += 1
                    return ent
                ev = self._inflight.get(key)
                if ev is None:
                    ev = threading.Event()
                    self._inflight[key] = ev
                    owner = True
                else:
                    owner = False
            if not owner:
                ev.wait()
                continue
            try:
                with self._lock:
                    self.stats.fused_misses += 1
                ent = build_fn()
                with self._lock:
                    self.stats.fused_builds += 1
                    self._fused[key] = ent
                    self._fused.move_to_end(key)
                    while len(self._fused) > self.plan_capacity:
                        self._fused.popitem(last=False)
                return ent
            finally:
                with self._lock:
                    self._inflight.pop(key, None)
                ev.set()

    def fused_cache_size(self) -> int:
        with self._lock:
            return len(self._fused)

    # -- mutation --------------------------------------------------------------
    def _insert(self, key: CacheKey, ent: object) -> None:
        with self._lock:
            self._entries[key] = ent
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.stats.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._plans.clear()
            self._fused.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: CacheKey) -> bool:
        with self._lock:
            return key in self._entries

    # -- disk tier --------------------------------------------------------------
    def _disk_path(self, key: CacheKey) -> Optional[str]:
        if not self.disk_dir:
            return None
        # package tag: the reference package's pickles share
        # REPRO_KERNEL_CACHE_DIR and key digests, and unpickling one of
        # them here would import its (JAX) classes
        return os.path.join(self.disk_dir,
                            "repro_torch-" + key.digest() + ".pkl")

    def _disk_load(self, key: CacheKey):
        path = self._disk_path(key)
        if path is None or not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                return pickle.load(f)
        except Exception:
            # stale/corrupt entry: content-addressed, so just drop it
            try:
                os.remove(path)
            except OSError:
                pass
            return None

    def _disk_store(self, key: CacheKey, ent: object) -> None:
        path = self._disk_path(key)
        if path is None:
            return
        try:
            os.makedirs(self.disk_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(ent, f)
            os.replace(tmp, path)
            with self._lock:
                self.stats.disk_writes += 1
        except Exception:
            pass  # memory-only fallback (e.g. unpicklable target state)


# ---------------------------------------------------------------------------
# Process-default cache (used by compile_kernel when cache=True)
# ---------------------------------------------------------------------------

_default_cache: Optional[CompilationCache] = None
_default_lock = threading.Lock()


def default_cache() -> CompilationCache:
    global _default_cache
    with _default_lock:
        if _default_cache is None:
            _default_cache = CompilationCache.from_env()
        return _default_cache


def reset_default_cache() -> None:
    """Testing hook: drop the process-default cache (stats included)."""
    global _default_cache
    with _default_lock:
        _default_cache = None
