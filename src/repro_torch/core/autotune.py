"""Per-kernel target autotuner.

The port of ``repro.core.autotune``.  Which parallel mapping wins for a
kernel is platform- and kernel-dependent, so it is measured:

* ``_compile_kernel(build, lsz, target="auto")`` (an ``auto`` device's
  kernels) returns an :class:`AutotunedKernel`.
* On the **first launch of a (kernel, local size, global size) shape**,
  the candidate targets are compiled through the compilation cache,
  warmed up and timed.  On the CPU the candidates are ``loop`` and
  ``vector``; on a CUDA device they are ``vector`` and ``cuda``.  A
  candidate the device cannot run (``cuda`` on the CPU) is left out, not
  failed, and so is ``loop`` on a CUDA device: it steps the work-items
  from the host, 10^3-10^5 times the ``cuda`` kernel's time there.
* A candidate that fails is warned about and recorded next to the
  timings, except ``cuda`` on a CUDA device: the card's own kernel
  failing to build or launch is an error, never a quiet win of a plain
  candidate.
* Each timed window holds one launch and a synchronize of the device
  (a ``cuda`` launch returns before the card has run it); the copies of
  the buffers each timed launch runs on are made before the window.
* The winner is recorded in a :class:`TuningTable` (JSON on disk when a
  path is configured, e.g. via ``REPRO_TUNING_TABLE``; the reference's
  format and keys), so later processes skip the measurement.
* Every later launch routes straight through the recorded winner.

Launches are in place (:meth:`AutotunedKernel.launch_ndrange`, the
queue's path), so the candidates are timed on clones of the launch's
buffers and the winner then runs once on the buffers themselves.  A
recorded winner or a pin that names a target this package lacks (the
reference's ``pallas``), or one the launch's device cannot run, is
ignored and the shape is tuned again.

A kernel can be **pinned** to a target (``table.pin("mykernel",
"vector")``), which bypasses measurement for every shape of that kernel.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
import warnings
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from .api import TARGETS, to_device
from .cache import CacheKey, ir_hash
from .errors import BuildError
from .ir import Function

DEFAULT_CANDIDATES: Tuple[str, ...] = ("loop", "vector", "cuda")


class TuningTable:
    """Persistent (kernel shape -> winning target) table.

    Schema (JSON): ``{"winners": {key: {"target", "timings_us",
    "failed"?}}, "pins": {kernel_name: target},
    "coexec": {key: {"weights": {class: share}, "launches": n}},
    "sweeps": {key: {"params": {...}, "timings_us": {...}}}}``.
    Winner keys are ``"<ir-hash>|l=<local>|g=<global>|<options>"`` so a
    tuning decision is exactly as specific as the compilation it
    selects.  The ``coexec`` section persists converged multi-device
    split weights per *device class* (docs/runtime.md §Scheduler), keyed
    ``"<ir-hash>|coexec=<class>+<class>+..."`` — the ImageCL-style
    per-platform mapping decision, so a warm process starts a co-executed
    launch near the converged split instead of re-learning it.  The
    ``sweeps`` section persists *tuning-space* winners (tile/local
    sizes, unroll factors — the scoreboard's per-target parameter
    sweeps, docs/scoreboard.md): unlike winner keys, sweep keys cannot
    be IR hashes because each swept configuration builds a *different*
    kernel, so they are keyed by suite-kernel name + target + problem
    shape (:meth:`make_sweep_key`), and a warm run re-measures only the
    persisted winning configuration instead of the whole space.
    """

    def __init__(self, path: "Optional[str | os.PathLike]" = None):
        self.path = os.fspath(path) if path is not None else None
        self._winners: Dict[str, Dict[str, object]] = {}
        self._coexec: Dict[str, Dict[str, object]] = {}
        self._sweeps: Dict[str, Dict[str, object]] = {}
        self._pins: Dict[str, str] = {}
        self._lock = threading.Lock()
        # per-key tuning locks: concurrent first launches of the same
        # shape must not time candidates against each other's noise and
        # must record exactly one decision; unrelated shapes tune freely
        self._tune_locks: Dict[str, threading.Lock] = {}
        if path and os.path.exists(path):
            self._load()

    def tune_lock(self, key: str) -> threading.Lock:
        with self._lock:
            lk = self._tune_locks.get(key)
            if lk is None:
                lk = threading.Lock()
                self._tune_locks[key] = lk
            return lk

    # -- keying ----------------------------------------------------------------
    @staticmethod
    def make_key(ir: str, local_size: Sequence[int],
                 global_size: Sequence[int],
                 options: Sequence[Tuple[str, object]],
                 device: str = "") -> str:
        """Tuning key: kernel identity + specialization + (optionally) the
        device the measurement was taken on.  Runtime devices pass their
        name (``Device.build_kernel``), so a slow device's winner never
        leaks onto a fast one; ``device=""`` keeps the device-agnostic key
        (process-default tuning outside the runtime layer)."""
        l = "x".join(str(int(x)) for x in local_size)
        g = "x".join(str(int(x)) for x in global_size)
        o = ",".join(f"{k}={v}" for k, v in options)
        d = f"|dev={device}" if device else ""
        return f"{ir}{d}|l={l}|g={g}|{o}"

    @staticmethod
    def make_coexec_key(ir: str, device_classes: Sequence[str]) -> str:
        """Key for a persisted co-execution split: kernel identity plus
        the ordered *device-class vector* of the platform.  Classes (not
        device names) make the entry portable across processes whose
        device objects differ but whose platform shape is the same; the
        vector is ordered because weights are positional."""
        return f"{ir}|coexec={'+'.join(device_classes)}"

    @staticmethod
    def make_sweep_key(kernel: str, target: str, shape_desc: str,
                       device: str = "") -> str:
        """Key for a persisted tuning-space sweep winner.

        Sweep entries record *which point of a parameter space* (tile
        size, unroll factor, items-per-thread, ...) won for a suite
        kernel on one target — not which target won for one compiled
        kernel, which is what winner keys do.  Every swept point builds
        a different kernel (tile sizes are baked into the IR), so the IR
        hash cannot identify the sweep; the stable identity is the suite
        kernel's name, the target it was swept on, and the problem shape
        the timings were taken at."""
        d = f"|dev={device}" if device else ""
        return f"{kernel}|sweep|tgt={target}|shape={shape_desc}{d}"

    # -- persistence -----------------------------------------------------------
    def _load(self) -> None:
        try:
            with open(self.path) as f:
                raw = json.load(f)
            self._winners = dict(raw.get("winners", {}))
            self._coexec = dict(raw.get("coexec", {}))
            self._sweeps = dict(raw.get("sweeps", {}))
            self._pins = dict(raw.get("pins", {}))
        except Exception:
            self._winners, self._coexec, self._pins = {}, {}, {}
            self._sweeps = {}

    def _save(self) -> None:
        if not self.path:
            return
        try:
            tmp = self.path + ".tmp"
            os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)
            with open(tmp, "w") as f:
                json.dump({"winners": self._winners,
                           "coexec": self._coexec, "pins": self._pins,
                           "sweeps": self._sweeps},
                          f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except Exception as e:
            # keep tuning decisions usable in-process even when the table
            # path is unwritable (read-only FS, bad REPRO_TUNING_TABLE);
            # mirror the disk cache's soft-failure policy but stay audible
            warnings.warn(f"tuning table not persisted to {self.path!r}: "
                          f"{type(e).__name__}: {e}", RuntimeWarning)

    # -- API --------------------------------------------------------------------
    def get(self, key: str) -> Optional[str]:
        with self._lock:
            ent = self._winners.get(key)
            return ent["target"] if ent else None

    def record(self, key: str, target: str, timings_us: Dict[str, float],
               failures: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            ent = {"target": target, "timings_us": dict(timings_us)}
            if failures:
                ent["failed"] = dict(failures)
            self._winners[key] = ent
            self._save()

    def record_coexec(self, key: str, weights: Dict[str, float],
                      blend: float = 0.5) -> None:
        """Fold one launch's converged per-class split weights into the
        persisted entry.

        ``weights`` maps device class -> observed share; they are
        normalized here so the stored entry is always a distribution.
        Existing entries are blended (``blend`` is the weight of the new
        observation) rather than overwritten: per-launch noise averages
        out across launches, the ImageCL persistence idea.  Non-finite
        or non-positive totals are dropped — a persisted entry must never
        poison a warm start."""
        try:
            vals = {str(c): float(w) for c, w in weights.items()}
        except (TypeError, ValueError):
            return
        total = sum(vals.values())
        if not vals or not all(math.isfinite(w) and w >= 0
                               for w in vals.values()) or total <= 0:
            return
        vals = {c: w / total for c, w in vals.items()}
        with self._lock:
            ent = self._coexec.get(key)
            if ent and set(ent.get("weights", {})) == set(vals):
                old = ent["weights"]
                mixed = {c: blend * vals[c] + (1 - blend) * float(old[c])
                         for c in vals}
                tot = sum(mixed.values())
                vals = {c: w / tot for c, w in mixed.items()}
                launches = int(ent.get("launches", 0)) + 1
            else:
                launches = 1
            self._coexec[key] = {"weights": vals, "launches": launches}
            self._save()

    def get_coexec(self, key: str) -> Optional[Dict[str, object]]:
        """The persisted co-execution entry for ``key`` —
        ``{"weights": {class: share}, "launches": n}`` — or None."""
        with self._lock:
            ent = self._coexec.get(key)
            if ent is None:
                return None
            return {"weights": dict(ent.get("weights", {})),
                    "launches": int(ent.get("launches", 0))}

    def record_sweep(self, key: str, params: Dict[str, object],
                     timings_us: Dict[str, float]) -> None:
        """Persist one sweep's winning parameter point.

        ``params`` is the winning configuration (e.g. ``{"ts": 8,
        "unroll": 8}``), ``timings_us`` maps each swept configuration's
        canonical string to its measured time so a later reader can see
        the whole space, not just the winner.  Non-finite winner timings
        are dropped — a poisoned measurement must not become a warm
        start."""
        try:
            times = {str(c): float(t) for c, t in timings_us.items()}
        except (TypeError, ValueError):
            return
        if not times or not all(math.isfinite(t) for t in times.values()):
            return
        with self._lock:
            self._sweeps[key] = {"params": dict(params),
                                 "timings_us": times}
            self._save()

    def get_sweep(self, key: str) -> Optional[Dict[str, object]]:
        """The persisted sweep entry for ``key`` — ``{"params": {...},
        "timings_us": {config: us}}`` — or None."""
        with self._lock:
            ent = self._sweeps.get(key)
            if ent is None:
                return None
            return {"params": dict(ent.get("params", {})),
                    "timings_us": dict(ent.get("timings_us", {}))}

    def pin(self, kernel_name: str, target: str) -> None:
        with self._lock:
            self._pins[kernel_name] = target
            self._save()

    def pinned(self, kernel_name: str) -> Optional[str]:
        with self._lock:
            return self._pins.get(kernel_name)

    def clear(self) -> None:
        with self._lock:
            self._winners.clear()
            self._coexec.clear()
            self._sweeps.clear()
            self._pins.clear()
            self._save()

    def __len__(self) -> int:
        with self._lock:
            return len(self._winners)


def _runs_on(target: Optional[str], device: torch.device) -> bool:
    """Whether ``target`` is a target of this package that can launch on
    tensors of ``device`` (``cuda`` needs a CUDA device)."""
    return target in TARGETS and (target != "cuda" or device.type == "cuda")


def _timed_on(target: str, device: torch.device) -> bool:
    """Whether the tuner times ``target`` on ``device``: one that runs
    there, but not ``loop`` on a CUDA device (see the module
    docstring)."""
    return _runs_on(target, device) and not (
        target == "loop" and device.type == "cuda")


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launch_device(buffers, device) -> torch.device:
    """The device a launch runs on: ``device`` when given, else the first
    tensor's, else the CPU (numpy arrays are copied there)."""
    if device is not None:
        return torch.device(device)
    for v in buffers.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


class AutotunedKernel:
    """A launchable kernel whose target is chosen by measurement.

    Compilation of every candidate goes through the compilation cache, so
    tuning N candidates costs N cached compiles once; the steady state is
    a tuning-table lookup plus the winner's cache hit.  It launches like
    a :class:`~repro_torch.core.api.CompiledKernel`: in place over flat
    tensors (:meth:`launch_ndrange`) or over copies (``__call__``).
    """

    def __init__(self, fn: Function, build: Callable[[], Function],
                 local_size: Sequence[int],
                 options: Dict[str, object],
                 candidates: Sequence[str],
                 table: TuningTable,
                 cache: object,
                 compile_fn: Callable[..., object],
                 warmup: int = 1, repeats: int = 3,
                 device_key: str = "",
                 plan_cache: Optional[object] = None):
        self.name = fn.name
        self.device_key = device_key   # tuning decisions are per device
        # the sweep over candidate targets shares one WorkGroupPlan
        self.plan_cache = plan_cache if plan_cache is not None else cache
        self._ir = ir_hash(fn)
        self.local_size = tuple(int(x) for x in local_size)
        self.options = dict(options)
        self.candidates = tuple(candidates)
        self.table = table
        self.cache = cache
        self._compile = compile_fn        # _compile_kernel, injected
        self._build = build
        self._kernels: Dict[str, object] = {}
        self._kernels_lock = threading.Lock()
        self.warmup, self.repeats = warmup, repeats
        self.last_winner: Optional[str] = None

    # -- candidate compilation (cached) -----------------------------------------
    def kernel_for(self, target: str):
        with self._kernels_lock:
            k = self._kernels.get(target)
            if k is None:
                k = self._compile_candidate(target)
                self._kernels[target] = k
            return k

    def _compile_candidate(self, target: str):
        def compile_():
            return self._compile(self._build, self.local_size,
                                 target=target, cache=None,
                                 plan_cache=self.plan_cache, **self.options)
        if self.cache is None:
            return compile_()
        # the IR hash computed at construction keys the cache: a hit
        # costs a key build and a dict lookup, not a rebuild of the kernel
        key = CacheKey(self._ir, self.local_size, target,
                       tuple(sorted(self.options.items())))
        return self.cache.get_or_compile(key, compile_)

    # -- launch ------------------------------------------------------------------
    def launch_ndrange(self, buffers: Dict[str, torch.Tensor],
                       global_size: Sequence[int],
                       scalars: Optional[Dict[str, object]] = None,
                       group_range: Optional[Sequence[int]] = None
                       ) -> Dict[str, torch.Tensor]:
        """Launch over contiguous 1-D tensors on one device, updating them
        in place.  A first launch of a shape times the candidates on
        clones of ``buffers``, then runs the winner once on ``buffers``."""
        gsz = tuple(int(x) for x in global_size)
        dev = _launch_device(buffers, None)

        def fresh():
            flat = {k: v.clone() for k, v in buffers.items()}
            return flat, flat
        target, _ = self._select(gsz, dev, fresh, scalars, group_range)
        return self.kernel_for(target).launch_ndrange(
            buffers, gsz, scalars, group_range)

    def __call__(self, buffers: Dict[str, object],
                 global_size: Sequence[int],
                 scalars: Optional[Dict[str, object]] = None,
                 group_range: Optional[Sequence[int]] = None,
                 device=None) -> Dict[str, torch.Tensor]:
        """Launch over copies of ``buffers`` on ``device`` and return them
        as tensors (see ``CompiledKernel.__call__``)."""
        gsz = tuple(int(x) for x in global_size)
        dev = _launch_device(buffers, device)

        def fresh():
            bufs = {k: to_device(v, dev) for k, v in buffers.items()}
            return bufs, {k: v.reshape(-1) for k, v in bufs.items()}
        target, out = self._select(gsz, dev, fresh, scalars, group_range)
        if out is None:
            out, flat = fresh()
            self.kernel_for(target).launch_ndrange(flat, gsz, scalars,
                                                   group_range)
        return out

    def _select(self, gsz, dev: torch.device, fresh, scalars, group_range
                ) -> Tuple[str, Optional[Dict[str, torch.Tensor]]]:
        """The target this launch runs on, and the tuned output when the
        launch tuned (None otherwise)."""
        pinned = self.table.pinned(self.name)
        if _runs_on(pinned, dev):
            self.last_winner = pinned
            return pinned, None
        key = TuningTable.make_key(self._ir, self.local_size, gsz,
                                   sorted(self.options.items()),
                                   device=self.device_key)
        winner = self.table.get(key)
        if not _runs_on(winner, dev):
            # single-flight tuning: concurrent first launches of the same
            # shape would time candidates against each other's load and
            # race the recorded decision
            with self.table.tune_lock(key):
                winner = self.table.get(key)
                if not _runs_on(winner, dev):
                    winner, out = self._tune(key, dev, fresh, gsz, scalars,
                                             group_range)
                    self.last_winner = winner
                    return winner, out
        self.last_winner = winner
        return winner, None

    def _tune(self, key: str, dev: torch.device, fresh, gsz, scalars,
              group_range):
        """Time every candidate the tuner times on ``dev``; returns
        (winner, the winner's output).  ``fresh()`` makes the copies one
        launch runs on, outside the timed window.  A ``group_range``
        sub-launch times only the sub-range (the decision is still keyed
        on the full shape: co-executed chunks of one NDRange share the
        winner)."""
        timings: Dict[str, float] = {}
        outputs: Dict[str, object] = {}
        failures: Dict[str, str] = {}
        for target in self.candidates:
            if not _timed_on(target, dev):
                continue
            try:
                k = self.kernel_for(target)
                best = float("inf")
                for i in range(self.warmup + self.repeats):
                    out, flat = fresh()
                    _synchronize(dev)
                    t0 = time.perf_counter()
                    k.launch_ndrange(flat, gsz, scalars, group_range)
                    _synchronize(dev)
                    if i >= self.warmup:
                        best = min(best, time.perf_counter() - t0)
                    outputs[target] = out
                timings[target] = best * 1e6
            except Exception as e:
                if target == "cuda":
                    raise       # the card's kernel failed: no fallback
                # a candidate failing may be expected (target unsupported
                # for this kernel) or a real backend bug — keep it visible:
                # warn now and persist the error next to the timings
                failures[target] = f"{type(e).__name__}: {e}"
                warnings.warn(
                    f"autotuner: candidate {target!r} failed for "
                    f"{self.name!r}: {failures[target]}", RuntimeWarning)
        if not timings:
            # every candidate failed: a build failure of the kernel, not
            # a tuning decision (typed, CL_BUILD_PROGRAM_FAILURE)
            raise BuildError(
                f"autotuner: no candidate target compiled {self.name!r} "
                f"(tried {self.candidates} on {dev}): {failures}",
                build_log="\n".join(f"{t}: {msg}"
                                    for t, msg in failures.items()))
        winner = min(timings, key=timings.get)
        self.table.record(key, winner, timings, failures)
        if self.cache is not None:
            self.cache.note_tune_decision()
        return winner, outputs[winner]

    # -- introspection (mirror CompiledKernel) ------------------------------------
    def _delegate(self):
        """The compiled kernel introspection reads from: the winner or pin
        when known, else any already-compiled candidate, else the first
        candidate.  Region and context structure come from the
        target-independent pipeline half, so they agree across
        candidates."""
        pinned = self.table.pinned(self.name)
        tgt = self.last_winner or (pinned if pinned in TARGETS else None)
        if tgt is None:
            with self._kernels_lock:
                if self._kernels:
                    return next(iter(self._kernels.values()))
            tgt = self.candidates[0]
        return self.kernel_for(tgt)

    @property
    def num_regions(self) -> int:
        return self._delegate().num_regions

    @property
    def context_stats(self):
        return self._delegate().context_stats


# ---------------------------------------------------------------------------
# Process-default tuning table
# ---------------------------------------------------------------------------

_default_table: Optional[TuningTable] = None
_table_lock = threading.Lock()


def default_table() -> TuningTable:
    global _default_table
    with _table_lock:
        if _default_table is None:
            _default_table = TuningTable(
                os.environ.get("REPRO_TUNING_TABLE") or None)
        return _default_table


def set_default_table(table: Optional[TuningTable]) -> None:
    global _default_table
    with _table_lock:
        _default_table = table


__all__ = ["AutotunedKernel", "DEFAULT_CANDIDATES", "TuningTable",
           "default_table", "set_default_table"]
