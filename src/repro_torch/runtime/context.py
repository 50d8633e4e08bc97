"""First-class Context host object (OpenCL §4.4).

The port of ``repro.runtime.context``.  A :class:`Context` owns a set of
:class:`~repro_torch.runtime.platform.Device`\\ s, the **shared**
compilation/plan cache tier every program created in it specializes
through (so devices compiling the same kernel share one region-formation
run), and a size-class :class:`~repro_torch.runtime.memory.BufferPool`
per device.  The flow mirrors OpenCL end to end::

    ctx  = Context()                                   # clCreateContext
    prog = ctx.create_program(build_fn).build()        # clBuildProgram
    k    = prog.create_kernel("scale")                 # clCreateKernel
    buf  = ctx.create_buffer(1024, "float32")          # clCreateBuffer
    k.set_args(x=buf, s=2.0)                           # clSetKernelArg
    q    = ctx.create_queue(out_of_order=True)         # clCreateCommandQueue
    q.enqueue_nd_range(k, (1024,), (64,))              # clEnqueueNDRangeKernel
    q.finish()                                         # clFinish

Buffers live in device memory and kernels launch in place on them
(:mod:`repro_torch.runtime.queue`).  :meth:`Context.launch` is the
direct path for kernels bound to host arrays: it accepts numpy arrays or
tensors, copies them onto the device (the caller's arrays stay untouched,
as in the functional reference) and returns the buffers as tensors on the
device.  The same ``Kernel`` object also drives multi-device
co-execution (``ctx.create_co_executor(...).launch(k, ...)``, returning
the merged buffers on the host) with bitwise-identical results.
:meth:`Context.trace` records the context's queues as a Chrome trace.
The serving engine takes its dispatch DAG and KV page pool from a
context too.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import torch

from ..core.cache import CompilationCache
from ..core.errors import (BuildError, InvalidArgError, InvalidBufferError,
                           MapError, ReproError, status_name)
from ..core.ir import Function
from ..core.program import Kernel, Program
from .memory import BufferPool
from .platform import Buffer, Device, Platform, create_buffer
from .queue import CommandQueue
from .scheduler import CoExecutor
from .trace import ChromeTrace

__all__ = [
    "Context", "default_context",
    # the status hierarchy a context's operations raise, re-exported so
    # host code can catch without reaching into repro_torch.core
    "ReproError", "InvalidArgError", "InvalidBufferError", "BuildError",
    "MapError", "status_name",
]


class Context:
    """cl_context analogue: devices + a shared plan/compilation tier.

    ``devices`` defaults to every device of ``platform``, which defaults
    to ``Platform()`` — the CUDA devices.  An explicit device list is a
    fixed scope (using another device is CL_INVALID_DEVICE); a
    platform-spanning context adopts devices the platform grows later
    (``co_devices``)."""

    #: smallest size class of the per-device buffer pools
    pool_min_class = 256

    def __init__(self, devices: Optional[Sequence[Device]] = None,
                 platform: Optional[Platform] = None):
        self.platform = platform if platform is not None else Platform()
        self._explicit_devices = devices is not None
        self.devices: List[Device] = (list(devices)
                                      if devices is not None
                                      else self.platform.get_devices())
        if not self.devices:
            raise InvalidArgError("Context needs at least one device")
        self.cache = CompilationCache.from_env()
        # one pool per (device, size class floor): a caller asking for a
        # specific min_class (the serving engine's KV blocks) gets its
        # own free lists and stats
        self._pools: Dict[tuple, BufferPool] = {}
        # queues are tracked weakly: release() drains the live ones, but
        # the context (often the immortal default_context) must never
        # pin a dropped queue's worker threads against GC
        self._queues: "weakref.WeakSet[CommandQueue]" = weakref.WeakSet()
        # active ChromeTrace while inside a `with ctx.trace()` window:
        # queues created during the window attach themselves on creation
        self._trace: Optional[ChromeTrace] = None
        self._lock = threading.Lock()

    def _check_device(self, device: Optional[Device], what: str) -> Device:
        if device is None:
            return self.devices[0]
        with self._lock:
            if device in self.devices:
                return device
            if not self._explicit_devices and \
                    device in self.platform.devices:
                self.devices.append(device)
                return device
        raise InvalidArgError(
            f"{what}: device {device.info.name!r} is not part of "
            f"this context (CL_INVALID_DEVICE); context devices: "
            f"{[d.info.name for d in self.devices]}")

    def create_program(self, *builders: Callable[[], Function],
                       **options) -> Program:
        """clCreateProgramWithSource: a :class:`Program` over one or
        more IR builders, sharing this context's plan tier.  ``options``
        are the build options (``horizontal``, ``merge_uniform``,
        ``use_vml``)."""
        return Program(builders, context=self, **options)

    def pool_for(self, device: Optional[Device] = None,
                 min_class: Optional[int] = None) -> BufferPool:
        """The context's size-class pool over ``device``'s arena for the
        given ``min_class`` floor (default: the context's), created
        lazily, one per (device, min_class)."""
        device = self._check_device(device, "pool_for")
        mc = min_class or self.pool_min_class
        with self._lock:
            pool = self._pools.get((device, mc))
            if pool is None:
                pool = BufferPool(device.allocator, min_class=mc)
                self._pools[(device, mc)] = pool
            return pool

    def create_buffer(self, n_elems: int, dtype: str = "float32",
                      device: Optional[Device] = None,
                      pooled: bool = True) -> Buffer:
        """clCreateBuffer with typed validation: rejects zero/negative
        element counts and unknown dtypes with
        :class:`~repro_torch.core.errors.InvalidBufferError` before the
        arena is touched.  ``pooled=True`` (default) serves the chunk
        from the context's per-device size-class pool, and the
        allocation is *lazy*: the chunk and the device tensor
        materialize on first real use, so an intermediate elided by the
        queue's fusion rewrite never allocates."""
        device = self._check_device(device, "create_buffer")
        return create_buffer(device, n_elems, dtype,
                             pool=self.pool_for(device) if pooled
                             else None,
                             lazy=pooled)

    def create_queue(self, device: Optional[Device] = None,
                     out_of_order: bool = False, workers: int = 2,
                     fusion: str = "flush") -> CommandQueue:
        """clCreateCommandQueue on a context device.  ``fusion`` sets the
        queue's DAG-fusion mode (``"off"`` | ``"flush"`` | ``"eager"``)."""
        device = self._check_device(device, "create_queue")
        q = CommandQueue(device, out_of_order=out_of_order,
                         workers=workers, fusion=fusion)
        with self._lock:
            self._queues.add(q)
            tr = self._trace
        if tr is not None:
            tr.attach_queue(q)
        return q

    @contextlib.contextmanager
    def trace(self, tr: Optional[ChromeTrace] = None) \
            -> Iterator[ChromeTrace]:
        """Record every command on this context's queues as a Chrome
        trace::

            with ctx.trace() as tr:
                q.enqueue_nd_range(k, (1024,), (64,))
                q.finish()
            tr.export("out.json")       # load in chrome://tracing

        Existing queues and queues created inside the window are both
        attached; on exit collection stops but the recorded events stay
        on ``tr`` for export.  Pass a :class:`ChromeTrace` to accumulate
        several windows into one file."""
        tr = tr or ChromeTrace()
        with self._lock:
            self._trace = tr
            queues = list(self._queues)
        for q in queues:
            tr.attach_queue(q)
        try:
            yield tr
        finally:
            with self._lock:
                self._trace = None
            tr.detach_all()

    def create_co_executor(self, devices: Optional[Sequence[Device]] = None,
                           chunks_per_device: int = 4,
                           tuning_table=None,
                           min_chunk_groups: int = 1,
                           hguided_divisor: float = 2.0,
                           ewma_alpha: float = 0.5) -> CoExecutor:
        """A multi-device :class:`~repro_torch.runtime.scheduler.
        CoExecutor` over ``devices`` (default: every context device;
        given devices are scope-checked like every other context
        factory) — any number of heterogeneous devices, each
        specializing kernels through the context's shared plan tier.
        Its :meth:`~repro_torch.runtime.scheduler.CoExecutor.launch`
        consumes the same :class:`~repro_torch.core.program.Kernel`
        objects queues do; the keyword arguments configure the
        ``steal`` and ``adaptive`` scheduling modes."""
        if devices is not None:
            devices = [self._check_device(d, "create_co_executor")
                       for d in devices]
        return CoExecutor(devices if devices is not None else self.devices,
                          chunks_per_device=chunks_per_device,
                          tuning_table=tuning_table,
                          min_chunk_groups=min_chunk_groups,
                          hguided_divisor=hguided_divisor,
                          ewma_alpha=ewma_alpha)

    def pool_stats(self) -> Dict[str, Dict[str, int]]:
        """Counters per pool, keyed ``"<device>[:<min_class>]"`` (the
        suffix appears for non-default class floors)."""
        with self._lock:
            out = {}
            for (d, mc), p in self._pools.items():
                key = d.info.name if mc == self.pool_min_class \
                    else f"{d.info.name}:{mc}"
                out[key] = p.stats()
            return out

    def launch(self, kernel: Kernel, global_size: Sequence[int],
               local_size: Sequence[int],
               device: Optional[Device] = None,
               target: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """Synchronous-looking single-device launch over *host-array*
        arguments: specializes ``kernel`` for ``(device, local_size,
        target)`` through the device cache, runs it over device copies of
        the bound arrays or tensors, and returns them as tensors on the
        device.  (A ``cuda`` launch is asynchronous: the tensors are
        ready once the stream reaches them.)  Device-resident
        :class:`Buffer` arguments belong on a queue
        (``create_queue().enqueue_nd_range``)."""
        device = self._check_device(device, "launch")
        buffers, scalars = kernel.launch_args(accept=("host",))
        binary = kernel.bind(device, local_size, target=target)
        return binary(buffers, tuple(global_size), scalars,
                      device=device.torch_device)

    def cache_stats(self) -> Dict[str, Dict[str, int]]:
        """Shared-tier + per-device compilation-cache counters."""
        stats = {"context": self.cache.stats.as_dict()}
        for d in self.devices:
            stats[d.info.name] = d.cache_stats()
        return stats

    def release(self, timeout: Optional[float] = 30.0) -> None:
        """clReleaseContext analogue for the resources the context
        parks: drain and drop every queue created through
        :meth:`create_queue` (command failures are not re-raised here —
        read them off the events before releasing if they matter), and
        trim every pool back to its arena.  Buffers the caller still
        holds stay valid."""
        with self._lock:
            queues = list(self._queues)
            self._queues = weakref.WeakSet()
            pools = list(self._pools.values())
        for q in queues:
            try:
                q.finish(timeout=timeout)
            except Exception:
                pass  # failed/stuck commands must not block release
        for p in pools:
            p.trim()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"<Context devices="
                f"{[d.info.name for d in self.devices]}>")


# ---------------------------------------------------------------------------
# Process-default context (lazy singleton)
# ---------------------------------------------------------------------------

_default_context: Optional[Context] = None
_ctx_lock = threading.Lock()


def default_context() -> Context:
    """The process-default :class:`Context` over ``Platform()`` (the CUDA
    devices; raises DeviceNotFoundError without one) — subsystems that
    need *a* context, such as the serving engine when none is passed,
    share this one."""
    global _default_context
    with _ctx_lock:
        if _default_context is None:
            _default_context = Context()
        return _default_context
