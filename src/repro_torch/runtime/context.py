"""First-class Context host object (OpenCL §4.4).

The trimmed port of ``repro.runtime.context``.  A :class:`Context` owns a
set of :class:`~repro_torch.runtime.platform.Device`\\ s and the
**shared** compilation/plan cache tier every program created in it
specializes through, so devices compiling the same kernel share one
region-formation run::

    ctx  = Context()                                   # clCreateContext
    prog = ctx.create_program(build_fn).build()        # clBuildProgram
    k    = prog.create_kernel("scale")                 # clCreateKernel
    k.set_args(x=x, s=2.0)                             # clSetKernelArg
    out  = ctx.launch(k, (1024,), (64,))               # NDRange launch

:meth:`Context.launch` accepts numpy arrays or tensors, copies them onto
the device (the caller's arrays stay untouched, as in the functional
reference) and returns the buffers as tensors on the device.

The context also hands out command queues (:meth:`Context.create_queue`)
and per-device size-class buffer pools (:meth:`Context.pool_for`): the
serving engine's dispatch DAG and KV page pool.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..core.cache import CompilationCache
from ..core.errors import (BuildError, InvalidArgError, ReproError,
                           status_name)
from ..core.ir import Function
from ..core.program import Kernel, Program
from .memory import BufferPool
from .platform import Device, Platform
from .queue import CommandQueue

__all__ = [
    "Context", "default_context",
    # the status hierarchy a context's operations raise, re-exported so
    # host code can catch without reaching into repro_torch.core
    "ReproError", "InvalidArgError", "BuildError", "status_name",
]


class Context:
    """cl_context analogue: devices + a shared plan/compilation tier.

    ``devices`` defaults to every device of ``platform``, which defaults
    to ``Platform()`` — the CUDA devices."""

    #: smallest size class of the per-device buffer pools
    pool_min_class = 256

    def __init__(self, devices: Optional[Sequence[Device]] = None,
                 platform: Optional[Platform] = None):
        self.platform = platform if platform is not None else Platform()
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
        self._lock = threading.Lock()

    def _check_device(self, device: Optional[Device], what: str) -> Device:
        if device is None:
            return self.devices[0]
        if device in self.devices:
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

    def create_queue(self, device: Optional[Device] = None,
                     out_of_order: bool = False, workers: int = 2,
                     fusion: str = "flush") -> CommandQueue:
        """clCreateCommandQueue on a context device."""
        device = self._check_device(device, "create_queue")
        return CommandQueue(device, out_of_order=out_of_order,
                            workers=workers, fusion=fusion)

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
        """Synchronous-looking single-device launch: specializes
        ``kernel`` for ``(device, local_size, target)`` through the device
        cache, runs it over device copies of the bound buffers, and
        returns them as tensors on the device.  (A ``cuda`` launch is
        asynchronous: the tensors are ready once the stream reaches
        them.)"""
        device = self._check_device(device, "launch")
        buffers, scalars = kernel.launch_args()
        binary = kernel.bind(device, local_size, target=target)
        return binary(buffers, tuple(global_size), scalars,
                      device=device.torch_device)

    def cache_stats(self) -> Dict[str, Dict[str, int]]:
        """Shared-tier + per-device compilation-cache counters."""
        stats = {"context": self.cache.stats.as_dict()}
        for d in self.devices:
            stats[d.info.name] = d.cache_stats()
        return stats

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
