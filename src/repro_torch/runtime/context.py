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
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..core.cache import CompilationCache
from ..core.errors import (BuildError, InvalidArgError, ReproError,
                           status_name)
from ..core.ir import Function
from ..core.program import Kernel, Program
from .platform import Device, Platform

__all__ = [
    "Context",
    # the status hierarchy a context's operations raise, re-exported so
    # host code can catch without reaching into repro_torch.core
    "ReproError", "InvalidArgError", "BuildError", "status_name",
]


class Context:
    """cl_context analogue: devices + a shared plan/compilation tier.

    ``devices`` defaults to every device of ``platform``, which defaults
    to ``Platform()`` — the CUDA devices."""

    def __init__(self, devices: Optional[Sequence[Device]] = None,
                 platform: Optional[Platform] = None):
        self.platform = platform if platform is not None else Platform()
        self.devices: List[Device] = (list(devices)
                                      if devices is not None
                                      else self.platform.get_devices())
        if not self.devices:
            raise InvalidArgError("Context needs at least one device")
        self.cache = CompilationCache.from_env()

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
