"""OpenCL-shaped host layer: Platform / Device (paper §3, Fig. 2).

The trimmed port of ``repro.runtime.platform``.  Device-specific behaviour
lives behind the device-layer interface, mirroring pocl's driver split:

  ``cuda``    — the H100: CUDA C work-group functions (cuda target)
  ``vector``  — vectorized work-groups in torch (vector target)
  ``basic``   — serial work-item loops in torch (loop target)

``Platform()`` enumerates the ``torch.cuda`` devices and gives each one a
device of every driver; the vector and basic devices run on the same
torch device as the cuda one.  With no CUDA device it raises
:class:`DeviceNotFoundError` rather than quietly using the CPU; tests ask
for the CPU explicitly with ``Platform(torch_device="cpu")``, which has
vector and basic devices only.

Device queries (global memory size, max work-group size, …) come from
``torch.cuda.get_device_properties`` for a CUDA device.  Every device
owns a :class:`~repro_torch.core.cache.CompilationCache` and an
``allocator``, a :class:`~repro_torch.runtime.bufalloc.Bufalloc` arena
over its global memory size (the book-keeping the serving engine pages
its KV cache from).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

from ..core.api import CompiledKernel, _compile_kernel
from ..core.cache import CompilationCache
from ..core.errors import InvalidArgError, ReproError, register_error
from ..core.ir import Function
from .bufalloc import Bufalloc


@register_error
class DeviceNotFoundError(ReproError, RuntimeError):
    """No device of the requested kind (CL_DEVICE_NOT_FOUND)."""

    code = -1
    code_name = "CL_DEVICE_NOT_FOUND"


@dataclasses.dataclass
class DeviceInfo:
    name: str
    driver: str                 # cuda | vector | basic
    global_mem_size: int
    local_mem_size: int
    max_work_group_size: int
    compute_units: int
    # CL_DEVICE_MEM_BASE_ADDR_ALIGN, in *bytes* (OpenCL reports bits)
    mem_base_addr_align: int = 4


_TARGET_OF_DRIVER = {"cuda": "cuda", "vector": "vector", "basic": "loop"}


class Device:
    """Device-layer object (cl_device_id analogue): a driver kind on one
    torch device, with a private compilation cache.  The target is the
    driver's (``cuda``→cuda, ``vector``→vector, ``basic``→loop)."""

    def __init__(self, info: DeviceInfo,
                 torch_device: Union[str, torch.device]):
        if info.driver not in _TARGET_OF_DRIVER:
            raise InvalidArgError(f"unknown driver {info.driver!r}")
        self.info = info
        self.torch_device = torch.device(torch_device)
        self._target = _TARGET_OF_DRIVER[info.driver]
        # per-device compilation cache; the disk tier activates when
        # REPRO_KERNEL_CACHE_DIR is set
        self.compile_cache = CompilationCache.from_env()
        self.allocator = Bufalloc(info.global_mem_size, greedy=True)

    def compile(self, build: Callable[[], Function],
                local_size: Sequence[int], **opts) -> CompiledKernel:
        """Device-layer compilation: run the pocl pipeline for
        ``local_size`` on the device's target (or ``opts["target"]``),
        memoized in the device cache.  The ``cuda`` target needs a CUDA
        device; asking for it elsewhere raises
        :class:`~repro_torch.core.errors.InvalidArgError`."""
        opts.setdefault("cache", self.compile_cache)
        opts.setdefault("target", self._target)
        if opts["target"] == "cuda" and self.torch_device.type != "cuda":
            raise InvalidArgError(
                f"target 'cuda' needs a CUDA device; device "
                f"{self.info.name!r} is on {self.torch_device}")
        return _compile_kernel(build, local_size, **opts)

    def cache_stats(self) -> Dict[str, int]:
        """Compilation-cache counters for this device."""
        return self.compile_cache.stats.as_dict()

    def query(self, what: str):
        return getattr(self.info, what)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<Device {self.info.name} on {self.torch_device}>"


def _cuda_info(index: int, driver: str, name: str) -> DeviceInfo:
    props = torch.cuda.get_device_properties(index)
    return DeviceInfo(
        name=name, driver=driver,
        global_mem_size=int(props.total_memory),
        local_mem_size=int(getattr(props, "shared_memory_per_block_optin",
                                   getattr(props, "shared_memory_per_block",
                                           48 * 1024))),
        max_work_group_size=int(getattr(props, "max_threads_per_block",
                                        1024)),
        compute_units=int(props.multi_processor_count))


def _cpu_info(driver: str, name: str) -> DeviceInfo:
    return DeviceInfo(name=name, driver=driver, global_mem_size=1 << 30,
                      local_mem_size=1 << 20, max_work_group_size=1024,
                      compute_units=os.cpu_count() or 1)


class Platform:
    """clGetPlatformIDs analogue.

    ``torch_device=None`` enumerates every CUDA device (raising
    :class:`DeviceNotFoundError` when there is none); a given torch device
    (``"cpu"``, ``"cuda:1"``) gets that one only."""

    def __init__(self, torch_device: Union[str, torch.device, None] = None):
        if torch_device is None:
            if not torch.cuda.is_available():
                raise DeviceNotFoundError(
                    "no CUDA device: torch.cuda.is_available() is false; "
                    "pass torch_device='cpu' to use the torch targets on "
                    "the CPU")
            tdevs = [torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())]
        else:
            tdevs = [torch.device(torch_device)]
        self.devices: List[Device] = []
        for td in tdevs:
            if td.type == "cuda":
                if not torch.cuda.is_available():
                    raise DeviceNotFoundError(f"no CUDA device for {td}")
                idx = td.index if td.index is not None else 0
                td = torch.device("cuda", idx)
                for drv in ("cuda", "vector", "basic"):
                    self.devices.append(Device(
                        _cuda_info(idx, drv, f"repro-{drv}-cuda{idx}"), td))
            else:
                for drv in ("vector", "basic"):
                    self.devices.append(Device(
                        _cpu_info(drv, f"repro-{drv}-{td.type}"), td))

    def get_devices(self, driver: Optional[str] = None) -> List[Device]:
        """clGetDeviceIDs: all devices, or those of one driver kind."""
        if driver is None:
            return list(self.devices)
        return [d for d in self.devices if d.info.driver == driver]

    def cache_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-device compilation-cache counters, keyed by device name."""
        return {d.info.name: d.cache_stats() for d in self.devices}


__all__ = ["Device", "DeviceInfo", "DeviceNotFoundError", "Platform"]
