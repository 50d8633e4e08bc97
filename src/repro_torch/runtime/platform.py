"""OpenCL-shaped host layer: Platform / Device / Buffer (paper §3, Fig. 2).

The port of ``repro.runtime.platform``.  Device-specific behaviour lives
behind the device-layer interface, mirroring pocl's device kinds:

  ``cuda``    — the H100: CUDA C work-group functions (cuda target)
  ``vector``  — vectorized work-groups in torch (vector target)
  ``basic``   — serial work-item loops in torch (loop target)
  ``auto``    — the target picked per kernel shape by the autotuner
                (:mod:`repro_torch.core.autotune`)

``Platform()`` enumerates the ``torch.cuda`` devices and gives each one a
device of every driver; the vector, basic and auto devices run on the
same torch device as the cuda one.  With no CUDA device it raises
:class:`DeviceNotFoundError` rather than quietly using the CPU; tests ask
for the CPU explicitly with ``Platform(torch_device="cpu")``, which has
vector, basic and auto devices.  :meth:`Platform.co_devices` makes fresh
devices for multi-device co-execution (:mod:`repro_torch.runtime.
scheduler`), and :class:`ThrottledDevice` models a slower member of a
lopsided platform.

Device queries (global memory size, max work-group size, …) come from
``torch.cuda.get_device_properties`` for a CUDA device.  Every device
owns a :class:`~repro_torch.core.cache.CompilationCache` and an
``allocator``, a :class:`~repro_torch.runtime.bufalloc.Bufalloc` arena
over its global memory size: the book-keeping of its buffers (and of the
serving engine's KV pages).

A :class:`Buffer` (``cl_mem``) lives in its device's memory: its payload
is a flat 1-D tensor on ``device.torch_device``, not a host mirror, and
kernel launches update it in place.  Pooled context buffers are lazy:
neither the arena chunk nor the tensor exists before first real use.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core.api import CompiledKernel, _compile_kernel, to_device
from ..core.cache import CompilationCache
from ..core.errors import (InvalidArgError, InvalidBufferError, ReproError,
                           register_error)
from ..core.ir import Function
from .bufalloc import Bufalloc, Chunk


@register_error
class DeviceNotFoundError(ReproError, RuntimeError):
    """No device of the requested kind (CL_DEVICE_NOT_FOUND)."""

    code = -1
    code_name = "CL_DEVICE_NOT_FOUND"


@dataclasses.dataclass
class DeviceInfo:
    name: str
    driver: str                 # cuda | vector | basic | auto
    global_mem_size: int
    local_mem_size: int
    max_work_group_size: int
    compute_units: int
    # CL_DEVICE_MEM_BASE_ADDR_ALIGN, in *bytes* (OpenCL reports bits)
    mem_base_addr_align: int = 4


_TARGET_OF_DRIVER = {"cuda": "cuda", "vector": "vector", "basic": "loop",
                     "auto": "auto"}


class Device:
    """Device-layer object (cl_device_id analogue): a driver kind on one
    torch device, with a private compilation cache.  The target is the
    driver's (``cuda``→cuda, ``vector``→vector, ``basic``→loop,
    ``auto``→autotuned)."""

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
        :class:`~repro_torch.core.errors.InvalidArgError`.  Autotuned
        kernels key their tuning decisions by the device's name, so
        co-executing heterogeneous devices measure independently."""
        opts.setdefault("cache", self.compile_cache)
        opts.setdefault("device_key", self.info.name)
        opts.setdefault("target", self._target)
        if opts["target"] == "cuda" and self.torch_device.type != "cuda":
            raise InvalidArgError(
                f"target 'cuda' needs a CUDA device; device "
                f"{self.info.name!r} is on {self.torch_device}")
        return _compile_kernel(build, local_size, **opts)

    def build_kernel(self, build: Callable[[], Function],
                     local_size: Sequence[int], **opts) -> CompiledKernel:
        """Deprecated host entry point (clBuildProgram + clCreateKernel in
        one call).  Use ``Context.create_program(build)`` and specialize
        through :class:`~repro_torch.core.program.Kernel` objects instead;
        this shim delegates to the same device-cache compilation."""
        warnings.warn(
            "Device.build_kernel() is deprecated; use Context."
            "create_program(build).create_kernel(name) and enqueue the "
            "Kernel object", DeprecationWarning, stacklevel=2)
        return self.compile(build, local_size, **opts)

    def cache_stats(self) -> Dict[str, int]:
        """Compilation-cache counters for this device."""
        return self.compile_cache.stats.as_dict()

    def query(self, what: str):
        return getattr(self.info, what)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<Device {self.info.name} on {self.torch_device}>"


class ThrottledDevice(Device):
    """A device that models a slower — or intermittently busy — member
    of a lopsided platform (the benchmark and test double for N-device
    asymmetric co-execution).

    Kernels compiled on a ThrottledDevice run the *real* computation on
    its torch device (results stay bitwise-identical to any other device)
    and then charge simulated time: ``seconds_per_group`` for every
    work-group in the executed range, plus any one-shot delay armed with
    :meth:`stall` (another tenant briefly hogging the device).  The
    charged time lands inside the chunk command, so it shows up in the
    event profiling counters exactly like real execution time — which is
    what the co-execution throughput model measures.

    With ``window_chunks=True`` (the default) a ``group_range``
    sub-launch runs the *full-range* kernel over clones of the buffers
    and copies the chunk's linearized element span back, as the
    reference does to spare itself a trace per span.  That is exact for
    kernels whose work-group ``g`` writes exactly its own linearized
    element span (elementwise kernels); pass ``window_chunks=False`` to
    run the ``group_range`` sub-launch itself.

    ``coexec_class`` (default ``"<driver>-throttled"``) is the
    device-class key the scheduler persists split weights under — give
    fast and slow wrappers different classes so their learned weights
    never alias.  ``sleep`` is injectable so tests can run simulated
    platforms in virtual time.
    """

    def __init__(self, info: DeviceInfo,
                 torch_device: Union[str, torch.device],
                 seconds_per_group: float = 0.0,
                 coexec_class: Optional[str] = None,
                 sleep: Optional[Callable[[float], None]] = None,
                 window_chunks: bool = True):
        super().__init__(info, torch_device)
        self.seconds_per_group = float(seconds_per_group)
        self.coexec_class = coexec_class or f"{info.driver}-throttled"
        self._sleep = sleep if sleep is not None else time.sleep
        self.window_chunks = bool(window_chunks)
        self._stall_s = 0.0
        self._stall_lock = threading.Lock()

    def stall(self, seconds: float) -> None:
        """Arm a one-shot delay charged to the next kernel execution on
        this device."""
        with self._stall_lock:
            self._stall_s += float(seconds)

    def _consume_stall(self) -> float:
        with self._stall_lock:
            s, self._stall_s = self._stall_s, 0.0
            return s

    def compile(self, build: Callable[[], Function],
                local_size: Sequence[int], **opts) -> "_ThrottledKernel":
        inner = super().compile(build, local_size, **opts)
        return _ThrottledKernel(inner, self,
                                tuple(int(x) for x in local_size))


class _ThrottledKernel:
    """Launchable proxy that charges its ThrottledDevice's simulated
    time per executed work-group (plus any armed stall) after running
    the real kernel."""

    def __init__(self, kernel, device: ThrottledDevice,
                 local_size: Sequence[int]):
        self._kernel = kernel
        self._device = device
        self._local = tuple(local_size)

    def __getattr__(self, name):
        return getattr(self._kernel, name)

    def _window(self, buffers, global_size, scalars, lo, hi) -> None:
        """Execute groups ``[lo, hi)`` by windowing a full-range launch
        over clones: bitwise-identical to a real ``group_range``
        sub-launch for kernels whose group ``g`` writes its own
        linearized element span."""
        full = {k: v.clone() for k, v in buffers.items()}
        self._kernel.launch_ndrange(full, global_size, scalars)
        L = 1
        for x in self._local:
            L *= max(1, int(x))
        for nm, t in buffers.items():
            t[lo * L:hi * L] = full[nm][lo * L:hi * L]

    def launch_ndrange(self, buffers: Dict[str, torch.Tensor],
                       global_size: Sequence[int], scalars=None,
                       group_range=None) -> Dict[str, torch.Tensor]:
        d = self._device
        if group_range is not None:
            lo, hi = int(group_range[0]), int(group_range[1])
            groups = max(0, hi - lo)
            if d.window_chunks:
                self._window(buffers, global_size, scalars, lo, hi)
            else:
                self._kernel.launch_ndrange(buffers, global_size, scalars,
                                            group_range)
        else:
            self._kernel.launch_ndrange(buffers, global_size, scalars)
            gsz = tuple(global_size) + (1,) * (3 - len(global_size))
            lsz = self._local + (1,) * (3 - len(self._local))
            groups = 1
            for g, l in zip(gsz, lsz):
                groups *= max(1, g // max(1, l))
        delay = d._consume_stall() + groups * d.seconds_per_group
        if delay > 0:
            d._sleep(delay)
        return buffers

    def __call__(self, buffers, global_size, scalars=None,
                 group_range=None, device=None) -> Dict[str, torch.Tensor]:
        """Launch over copies of ``buffers`` (see
        ``CompiledKernel.__call__``)."""
        bufs = {k: to_device(v, device) for k, v in buffers.items()}
        self.launch_ndrange({k: v.reshape(-1) for k, v in bufs.items()},
                            global_size, scalars, group_range)
        return bufs


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


def _device_info(td: torch.device, driver: str, name: str) -> DeviceInfo:
    return _cuda_info(td.index, driver, name) if td.type == "cuda" \
        else _cpu_info(driver, name)


def _tag(td: torch.device) -> str:
    """The torch device's part of a device name: ``cuda0``, ``cpu``."""
    return f"cuda{td.index}" if td.type == "cuda" else td.type


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
        self.torch_devices: List[torch.device] = []
        for td in tdevs:
            if td.type == "cuda":
                if not torch.cuda.is_available():
                    raise DeviceNotFoundError(f"no CUDA device for {td}")
                td = torch.device("cuda", td.index or 0)
                drivers = ("cuda", "vector", "basic", "auto")
            else:
                drivers = ("vector", "basic", "auto")
            self.torch_devices.append(td)
            for drv in drivers:
                self.devices.append(Device(
                    _device_info(td, drv, f"repro-{drv}-{_tag(td)}"), td))
        self._co_ids = itertools.count()

    def get_devices(self, driver: Optional[str] = None) -> List[Device]:
        """clGetDeviceIDs: all devices, or those of one driver kind."""
        if driver is None:
            return list(self.devices)
        return [d for d in self.devices if d.info.driver == driver]

    def co_devices(self, n: int, driver: str = "vector") -> List[Device]:
        """Create ``n`` fresh devices of ``driver`` for multi-device
        co-execution, on the platform's (first) torch device: on a card,
        ``co_devices(2, driver="cuda")`` gives two ``cuda`` devices of
        the one H100.  Each owns its own allocator and compilation
        cache, and a name no other device of the platform has; the
        devices are appended to :attr:`devices` so ``cache_stats`` (and
        a platform-spanning :class:`~repro_torch.runtime.context.
        Context`) sees them."""
        td = self.torch_devices[0]
        if driver not in _TARGET_OF_DRIVER:
            raise InvalidArgError(f"unknown driver {driver!r}")
        if driver == "cuda" and td.type != "cuda":
            raise InvalidArgError(
                f"driver 'cuda' needs a CUDA device; this platform is on "
                f"{td}")
        out = [Device(_device_info(
            td, driver, f"repro-co-{driver}-{next(self._co_ids)}"), td)
            for _ in range(n)]
        self.devices.extend(out)
        return out

    def cache_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-device compilation-cache counters, keyed by device name."""
        return {d.info.name: d.cache_stats() for d in self.devices}




def _torch_dtype(dtype) -> torch.dtype:
    """The torch dtype holding a buffer of numpy dtype ``dtype``."""
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def copy_into(dst: torch.Tensor, value, dtype) -> None:
    """Copy ``value`` (an array or tensor, any shape, ``dst.numel()``
    elements) into the flat tensor ``dst`` in place, converting it to
    ``dtype`` as ``np.asarray(value, dtype)`` would."""
    if isinstance(value, torch.Tensor):
        src = value.reshape(-1)
    else:
        src = torch.from_numpy(np.ascontiguousarray(
            np.asarray(value, dtype=dtype)).reshape(-1))
    if src.numel() != dst.numel():
        raise InvalidBufferError(
            f"cannot copy {src.numel()} elements into a buffer span of "
            f"{dst.numel()}")
    dst.copy_(src)


class Buffer:
    """A device buffer (cl_mem analogue) backed by a Bufalloc chunk plus
    its payload: a flat tensor of ``n_elems`` on ``device.torch_device``,
    which kernel launches update in place.

    The hierarchical-memory subsystem (:mod:`repro_torch.runtime.memory`)
    extends every buffer with

    * **view bookkeeping** — :attr:`origin`/:attr:`root` let sub-buffer
      views and the root share one identity for residency and mapping;
    * **residency binding** — :meth:`bind_residency` attaches a
      :class:`~repro_torch.runtime.bufalloc.ResidencyTracker`, after
      which any write through the buffer *or any aliased view of it*
      invalidates the overlapping span of every other device's copy;
    * **map bookkeeping** — active :class:`~repro_torch.runtime.memory.
      MappedRegion`\\ s are registered on the root so overlapping write
      maps (and kernel launches over mapped buffers) are rejected.
    """

    def __init__(self, device: Device, size_bytes: int, dtype: str,
                 n_elems: int, pool=None, lazy: bool = False):
        self.device = device
        # a pool-backed buffer draws its chunk from (and releases it to)
        # a size-class BufferPool over the device arena instead of the
        # raw first-fit allocator (Context.create_buffer does this)
        self._pool = pool
        self._size_bytes = size_bytes
        self.dtype = np.dtype(dtype).name
        self.itemsize = np.dtype(dtype).itemsize
        self.n_elems = n_elems
        self.nbytes = n_elems * self.itemsize
        self.origin = 0                       # byte offset within root
        # a lazy buffer defers both the chunk and the tensor until first
        # real use, so a fusion-elided intermediate that is only ever the
        # stitched-away link of a chain never touches device memory; the
        # lock keeps two workers' first uses from making two tensors
        self.chunk: Optional[Chunk] = None
        self._data: Optional[torch.Tensor] = None
        self._alloc_lock = threading.Lock()
        if not lazy:
            self._materialize()
        # residency binding (None until bind_residency)
        self._tracker = None
        self._res_key = None
        self._res_dev = None
        # map bookkeeping (root buffers only)
        self._maps: List[object] = []         # active MappedRegions
        self._map_lock = threading.Lock()
        # optional read-back hook run by READ maps before their copy to
        # the host (e.g. pull the canonical copy of a shared buffer);
        # MAP_WRITE_INVALIDATE skips it, and the copy with it
        self.on_map_sync: Optional[Callable[[int, int], None]] = None

    @property
    def root(self) -> "Buffer":
        """The underlying root allocation (self for non-view buffers)."""
        return self

    # -- lazy materialization ---------------------------------------------------
    @property
    def materialized(self) -> bool:
        """True once the device chunk and tensor exist.  Lazy buffers
        (``Context.create_buffer(pooled=True)``) stay unmaterialized
        until the first real use; an elided fusion intermediate is
        *never* real use, so its ``bytes_elided`` are genuinely saved."""
        return self._data is not None

    def _materialize(self) -> None:
        if self._data is not None:
            return
        with self._alloc_lock:
            if self._data is not None:
                return
            if self.chunk is None:
                self.chunk = (self._pool.alloc(self._size_bytes)
                              if self._pool is not None
                              else self.device.allocator.alloc(
                                  self._size_bytes))
            self._data = torch.zeros(self.n_elems,
                                     dtype=_torch_dtype(self.dtype),
                                     device=self.device.torch_device)

    @property
    def data(self) -> torch.Tensor:
        """The payload tensor on the device; touching it is 'first real
        use' and materializes a lazy buffer."""
        self._materialize()
        return self._data

    @data.setter
    def data(self, value) -> None:
        """Write ``value`` (an array or tensor of ``n_elems`` elements)
        into the payload in place."""
        copy_into(self.data, value, self.dtype)

    # -- residency ------------------------------------------------------------
    def bind_residency(self, tracker, key, device_key) -> None:
        """Attach a ResidencyTracker: from now on every write through
        this buffer or any of its views calls ``tracker.wrote_span`` for
        exactly the written byte span, invalidating other device copies
        at sub-buffer granularity."""
        self._tracker = tracker
        self._res_key = key
        self._res_dev = device_key

    def mark_written_span(self, lo: int, hi: int) -> None:
        """Record that bytes ``[lo, hi)`` (buffer-relative) were written
        on this buffer's device."""
        if self._tracker is not None:
            self._tracker.wrote_span(self._res_key, self._res_dev,
                                     self.origin + lo, self.origin + hi)

    def mark_written(self) -> None:
        self.mark_written_span(0, self.nbytes)

    # -- map bookkeeping (queried by CommandQueue._launch) ----------------------
    @property
    def map_count(self) -> int:
        """Number of active mapped regions over the *root* allocation."""
        with self.root._map_lock:
            return len(self.root._maps)

    def release(self) -> None:
        """clReleaseMemObject: the chunk goes back to its pool or arena
        and the tensor to torch's allocator."""
        with self._alloc_lock:
            if self.chunk is not None:
                if self._pool is not None:
                    self._pool.free(self.chunk)
                else:
                    self.device.allocator.free(self.chunk)
                self.chunk = None
            self._data = None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        # never touches the payload: a repr must not materialize
        return (f"<Buffer {self.n_elems} x {self.dtype} on "
                f"{self.device.info.name}"
                f"{'' if self.materialized else ' (lazy)'}>")


def validate_buffer_request(n_elems, dtype) -> int:
    """Validate a buffer-creation request; returns the element size.

    Raises :class:`~repro_torch.core.errors.InvalidBufferError`
    (CL_INVALID_BUFFER_SIZE) for a zero/negative/non-integral element
    count or a dtype that is unknown or that torch cannot hold —
    *before* the request reaches the Bufalloc arena."""
    if isinstance(n_elems, bool) or not isinstance(
            n_elems, (int, np.integer)):
        raise InvalidBufferError(
            f"buffer element count must be an integer, got "
            f"{type(n_elems).__name__} ({n_elems!r})")
    if n_elems <= 0:
        raise InvalidBufferError(
            f"buffer element count must be positive, got {n_elems}")
    try:
        itemsize = np.dtype(dtype).itemsize
        _torch_dtype(dtype)
    except TypeError as e:
        raise InvalidBufferError(
            f"unknown buffer dtype {dtype!r}: {e}") from None
    return itemsize


def create_buffer(device: Device, n_elems: int, dtype: str = "float32",
                  pool=None, lazy: bool = False) -> Buffer:
    """clCreateBuffer: allocate ``n_elems`` of ``dtype`` on ``device``.
    ``pool`` (a :class:`~repro_torch.runtime.memory.BufferPool` over the
    device's arena) serves the chunk from a size-class free list —
    ``Context.create_buffer`` passes the context's per-device pool.
    ``lazy=True`` defers chunk + tensor to first real use (pooled
    context buffers default to this, enabling fusion elision)."""
    itemsize = validate_buffer_request(n_elems, dtype)
    return Buffer(device, int(n_elems) * itemsize, dtype, int(n_elems),
                  pool=pool, lazy=lazy)


# ---------------------------------------------------------------------------
# Process-default platform (lazy singleton)
# ---------------------------------------------------------------------------

_default_platform: Optional[Platform] = None
_platform_lock = threading.Lock()


def default_platform() -> Platform:
    """The process-default :class:`Platform` (clGetPlatformIDs returns the
    same platform object for every caller): ``Platform()``, the CUDA
    devices, raising :class:`DeviceNotFoundError` without one."""
    global _default_platform
    with _platform_lock:
        if _default_platform is None:
            _default_platform = Platform()
        return _default_platform


__all__ = ["Buffer", "Device", "DeviceInfo", "DeviceNotFoundError",
           "Platform", "ThrottledDevice", "copy_into", "create_buffer",
           "default_platform", "validate_buffer_request"]
