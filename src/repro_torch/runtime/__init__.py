"""repro_torch.runtime — the OpenCL-shaped host layer over torch devices
(paper §3): Platform / Device / Context, device-resident buffers and
sub-buffers, map/unmap through a host bounce, the event-DAG command queue
with buffer and kernel enqueues and DAG fusion, the bufalloc arena with
its size-class pool, multi-device co-execution of one NDRange
(``scheduler.py``: ``CoExecutor``, ``SharedBuffer``), and the
Chrome-trace export."""

from ..core.errors import (BuildError, InvalidArgError, InvalidBufferError,
                           ReproError, status_name)
from ..core.program import Kernel, Program
from .bufalloc import Bufalloc, OutOfMemory, ResidencyTracker
from .context import Context, default_context
from .events import (CommandError, DependencyError, Event, EventStatus,
                     UserEvent, chunk_counters, wait_for_events)
from .memory import (MAP_READ, MAP_READ_WRITE, MAP_WRITE,
                     MAP_WRITE_INVALIDATE, BufferPool, MapError,
                     MappedRegion, SubBuffer, create_sub_buffer)
from .platform import (Buffer, Device, DeviceInfo, DeviceNotFoundError,
                       Platform, ThrottledDevice, create_buffer,
                       default_platform)
from .queue import CommandQueue
from .scheduler import (AdaptiveSplitter, CoExecStats, CoExecutor,
                        SharedBuffer, ThroughputModel, device_class,
                        split_groups)
from .trace import ChromeTrace, validate_trace

__all__ = [
    "Context", "default_context", "Program", "Kernel",
    "ReproError", "InvalidArgError", "InvalidBufferError", "BuildError",
    "status_name",
    "Bufalloc", "OutOfMemory", "ResidencyTracker",
    "Event", "EventStatus", "UserEvent", "CommandError", "DependencyError",
    "wait_for_events", "chunk_counters",
    "Platform", "Device", "DeviceInfo", "DeviceNotFoundError",
    "ThrottledDevice", "Buffer", "create_buffer", "default_platform",
    "CommandQueue",
    "CoExecutor", "CoExecStats", "SharedBuffer", "split_groups",
    "ThroughputModel", "AdaptiveSplitter", "device_class",
    "MapError", "MappedRegion", "SubBuffer", "create_sub_buffer",
    "BufferPool", "MAP_READ", "MAP_WRITE", "MAP_READ_WRITE",
    "MAP_WRITE_INVALIDATE",
    "ChromeTrace", "validate_trace",
]
