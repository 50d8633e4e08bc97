"""repro_torch.runtime — the OpenCL-shaped host layer over torch devices:
Platform / Device / Context, the native-command DAG queue and its events,
and the bufalloc arena with its size-class pool (trimmed: buffers,
map/unmap, co-execution and tracing are not ported yet)."""

from .bufalloc import Bufalloc, OutOfMemory
from .context import Context, default_context
from .events import CommandError, DependencyError, Event, UserEvent
from .memory import BufferPool
from .platform import Device, DeviceInfo, DeviceNotFoundError, Platform
from .queue import CommandQueue

__all__ = ["Bufalloc", "BufferPool", "CommandError", "CommandQueue",
           "Context", "DependencyError", "Device", "DeviceInfo",
           "DeviceNotFoundError", "Event", "OutOfMemory", "Platform",
           "UserEvent", "default_context"]
