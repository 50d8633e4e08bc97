"""repro_torch.runtime — the OpenCL-shaped host layer over torch devices:
Platform / Device / Context (trimmed: queues, events, buffers and
co-execution are not ported yet)."""

from .context import Context
from .platform import Device, DeviceInfo, DeviceNotFoundError, Platform

__all__ = ["Context", "Device", "DeviceInfo", "DeviceNotFoundError",
           "Platform"]
