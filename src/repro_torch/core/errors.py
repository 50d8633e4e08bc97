"""Typed error hierarchy with OpenCL-style status codes (docs/host_api.md).

Every error the reproduction raises on a *user-facing* path derives from
:class:`ReproError` and carries a numeric ``code`` plus a symbolic
``code_name`` mirroring the OpenCL status-code convention (CL_INVALID_*,
CL_BUILD_PROGRAM_FAILURE, ...).  Host code can therefore handle failures
by family::

    try:
        kernel.set_arg("x", wrong_thing)
    except ReproError as e:
        print(e.code, e.code_name)      # -50 CL_INVALID_ARG_VALUE

Each concrete class also inherits the *untyped* exception it replaced
(``ValueError``, ``RuntimeError``, ``MemoryError``, ``AssertionError``),
so pre-existing ``except ValueError`` style call sites keep working —
the hierarchy is a refinement, not a break.

Classes defined elsewhere for layering reasons but folded into the
hierarchy: :class:`~repro.runtime.events.CommandError` /
:class:`~repro.runtime.events.DependencyError` (a failed command and its
abandoned dependents), :class:`~repro.runtime.bufalloc.OutOfMemory` (the
arena allocator), and :class:`~repro.core.passes.VerifierError` (a
structural IR invariant broken by a middle-end pass, a build failure).
"""

from __future__ import annotations

from typing import Dict


class ReproError(Exception):
    """Base of the typed error hierarchy.

    ``code``/``code_name`` follow the OpenCL status-code style: 0 is
    success (never raised), failures are negative.
    """

    code: int = -9999
    code_name: str = "REPRO_ERROR"

    @property
    def status(self) -> int:
        """The numeric status code (negative, OpenCL convention)."""
        return self.code


class InvalidArgError(ReproError, ValueError):
    """Bad argument to a host API call: unknown kernel-arg name/index,
    a value whose dtype contradicts the kernel signature, a scalar where
    the IR declares a buffer (CL_INVALID_ARG_VALUE family), or a launch
    with unset kernel arguments (CL_INVALID_KERNEL_ARGS)."""

    code = -50
    code_name = "CL_INVALID_ARG_VALUE"


class InvalidBufferError(InvalidArgError):
    """Illegal buffer creation request: zero/negative element count or
    an unknown dtype string (CL_INVALID_BUFFER_SIZE)."""

    code = -61
    code_name = "CL_INVALID_BUFFER_SIZE"


class BuildError(ReproError, RuntimeError):
    """Program/kernel build failure (CL_BUILD_PROGRAM_FAILURE).

    ``build_log`` carries the accumulated diagnostics the way
    ``clGetProgramBuildInfo(CL_PROGRAM_BUILD_LOG)`` does — including the
    verifier report when a middle-end pass broke an IR invariant.
    """

    code = -11
    code_name = "CL_BUILD_PROGRAM_FAILURE"

    def __init__(self, message: str, build_log: str = ""):
        super().__init__(message)
        self.build_log = build_log


class MapError(ReproError, RuntimeError):
    """Illegal sub-buffer or map/unmap operation (CL_MAP_FAILURE /
    CL_INVALID_* family, docs/memory.md).  Raised by ``create_sub_buffer``
    bounds/alignment checks, by overlapping-write-map guards, and by
    launches over write-mapped allocations."""

    code = -12
    code_name = "CL_MAP_FAILURE"


class DeviceLostError(ReproError, RuntimeError):
    """A device became unavailable mid-pipeline (CL_DEVICE_NOT_AVAILABLE).

    The serving scheduler surfaces this on the *affected request's*
    result when a device-side DAG command fails mid-group, while sibling
    requests keep running (docs/serving.md §Failure handling); the
    fault-injection harness raises it to drive that path."""

    code = -2
    code_name = "CL_DEVICE_NOT_AVAILABLE"


#: status code -> symbolic name, for every code the hierarchy can raise
#: (populated below; the paper's hosts report these via clGetEventInfo)
STATUS_NAMES: Dict[int, str] = {}


def status_name(code: int) -> str:
    """Symbolic name for a status ``code`` (``"UNKNOWN(<code>)"`` when no
    class claims it)."""
    return STATUS_NAMES.get(code, f"UNKNOWN({code})")


def _register(cls) -> None:
    STATUS_NAMES.setdefault(cls.code, cls.code_name)


def register_error(cls):
    """Fold an externally-defined exception class into the status table
    (used by the runtime/compiler classes that live in their own modules
    for layering reasons: CommandError, OutOfMemory, VerifierError)."""
    _register(cls)
    return cls


for _cls in (ReproError, InvalidArgError, InvalidBufferError, BuildError,
             MapError, DeviceLostError):
    _register(_cls)


__all__ = [
    "ReproError", "InvalidArgError", "InvalidBufferError", "BuildError",
    "MapError", "DeviceLostError", "status_name", "register_error",
    "STATUS_NAMES",
]
