"""First-class Program / Kernel host objects (paper §3).

The port of ``repro.core.program``: a ``cl_program`` holds one or more
kernels, is built per device, and hands out ``cl_kernel`` objects whose
arguments are bound with ``clSetKernelArg`` before any number of
launches.

* :class:`Program` — created from one or more IR builders
  (``Context.create_program``).  The middle-end (the pass-manager
  pipeline producing the shared
  :class:`~repro_torch.core.passes.WorkGroupPlan`) runs through the
  owning context's *shared* plan tier.  Per-(device, local_size, target)
  work-group functions are specialized **lazily at launch time** (paper
  §4.1) through each device's compilation cache; ``Program.build()`` only
  runs the target-independent pipeline plus the structural IR verifier,
  accumulating a ``build_log()`` the way ``clGetProgramBuildInfo`` does.
* :class:`Kernel` — one named kernel of a program with OpenCL ``set_arg``
  semantics: positional or named binding, validated against the IR
  signature (buffer vs. scalar, dtype; LOCAL args are materialized by the
  work-group function and not settable), and a cheap :meth:`Kernel.clone`.
  Buffer arguments are numpy arrays or torch tensors (``Context.launch``)
  or device-resident buffers (``CommandQueue.enqueue_nd_range``).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import ir
from .api import _compile_kernel
from .cache import CompilationCache, PlanKey, default_cache, ir_hash
from .errors import BuildError, InvalidArgError
from .ir import Function
from .passes import VerifierError, build_plan


def _classify(value) -> str:
    """Host-API argument class of ``value``: ``"host"`` (an array or
    tensor), ``"shared"`` (SharedBuffer), ``"device"`` (Buffer/SubBuffer
    view) or ``"scalar"``.  Duck-typed so the core layer never imports the
    runtime layer."""
    if isinstance(value, (np.ndarray, torch.Tensor)) and value.ndim > 0:
        return "host"
    if hasattr(value, "tracker") and hasattr(value, "host"):
        return "shared"
    # probe `origin`, not `data`: hasattr(value, "data") would invoke the
    # property getter, materializing a still-lazy pooled buffer and
    # defeating fusion's intermediate elision
    if hasattr(value, "root") and hasattr(value, "origin"):
        return "device"
    return "scalar"


_NP_OF_TORCH = {torch.float32: np.dtype("float32"),
                torch.float64: np.dtype("float64"),
                torch.int32: np.dtype("int32"),
                torch.int64: np.dtype("int64"),
                torch.bool: np.dtype("bool")}


def _buffer_dtype(value) -> np.dtype:
    """The numpy dtype of a buffer-class argument (an array, a tensor, a
    SharedBuffer over one, or a device buffer, whose ``dtype`` may be any
    numpy spelling)."""
    if _classify(value) == "shared":
        value = value.host
    if isinstance(value, torch.Tensor):
        try:
            return _NP_OF_TORCH[value.dtype]
        except KeyError:
            raise InvalidArgError(
                f"buffer tensors of {value.dtype} are not supported") \
                from None
    return np.dtype(value.dtype)


class Program:
    """A set of kernels compiled together (``cl_program`` analogue).

    Parameters
    ----------
    builders:
        Zero-argument callables, each returning a fresh
        :class:`~repro_torch.core.ir.Function` (the pipeline mutates the
        CFG, so every specialization rebuilds from source).  Kernel names
        come from the built functions.
    context:
        The owning :class:`~repro_torch.runtime.context.Context` (may be
        ``None`` for context-free compiler-level use).  Provides the
        shared compilation/plan cache tier.
    options:
        Build options applied to every kernel: ``horizontal``,
        ``merge_uniform``, ``use_vml``.
    """

    def __init__(self, builders: Sequence[Callable[[], Function]],
                 context=None, horizontal: bool = True,
                 merge_uniform: bool = True, use_vml: bool = False):
        if not builders:
            raise InvalidArgError("Program needs at least one IR builder")
        self.context = context
        self.options: Dict[str, object] = dict(
            horizontal=horizontal, merge_uniform=merge_uniform,
            use_vml=use_vml)
        self._builders: Dict[str, Callable[[], Function]] = {}
        self._fns: Dict[str, Function] = {}       # signature reference
        self._ir: Dict[str, str] = {}             # canonical IR hashes
        for build in builders:
            fn = build()
            if fn.name in self._builders:
                raise InvalidArgError(
                    f"duplicate kernel name {fn.name!r} in program")
            self._builders[fn.name] = build
            self._fns[fn.name] = fn
            self._ir[fn.name] = ir_hash(fn)
        self._log: List[str] = []
        self._built = False
        self._binaries: Dict[tuple, object] = {}
        self._lock = threading.Lock()

    # -- introspection ---------------------------------------------------------
    def kernel_names(self) -> List[str]:
        """clGetProgramInfo(CL_PROGRAM_KERNEL_NAMES)."""
        return list(self._builders)

    def function(self, name: str) -> Function:
        """The *unmutated* signature IR of kernel ``name``."""
        try:
            return self._fns[name]
        except KeyError:
            raise InvalidArgError(
                f"no kernel {name!r} in program; have "
                f"{self.kernel_names()}") from None

    def builder(self, name: str) -> Callable[[], Function]:
        """The zero-argument IR builder of kernel ``name`` — the source
        the queue's fusion rewrite re-stitches chains from
        (:mod:`repro_torch.core.fusion`)."""
        try:
            return self._builders[name]
        except KeyError:
            raise InvalidArgError(
                f"no kernel {name!r} in program; have "
                f"{self.kernel_names()}") from None

    def build_log(self) -> str:
        """clGetProgramBuildInfo(CL_PROGRAM_BUILD_LOG)."""
        return "\n".join(self._log)

    # -- build (middle-end + verifier; specialization stays lazy) -------------
    def _plan_cache(self) -> CompilationCache:
        if self.context is not None:
            return self.context.cache
        return default_cache()

    def plan_key(self, name: str) -> PlanKey:
        return PlanKey.make(self.ir_hash(name),
                            horizontal=self.options["horizontal"],
                            merge_uniform=self.options["merge_uniform"])

    def ir_hash(self, name: str) -> str:
        """Canonical IR hash of kernel ``name``."""
        try:
            return self._ir[name]
        except KeyError:
            raise InvalidArgError(
                f"no kernel {name!r} in program; have "
                f"{self.kernel_names()}") from None

    def build(self, verify: bool = True) -> "Program":
        """clBuildProgram: run the target-independent middle-end for
        every kernel through the shared plan tier, with the structural
        IR verifier between passes.  On a verifier failure the report
        lands in :meth:`build_log` and a
        :class:`~repro_torch.core.errors.BuildError` is raised."""
        cache = self._plan_cache()
        for name, build in self._builders.items():
            try:
                plan = build_plan(
                    build(), horizontal=self.options["horizontal"],
                    merge_uniform=self.options["merge_uniform"],
                    verify=verify)
                cache.get_or_build_plan(self.plan_key(name),
                                        lambda p=plan: p)
            except VerifierError as e:
                self._log.append(f"kernel {name!r}: {e}")
                raise BuildError(
                    f"program build failed for kernel {name!r} "
                    f"(see build_log())",
                    build_log=self.build_log()) from e
            self._log.append(f"kernel {name!r}: middle-end ok "
                             f"(plan {self.plan_key(name).ir[:12]}...)")
        self._built = True
        return self

    # -- lazy specialization ----------------------------------------------------
    def binary_for(self, name: str, local_size: Sequence[int],
                   device=None, target: Optional[str] = None):
        """The launchable work-group function of kernel ``name`` for
        ``(device, local_size, target)`` — a
        :class:`~repro_torch.core.api.CompiledKernel` (or an
        :class:`~repro_torch.core.autotune.AutotunedKernel` on an
        ``auto`` device or for ``target="auto"``), memoized in the
        device's compilation cache; the target defaults to the device
        driver's."""
        if name not in self._builders:
            raise InvalidArgError(
                f"no kernel {name!r} in program; have "
                f"{self.kernel_names()}")
        lsz = tuple(int(x) for x in local_size)
        dev_key = device.info.name if device is not None else ""
        key = (name, dev_key, lsz, target)
        with self._lock:
            binary = self._binaries.get(key)
        if binary is not None:
            return binary
        build = self._builders[name]
        if device is not None:
            opts = dict(self.options)
            if target is not None:
                opts["target"] = target
            binary = device.compile(build, lsz,
                                    plan_cache=self._plan_cache(), **opts)
        else:
            binary = _compile_kernel(
                build, lsz, target=target or "vector",
                cache=self.context.cache if self.context is not None
                else True,
                plan_cache=self._plan_cache(), **self.options)
        with self._lock:
            self._binaries.setdefault(key, binary)
            return self._binaries[key]

    # -- kernels -----------------------------------------------------------------
    def create_kernel(self, name: Optional[str] = None) -> "Kernel":
        """clCreateKernel (defaults to the program's only kernel)."""
        if name is None:
            names = self.kernel_names()
            if len(names) != 1:
                raise InvalidArgError(
                    f"program has {len(names)} kernels {names}; "
                    f"create_kernel needs an explicit name")
            name = names[0]
        return Kernel(self, name)

    def create_kernels(self) -> Dict[str, "Kernel"]:
        """clCreateKernelsInProgram: one Kernel per kernel name."""
        return {n: Kernel(self, n) for n in self.kernel_names()}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"<Program kernels={self.kernel_names()} "
                f"built={self._built}>")


class Kernel:
    """One kernel of a :class:`Program` with bound arguments
    (``cl_kernel`` analogue).

    Arguments are set positionally or by name and validated against the
    IR signature immediately: wrong dtype, buffer-vs-scalar confusion or
    unknown names raise :class:`~repro_torch.core.errors.InvalidArgError`
    at ``set_arg`` time.  The positional order is the declaration order:
    global/constant buffer arguments first, then scalars."""

    def __init__(self, program: Program, name: str):
        self.program = program
        self.name = name
        self._fn = program.function(name)
        self._buffer_args = [a for a in self._fn.buffer_args
                             if a.space != ir.LOCAL]
        self._scalar_args = list(self._fn.scalar_args)
        self._order = ([a.name for a in self._buffer_args]
                       + [a.name for a in self._scalar_args])
        self._by_name = {a.name: a for a in self._buffer_args}
        self._by_name.update({a.name: a for a in self._scalar_args})
        self._args: Dict[str, object] = {}

    # -- signature introspection -------------------------------------------------
    @property
    def ir_hash(self) -> str:
        return self.program.ir_hash(self.name)

    @property
    def num_args(self) -> int:
        """clGetKernelInfo(CL_KERNEL_NUM_ARGS) over the settable args."""
        return len(self._order)

    def arg_info(self) -> List[Tuple[str, str, str]]:
        """``(name, kind, dtype)`` per settable argument, positional
        order (clGetKernelArgInfo)."""
        out = [(a.name, "buffer", a.dtype) for a in self._buffer_args]
        out += [(a.name, "scalar", a.dtype) for a in self._scalar_args]
        return out

    # -- argument binding ---------------------------------------------------------
    def set_arg(self, key, value) -> "Kernel":
        """clSetKernelArg: bind one argument by position (int) or name
        (str).  Returns ``self`` for chaining."""
        if isinstance(key, (int, np.integer)):
            idx = int(key)
            if not 0 <= idx < len(self._order):
                raise InvalidArgError(
                    f"kernel {self.name!r} has {len(self._order)} "
                    f"settable args, index {idx} out of range "
                    f"({self.arg_info()})")
            name = self._order[idx]
        elif isinstance(key, str):
            name = key
            if name not in self._by_name:
                local = [a.name for a in self._fn.buffer_args
                         if a.space == ir.LOCAL]
                hint = (f"; {name!r} is a LOCAL array, materialized by "
                        f"the work-group function (pocl §4.7), not "
                        f"settable" if name in local else
                        f"; settable args: {self._order}")
                raise InvalidArgError(
                    f"kernel {self.name!r} has no argument "
                    f"{name!r}{hint}")
        else:
            raise InvalidArgError(
                f"set_arg key must be an int index or str name, got "
                f"{type(key).__name__}")
        arg = self._by_name[name]
        self._validate(arg, name, value)
        self._args[name] = value
        return self

    def _validate(self, arg, name: str, value) -> None:
        kind = _classify(value)
        is_buffer = any(a.name == name for a in self._buffer_args)
        if is_buffer:
            if kind == "scalar":
                raise InvalidArgError(
                    f"kernel {self.name!r} argument {name!r} is a "
                    f"{arg.dtype} buffer; got scalar {value!r} "
                    f"(CL_INVALID_ARG_VALUE)")
            got = _buffer_dtype(value)
            if got != np.dtype(arg.dtype):
                raise InvalidArgError(
                    f"kernel {self.name!r} argument {name!r} expects "
                    f"dtype {arg.dtype}, got {got.name} "
                    f"(CL_INVALID_ARG_VALUE)")
        else:
            if kind != "scalar":
                raise InvalidArgError(
                    f"kernel {self.name!r} argument {name!r} is a "
                    f"{arg.dtype} scalar; got a {kind} buffer "
                    f"(CL_INVALID_ARG_VALUE)")
            if isinstance(value, torch.Tensor):
                value = value.item()
            if isinstance(value, bool) or not isinstance(
                    value, (int, float, complex, np.number)):
                raise InvalidArgError(
                    f"kernel {self.name!r} argument {name!r} expects a "
                    f"{arg.dtype} scalar, got "
                    f"{type(value).__name__} ({value!r})")
            kind_code = np.dtype(arg.dtype).kind
            if kind_code != "c" and isinstance(
                    value, (complex, np.complexfloating)):
                raise InvalidArgError(
                    f"kernel {self.name!r} argument {name!r} expects a "
                    f"{arg.dtype} scalar, got complex {value!r}")
            if kind_code in "iu" and isinstance(
                    value, (float, np.floating)) and \
                    not float(value).is_integer():
                raise InvalidArgError(
                    f"kernel {self.name!r} argument {name!r} expects an "
                    f"{arg.dtype} scalar; {value!r} has a fractional "
                    f"part (CL_INVALID_ARG_VALUE)")

    def set_args(self, *positional, **named) -> "Kernel":
        """Bind several arguments at once: positionally (declaration
        order) and/or by keyword."""
        for i, v in enumerate(positional):
            self.set_arg(i, v)
        for k, v in named.items():
            self.set_arg(k, v)
        return self

    def clone(self) -> "Kernel":
        """clCloneKernel: an independent argument binding sharing the
        program and every compiled binary."""
        k = Kernel.__new__(Kernel)
        k.program = self.program
        k.name = self.name
        k._fn = self._fn
        k._buffer_args = self._buffer_args
        k._scalar_args = self._scalar_args
        k._order = self._order
        k._by_name = self._by_name
        k._args = dict(self._args)
        return k

    # -- launch-side access -------------------------------------------------------
    def missing_args(self) -> List[str]:
        return [n for n in self._order if n not in self._args]

    def launch_args(self, accept: Sequence[str] = ("host", "shared",
                                                   "device")
                    ) -> Tuple[Dict[str, object], Dict[str, object]]:
        """The bound ``(buffers, scalars)`` dicts for a launch.

        Raises :class:`~repro_torch.core.errors.InvalidArgError`
        (CL_INVALID_KERNEL_ARGS) when arguments are unset, or when a
        buffer argument's class is outside ``accept`` — e.g. a
        device-bound Buffer handed to ``Context.launch``, which takes
        arrays and tensors, or to a co-executed launch, which needs
        arrays, tensors or SharedBuffers."""
        missing = self.missing_args()
        if missing:
            raise InvalidArgError(
                f"kernel {self.name!r} launched with unset arguments "
                f"{missing} (CL_INVALID_KERNEL_ARGS)")
        buffers: Dict[str, object] = {}
        for a in self._buffer_args:
            v = self._args[a.name]
            kind = _classify(v)
            if kind not in accept:
                raise InvalidArgError(
                    f"kernel {self.name!r} argument {a.name!r} is a "
                    f"{kind} buffer; this launch path accepts "
                    f"{tuple(accept)}")
            buffers[a.name] = v
        scalars = {a.name: self._args[a.name] for a in self._scalar_args}
        return buffers, scalars

    def bind(self, device, local_size: Sequence[int],
             target: Optional[str] = None):
        """The compiled work-group function for ``(device, local_size)``
        — delegates to :meth:`Program.binary_for` (lazy, cached)."""
        return self.program.binary_for(self.name, local_size,
                                       device=device, target=target)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        bound = {n: _classify(v) for n, v in self._args.items()}
        return f"<Kernel {self.name!r} args={bound}>"


__all__ = ["Program", "Kernel"]
