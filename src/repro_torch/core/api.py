"""Kernel-compiler entry point (the layer under the host object model).

The port of ``repro.core.api``.  ``_compile_kernel(build, local_size,
target=...)`` runs the pocl-style pipeline at *enqueue* time (the paper
specializes the work-group function per local size, §4.1) and returns a
:class:`CompiledKernel`.  Host code reaches it through
:class:`~repro_torch.core.program.Program` /
:class:`~repro_torch.runtime.context.Context`.

Targets:
  ``vector``  — work-items on lanes, if-converted divergence (SIMD mapping)
  ``loop``    — serial work-item loops ('basic' driver analogue)
  ``cuda``    — CUDA C, one thread block per work-group, built by ``nvcc``
                for the H100 (:mod:`repro_torch.core.targets.cuda_target`)

Compilation is memoized in a content-addressed
:class:`~repro_torch.core.cache.CompilationCache` keyed by the canonical
IR hash + specialization parameters.  PyTorch runs eagerly, so there is
no per-shape trace cache under the compiled kernel.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from .cache import CacheKey, CompilationCache, PlanKey, default_cache, ir_hash
from .errors import InvalidArgError
from .ir import Function
from .passes import WorkGroupPlan, build_plan
from .targets.loop import LoopWGProgram
from .targets.vector import WGProgram

TARGETS = ("vector", "loop", "cuda")


class CompiledKernel:
    """A launchable work-group function: one target's mapping of one
    kernel at one local size."""

    def __init__(self, prog: WGProgram, name: str):
        self.prog = prog
        self.name = name

    def launch_ndrange(self, buffers: Dict[str, torch.Tensor],
                       global_size: Sequence[int],
                       scalars: Optional[Dict[str, object]] = None,
                       group_range: Optional[Sequence[int]] = None
                       ) -> Dict[str, torch.Tensor]:
        """Launch over contiguous 1-D tensors on one device, updating them
        in place (the ``cuda`` target returns without synchronizing)."""
        grange = None if group_range is None \
            else (int(group_range[0]), int(group_range[1]))
        return self.prog.launch_ndrange(buffers, scalars or {},
                                        tuple(global_size), grange)

    def __call__(self, buffers: Dict[str, object],
                 global_size: Sequence[int],
                 scalars: Optional[Dict[str, object]] = None,
                 group_range: Optional[Sequence[int]] = None,
                 device: Union[str, torch.device, None] = None
                 ) -> Dict[str, torch.Tensor]:
        """Launch over copies of ``buffers`` (numpy arrays or tensors) and
        return the outputs as tensors; the arguments stay untouched, as in
        the functional reference.  The copies go to ``device`` (default: a
        tensor's own device, the CPU for numpy arrays).
        ``group_range=(lo, hi)`` executes only that contiguous range of
        linearized work-groups of the full NDRange."""
        bufs = {k: to_device(v, device) for k, v in buffers.items()}
        flat = {k: v.reshape(-1) for k, v in bufs.items()}
        self.launch_ndrange(flat, global_size, scalars, group_range)
        return bufs

    # compiler introspection (used by tests/benchmarks)
    @property
    def num_regions(self) -> int:
        return len(self.prog.wg.regions)

    @property
    def context_stats(self) -> Dict[str, int]:
        return self.prog.plan.stats(self.prog.L)

    @property
    def work_group_plan(self) -> WorkGroupPlan:
        """The shared target-independent plan this kernel was built from."""
        return self.prog.wgplan

    @property
    def region_md(self) -> Dict[str, object]:
        """Per-region :class:`~repro_torch.core.passes.ParallelRegionMD`."""
        return self.prog.md


def to_device(v, device=None) -> torch.Tensor:
    """A contiguous copy of array or tensor ``v`` on ``device`` (default:
    the tensor's own device, the CPU for a numpy array)."""
    if isinstance(v, torch.Tensor):
        dev = v.device if device is None else torch.device(device)
        return v.detach().to(device=dev, copy=True).contiguous()
    if isinstance(v, np.ndarray):
        return torch.tensor(v, device=device)
    raise InvalidArgError(
        f"expected a numpy array or a torch tensor, got {type(v).__name__}")


def _run_pipeline(fn: Function, local_size: Sequence[int], target: str,
                  horizontal: bool, merge_uniform: bool,
                  use_vml: bool,
                  plan_cache: Optional[CompilationCache] = None,
                  _ir: Optional[str] = None) -> CompiledKernel:
    """One compilation = the (cacheable) target-independent prefix + the
    target-specific parallel mapping.  With a ``plan_cache``, the prefix
    is looked up by :class:`PlanKey` and shared across targets and local
    sizes of the same kernel."""
    name = fn.name
    if target not in TARGETS:
        raise InvalidArgError(f"unknown target {target!r}; have {TARGETS}")
    if plan_cache is not None:
        pkey = PlanKey.make(_ir if _ir is not None else ir_hash(fn),
                            horizontal=horizontal,
                            merge_uniform=merge_uniform)
        plan = plan_cache.get_or_build_plan(
            pkey, lambda: build_plan(fn, horizontal=horizontal,
                                     merge_uniform=merge_uniform))
    else:
        plan = build_plan(fn, horizontal=horizontal,
                          merge_uniform=merge_uniform)
    if target == "vector":
        cls = WGProgram
    elif target == "loop":
        cls = LoopWGProgram
    else:
        from .targets.cuda_target import CudaWGProgram
        cls = CudaWGProgram
    prog = cls(plan, local_size, horizontal=horizontal,
               merge_uniform=merge_uniform, use_vml=use_vml)
    return CompiledKernel(prog, name)


def _compile_kernel(build: Callable[[], Function],
                    local_size: Sequence[int],
                    target: str = "vector",
                    horizontal: bool = True,
                    merge_uniform: bool = True,
                    use_vml: bool = False,
                    cache: Union[bool, CompilationCache, None] = True,
                    plan_cache: Optional[CompilationCache] = None
                    ) -> CompiledKernel:
    """Compile ``build()`` for ``local_size`` on ``target``.

    ``cache=True`` uses the process-default compilation cache; pass a
    :class:`CompilationCache` for a private one (runtime devices do) or
    ``False``/``None`` to always recompile.  ``plan_cache`` holds the
    stage-level cache for the target-independent pipeline prefix
    (:class:`WorkGroupPlan`); it defaults to the kernel cache."""
    opts = dict(horizontal=horizontal, merge_uniform=merge_uniform,
                use_vml=use_vml)
    cache_obj: Optional[CompilationCache]
    if cache is True:
        cache_obj = default_cache()
    elif isinstance(cache, CompilationCache):
        cache_obj = cache
    else:
        cache_obj = None
    if plan_cache is None:
        plan_cache = cache_obj
    fn = build()
    if cache_obj is None:
        return _run_pipeline(fn, local_size, target, plan_cache=plan_cache,
                             **opts)
    key = CacheKey.make(fn, local_size, target, **opts)
    return cache_obj.get_or_compile(
        key, lambda: _run_pipeline(fn, local_size, target,
                                   plan_cache=plan_cache, _ir=key.ir,
                                   **opts))


__all__ = ["CompiledKernel", "TARGETS", "to_device"]
