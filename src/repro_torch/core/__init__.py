"""repro_torch.core — the pocl kernel compiler over torch and CUDA.

Public API:
  KernelBuilder    — author SPMD kernels (OpenCL C analogue)
  Program / Kernel — host objects over the compiler, created through a
                     runtime Context
  PassManager      — the middle-end pass pipeline; build_plan runs it,
                     producing the WorkGroupPlan all targets share
  run_ndrange      — fiber-based reference executor (semantics oracle)
  CompilationCache — LRU + disk compilation cache with a plan tier
  ReproError       — typed error hierarchy with OpenCL-style status codes
"""

from .dsl import KernelBuilder
from .api import CompiledKernel
from .cache import (CacheKey, CompilationCache, PlanKey, canonical_ir,
                    default_cache, ir_hash, reset_default_cache)
from .errors import (BuildError, InvalidArgError, InvalidBufferError,
                     MapError, ReproError, status_name)
from .passes import (ParallelRegionMD, Pass, PassManager, VerifierError,
                     WorkGroupPlan, build_plan, plan_count, verify_ir)
from .program import Kernel, Program
from .interp import run_ndrange

__all__ = [
    "KernelBuilder", "CompiledKernel", "Program", "Kernel",
    "CacheKey", "CompilationCache", "PlanKey", "canonical_ir",
    "default_cache", "ir_hash", "reset_default_cache",
    "ReproError", "InvalidArgError", "InvalidBufferError", "BuildError",
    "MapError", "status_name",
    "ParallelRegionMD", "Pass", "PassManager", "VerifierError",
    "WorkGroupPlan", "build_plan", "plan_count", "verify_ir",
    "run_ndrange",
]
