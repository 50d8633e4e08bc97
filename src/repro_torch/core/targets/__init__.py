"""Parallel mappings of the WorkGroupPlan: torch ``vector`` and ``loop``
targets, and the CUDA ``cuda_target`` (imported on demand: it is only
launched on a CUDA device)."""

from . import loop, vector

__all__ = ["loop", "vector"]
