"""repro_torch — the pocl kernel compiler and its launch path, ported to
PyTorch and CUDA for the NVIDIA H100.

A second package beside ``repro`` (the JAX/TPU reference, which it never
imports).  ``repro_torch.core`` holds the compiler: the ``KernelBuilder``
DSL, the SSA CFG IR, the pass manager and its ``WorkGroupPlan``, and the
parallel mappings (torch ``vector``/``loop`` targets and the hand-written
``cuda`` work-group target).  ``repro_torch.runtime`` holds the host
objects (``Platform``, ``Device``, ``Context``); ``repro_torch.suite`` the
kernel suite and its NumPy oracles.
"""

__all__ = ["core", "runtime", "suite"]
