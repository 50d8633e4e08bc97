"""The DSL kernel suite (tiled GEMM, CSR SpMV, 1-D/2-D stencils,
work-group scan, privatized histogram), each with a tuning space and a
bitwise NumPy oracle — copied from ``repro.suite`` without JAX.  The
scoreboard is not ported yet."""

from .kernels import SUITE, SuiteKernel, ceil_to, param_key, suite_kernels

__all__ = ["SUITE", "SuiteKernel", "ceil_to", "param_key", "suite_kernels"]
