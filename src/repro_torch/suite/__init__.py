"""Performance-portability kernel suite + scoreboard.

A linear-algebra/irregular kernel suite authored in the DSL (tiled GEMM,
CSR SpMV, 1-D/2-D stencils, work-group prefix scan, privatized
histogram), each with a tuning space and a bitwise NumPy oracle — copied
from ``repro.suite`` without JAX — plus the :class:`Scoreboard` that
sweeps the spaces per compiled target (``loop``, ``vector``, ``cuda``,
co-executed and ``auto``) and reports achieved-vs-roofline fractions
against peaks calibrated on the device (paper §4, Figs. 12-14).
"""

from .kernels import SUITE, SuiteKernel, ceil_to, param_key, suite_kernels
from .scoreboard import Scoreboard, calibrate, check_gates, render_markdown

__all__ = ["SUITE", "Scoreboard", "SuiteKernel", "calibrate", "ceil_to",
           "check_gates", "param_key", "render_markdown", "suite_kernels"]
