"""Vecmathlib (paper §5) on torch tensors: the part of ``repro.vml`` the
serving path calls.  The rest of vml waits (ROADMAP A.6)."""

from .core import exp, fabs, rsqrt, sigmoid, silu

__all__ = ["exp", "fabs", "rsqrt", "sigmoid", "silu"]
