"""Vecmathlib (paper §5) on torch tensors: vectorized, fusible elemental
math for the kernel compiler's built-in library (``use_vml=True``) and
the LM stack's activations, with torch's own functions as its oracles
(:mod:`.ref`)."""

from .core import (cos, copysign, erf, exp, fabs, gelu_tanh, log, reciprocal,
                   rsqrt, sigmoid, signbit, silu, sin, sqrt, tanh)
from . import ref

__all__ = ["exp", "log", "sin", "cos", "tanh", "erf", "sqrt", "rsqrt",
           "fabs", "copysign", "signbit", "reciprocal", "sigmoid",
           "gelu_tanh", "silu", "ref"]
