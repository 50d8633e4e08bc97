"""Oracles for Vecmathlib: torch's own elemental functions, the "libm" the
paper compares against.  The port of ``repro.vml.ref``, with
``torch.special.erf`` in place of ``jax.scipy.special.erf``."""

import numpy as np
import torch

exp = torch.exp
log = torch.log
sin = torch.sin
cos = torch.cos
tanh = torch.tanh
erf = torch.special.erf
sqrt = torch.sqrt
rsqrt = torch.rsqrt
fabs = torch.abs


def sigmoid(x):
    return torch.where(x >= 0, 1 / (1 + torch.exp(-torch.abs(x))),
                       1 - 1 / (1 + torch.exp(-torch.abs(x))))


def reciprocal(x):
    return 1.0 / x


def gelu_tanh(x):
    c = float(np.float32(0.7978845608028654))
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def silu(x):
    return x * sigmoid(x)
