"""Polynomial kernels and coefficient tables for Vecmathlib (paper §5.1).

The torch port of ``repro.vml.poly``: the same coefficient tables, and
Horner's rule on tensors.

Most functions are computed via *range reduction followed by a polynomial
expansion* (the paper's recipe).  Coefficients are minimax fits (cephes /
fdlibm heritage) on the reduced ranges, accurate to float32 round-off.
"""

from __future__ import annotations

import torch

LN2 = 0.6931471805599453
INV_LN2 = 1.4426950408889634
# Cody–Waite split of ln2 for accurate exp range reduction
LN2_HI = 0.693359375
LN2_LO = -2.12194440e-4

PI = 3.141592653589793
PI_2 = 1.5707963267948966
INV_PI_2 = 0.6366197723675814
# Cody–Waite split of pi/2
PIO2_HI = 1.5707855224609375
PIO2_MID = 1.0804334124e-5
PIO2_LO = 6.0770943833e-11


def horner(x, coeffs):
    """Evaluate sum(c_i * x^(n-i)) with Horner's rule; coeffs highest-first."""
    acc = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        acc = acc * x + c
    return acc


# e^r = 1 + r + r^2 * P(r) on [-ln2/2, ln2/2] (cephes expf minimax)
EXP_COEFFS = (
    1.9875691500e-4,
    1.3981999507e-3,
    8.3334519073e-3,
    4.1665795894e-2,
    1.6666665459e-1,
    5.0000001201e-1,
)

# sin(r) = r + r^3 * P(r^2) on [-pi/4, pi/4]
SIN_COEFFS = (
    -1.9515295891e-4,
    8.3321608736e-3,
    -1.6666654611e-1,
)

# cos(r) = 1 - r^2/2 + r^4 * P(r^2) on [-pi/4, pi/4]
COS_COEFFS = (
    2.443315711809948e-5,
    -1.388731625493765e-3,
    4.166664568298827e-2,
)

# log(1+f) = 2 * s * P(s^2), s = f/(2+f)  (atanh series, |s| <= 0.172)
LOG_COEFFS = (
    1.0 / 9.0,
    1.0 / 7.0,
    1.0 / 5.0,
    1.0 / 3.0,
    1.0,
)

# erf rational approximation (Abramowitz & Stegun 7.1.26), |err| <= 1.5e-7
ERF_A = (1.061405429, -1.453152027, 1.421413741, -0.284496736, 0.254829592)
ERF_P = 0.3275911
