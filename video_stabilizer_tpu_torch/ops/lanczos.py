"""Lanczos2 resampling window: the reference's degree-12 even polynomial
fit of sinc(x)*sinc(x/2) (generators.cpp:31-47), Horner on x^2 in the same
order as ``video_stabilizer_tpu.ops.lanczos``."""

from __future__ import annotations

import torch

# Even-polynomial coefficients a0..a6 of P(x) = sum a_k * x^(2k)
# (generators.cpp:38-44).
POLY_COEFFS = (
    0.999861,
    -2.05238,
    1.52229,
    -0.583468,
    0.128693,
    -0.0158853,
    0.000858519,
)


def lanczos2(x):
    """Polynomial Lanczos2 window, zero for |x| >= 2."""
    x2 = x * x
    val = torch.full_like(x, POLY_COEFFS[6])
    for a in POLY_COEFFS[5::-1]:
        val = a + val * x2
    return torch.where(torch.abs(x) >= 2.0, torch.zeros_like(x), val)
