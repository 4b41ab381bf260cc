"""Lanczos2 resampling window: the reference's degree-12 even polynomial
fit of sinc(x)*sinc(x/2) (generators.cpp:31-47), Horner on x^2 in the same
order as ``video_stabilizer_tpu.ops.lanczos``; the exact window it fits,
and the 5-tap weights of the gather oracles (``ops/sparse.py``,
``ops/warp.py``)."""

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


def lanczos2_exact(x):
    """Exact sinc(x)*sinc(x/2), zero for |x| >= 2 (generators.cpp:5-27;
    lanczos.py:38-48): the baseline the polynomial is tested against."""
    x = torch.as_tensor(x, dtype=torch.float32)

    def sinc(v):
        pix = v * torch.pi
        s = torch.sin(pix) / torch.where(pix == 0.0, torch.ones_like(pix),
                                         pix)
        return torch.where(v == 0.0, torch.ones_like(v), s)

    val = sinc(x) * sinc(x / 2.0)
    return torch.where(torch.abs(x) >= 2.0, torch.zeros_like(val), val)


def lanczos2_weights_5tap(frac):
    """The five 1-D Lanczos2 tap weights (..., 5) of samples at
    integer_base + ``frac`` (...,): tap u in [0, 4] sits at (u - 2) - frac
    (generators.cpp:479-484; lanczos.py:51-64)."""
    offsets = torch.arange(-2, 3, dtype=frac.dtype, device=frac.device)
    return lanczos2(offsets - frac[..., None])
