"""Phase-correlation translation estimator, batched over leading axes.

Port of ``video_stabilizer_tpu.ops.phase_corr.phase_correlate``
(phase_corr.py:22-65): the rfft2 cross-power spectrum, its first maximum,
and a 5x5 wrap-around weighted centroid around it. The FFT is
``torch.fft`` (cuFFT on the card), as the JAX package leaves its FFT to
XLA: no Pallas kernel sits here.

Sign convention: ``phase_correlate(src1, src2)`` returns the (dx, dy) that
aligns src2 back onto src1. A zero pair (the pre-stream keyframe carry)
gives a zero spectrum, response 0 and shift 0, with no NaN.
"""

from __future__ import annotations

import torch


def phase_correlate(src1, src2, eps: float = 1e-15):
    """(shift (..., 2) float32 (dx, dy), response (...,) float32) of two
    same-shape (..., H, W) images."""
    a = src1.to(torch.float32)
    b = src2.to(torch.float32)
    h, w = a.shape[-2], a.shape[-1]
    lead = a.shape[:-2]

    fa = torch.fft.rfft2(a)
    fb = torch.fft.rfft2(b)
    cross = fa * torch.conj(fb)
    cross = cross / (torch.abs(cross) + eps)
    corr = torch.fft.irfft2(cross, s=(h, w))                  # (..., H, W)

    # torch.argmax returns the first maximal index, as jnp.argmax does.
    peak = torch.argmax(corr.reshape(lead + (h * w,)), dim=-1)
    py = peak // w
    px = peak % w

    offs = torch.arange(-2, 3, device=a.device)
    ys = (py[..., None] + offs) % h                           # (..., 5)
    xs = (px[..., None] + offs) % w
    flat = corr.reshape(lead + (h * w,))
    idx = (ys[..., :, None] * w + xs[..., None, :]).reshape(lead + (25,))
    win = torch.gather(flat, -1, idx).reshape(lead + (5, 5))
    win = torch.clamp(win, min=0.0)
    wsum = win.sum(dim=(-2, -1))
    offs_f = offs.to(torch.float32)
    dy = (win * offs_f[:, None]).sum(dim=(-2, -1)) / (wsum + eps)
    dx = (win * offs_f[None, :]).sum(dim=(-2, -1)) / (wsum + eps)

    fx = px.to(torch.float32) + dx
    fy = py.to(torch.float32) + dy
    fx = torch.where(fx > w / 2, fx - w, fx)
    fy = torch.where(fy > h / 2, fy - h, fy)
    return torch.stack([fx, fy], dim=-1), wsum
