"""Regularized pseudo-inverse of the 4x4 GN Hessian (alignment.cpp:553-583)
through a fixed-sweep CYCLIC Jacobi eigensolver, batched over leading axes.

The rotation order is that of ``video_stabilizer_tpu.ops.linalg.
_eigh_sym_cyclic`` (linalg.py:140-196): pairs (0,1), (0,2), ..., (2,3),
rows of the pair rotated first, then columns of the row-rotated matrix.
The golden measurement trace pins this order, so ``torch.linalg.eigh`` is
not a substitute.
"""

from __future__ import annotations

import torch


def _rot_rows(m, p: int, q: int, c, s):
    rows = list(m.unbind(-2))
    mp, mq = rows[p], rows[q]
    rows[p] = c * mp + s * mq
    rows[q] = -s * mp + c * mq
    return torch.stack(rows, dim=-2)


def _rot_cols(m, p: int, q: int, c, s):
    cols = list(m.unbind(-1))
    mp, mq = cols[p], cols[q]
    cols[p] = c * mp + s * mq
    cols[q] = -s * mp + c * mq
    return torch.stack(cols, dim=-1)


def eigh_sym4_cyclic(a, sweeps: int = 6):
    """(w (..., 4) unsorted eigenvalues, V (..., 4, 4)) of symmetric ``a``."""
    n = a.shape[-1]
    pairs = [(p, q) for p in range(n) for q in range(p + 1, n)]
    v = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape).clone()
    eps = torch.finfo(a.dtype).tiny
    for _ in range(sweeps):
        for p, q in pairs:
            apq = a[..., p, q]
            app = a[..., p, p]
            aqq = a[..., q, q]
            phi = 0.5 * torch.atan2(2.0 * apq, app - aqq + eps)
            c = torch.cos(phi)[..., None]
            s = torch.sin(phi)[..., None]
            a = _rot_cols(_rot_rows(a, p, q, c, s), p, q, c, s)
            v = _rot_cols(v, p, q, c, s)
    return torch.diagonal(a, dim1=-2, dim2=-1), v


def regularized_pinv_sym4(h, cond_threshold: float = 1e6,
                          tikhonov_scale: float = 1e-6):
    """cond = w_max / (w_min + 1e-10); above 1e6 add 1e-6 * w_max to the
    diagonal; invert with near-null eigenvalues zeroed (DECOMP_SVD)."""
    w, v = eigh_sym4_cyclic(h)
    w_max = torch.amax(w, dim=-1, keepdim=True)
    w_min = torch.amin(w, dim=-1, keepdim=True)
    cond = w_max / (w_min + 1e-10)
    lam = torch.where(cond > cond_threshold, tikhonov_scale * w_max,
                      torch.zeros_like(w_max))
    w2 = w + lam
    cutoff = torch.clamp(w_max + lam, min=0.0) * 1e-7
    inv_w = torch.where(w2 > cutoff, 1.0 / w2, torch.zeros_like(w2))
    # (V diag(inv_w)) V^T as a broadcast sum: full float32 whatever the
    # card's TF32 matmul setting.
    vs = v * inv_w[..., None, :]
    return (vs[..., :, :, None] * v.transpose(-1, -2)[..., None, :, :]).sum(-2)
