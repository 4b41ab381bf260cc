"""L1 / total-variation trajectory smoother (smoother.cpp:18-127).

Per transform parameter, 100 fixed iterations of (a) relaxation toward the
data (alpha = 0.5) and (b) a sequential left-to-right sweep of pairwise
difference shrinkage. Same expressions as
``video_stabilizer_tpu.models.smoother.tvl1_smooth`` (smoother.py:30-80).
"""

from __future__ import annotations

import torch


def tvl1_smooth(data, lam: float, iterations: int = 100, valid_len=None):
    """TV-L1 smooth along the last axis, batched over leading axes.

    ``valid_len``: optional int or integer tensor broadcastable to
    ``data.shape[:-1]``; only the first ``valid_len`` entries of a row are
    real and pair updates beyond them are inert.
    """
    n = data.shape[-1]
    tiny = torch.finfo(data.dtype).tiny
    # A Python float enters each op as a float32 scalar, as the JAX
    # package's float32 ``lam`` does, without a host-to-device copy.
    lam_t = float(lam)
    if valid_len is None:
        valid_len = n
    if not isinstance(valid_len, torch.Tensor):
        valid_len = torch.full(data.shape[:-1], int(valid_len),
                               device=data.device)
    valid_len = valid_len.expand(data.shape[:-1])
    active = [(i + 1) < valid_len for i in range(n - 1)]
    data_cols = list(data.unbind(-1))
    cols = list(data_cols)
    for _ in range(iterations):
        cols = [0.5 * c + 0.5 * d for c, d in zip(cols, data_cols)]
        for i in range(n - 1):
            xi, xj = cols[i], cols[i + 1]
            diff = xj - xi
            mag = torch.abs(diff)
            shrink = (mag - lam_t) / torch.clamp(mag, min=tiny) * 0.5
            mid = 0.5 * (xi + xj)
            take = mag > lam_t
            new_i = torch.where(take, xi + diff * shrink, mid)
            new_j = torch.where(take, xj - diff * shrink, mid)
            cols[i] = torch.where(active[i], new_i, xi)
            cols[i + 1] = torch.where(active[i], new_j, xj)
    return torch.stack(cols, dim=-1)
