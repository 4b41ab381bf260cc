"""Keypoint outlier rejection, the two selections of
``video_stabilizer_tpu.ops.select``:

- ``histogram_mask`` (select.py:24-61): the smallest integer threshold t in
  [0, bins) with count(floor(wd) <= t) >= floor(N * fraction); every entry
  at or below it is kept (ties in the threshold bin are all kept).
- ``topk_mask`` (select.py:64-72): exactly max(int(N * fraction), 1)
  entries, the smallest, ties broken by the lower index as
  ``jax.lax.top_k`` breaks them.
"""

from __future__ import annotations

import numpy as np
import torch

# Warp diffs of u8 images are <= 255; one overflow bin catches the rest.
DEFAULT_BINS = 257


def histogram_mask(wd, fraction, bins: int = DEFAULT_BINS):
    """0/1 float mask of the smallest-``fraction`` values of ``wd`` along
    its last axis; leading axes are independent rows. ``fraction`` is a
    float, or a tensor that broadcasts to the rows (``wd.shape[:-1]``): one
    keep fraction per row, as the JAX package's traced fraction is under
    vmap."""
    n = wd.shape[-1]
    v = torch.clamp(torch.floor(wd), 0, bins - 1)
    # floor(N * fraction) in float32, as the JAX package forms it from its
    # float32 ``smallest_fraction`` (select.py:50).
    if isinstance(fraction, torch.Tensor):
        k = torch.floor(fraction.to(device=wd.device, dtype=torch.float32)
                        * float(np.float32(n)))
        k = k.expand(wd.shape[:-1]).reshape(-1, 1)
    else:
        k = float(np.floor(np.float32(n) * np.float32(fraction)))
    rows = v.reshape(-1, n).to(torch.int64)
    offs = torch.arange(rows.shape[0], device=wd.device)[:, None] * bins
    # A fixed-size scatter, not bincount: bincount sizes its output from the
    # data and so waits for the device.
    hist = torch.zeros(rows.shape[0] * bins, dtype=torch.int64,
                       device=wd.device)
    hist.scatter_add_(0, (rows + offs).reshape(-1), torch.ones_like(
        rows).reshape(-1))
    counts = hist.reshape(-1, bins).cumsum(dim=-1)
    reached = counts >= k
    # First level whose cumulative count reaches k, else ``bins`` (keep all).
    thresh = torch.where(reached.any(dim=-1),
                         torch.argmax(reached.to(torch.uint8), dim=-1),
                         torch.full_like(counts[:, 0], bins))
    thresh = thresh.reshape(wd.shape[:-1] + (1,)).to(v.dtype)
    return (v <= thresh).to(wd.dtype)


def topk_count(n: int, fraction: float) -> int:
    """The exact-count selection's k for rows of ``n``: ``max(int(n *
    fraction), 1)`` in Python float64, from the static fraction, as the JAX
    package forms it (select.py:68). It may exceed ``n`` (every entry is
    then kept)."""
    return max(int(n * float(fraction)), 1)


def topk_mask(wd, fraction: float):
    """0/1 float mask of exactly ``topk_count(N, fraction)`` smallest
    values of ``wd`` along its last axis (every value where that exceeds
    N); leading axes are independent rows.

    ``jax.lax.top_k(-wd, k)`` puts equal values in index order, lowest index
    first, and warp diffs tie on flat content; ``torch.topk`` promises no
    order for ties. A stable ascending sort does keep index order among
    equal values, so its first k indices are JAX's set.
    """
    k = topk_count(wd.shape[-1], fraction)
    order = torch.sort(wd, dim=-1, stable=True).indices[..., :k]
    mask = torch.zeros_like(wd)
    return mask.scatter_(-1, order, 1.0)
