"""Per-tile gradient-argmax keypoint selection (the ``grad_argmax`` Halide
generator, generators.cpp:260-326).

Tie order: the first maximum in row-major order within the tile (rows
slowest), like the reference's RDom scan (r.y outer, r.x inner). The JAX
package's two-stage reduction yields the same index; here the tile is
flattened row-major and ``torch.argmax`` returns the first maximal index on
the CPU and on CUDA.
"""

from __future__ import annotations

import torch


def tile_view(img, tile_size: int):
    """(..., H, W) -> (..., Ht, Wt, t*t) row-major tile view, cropping the
    bottom/right remainders (imgproc.cpp:164-165)."""
    t = tile_size
    h, w = img.shape[-2], img.shape[-1]
    ht, wt = h // t, w // t
    x = img[..., : ht * t, : wt * t]
    x = x.reshape(x.shape[:-2] + (ht, t, wt, t)).transpose(-3, -2)
    return x.reshape(x.shape[:-2] + (t * t,))


def grad_argmax(grad_x, grad_y, tile_size: int):
    """Per-tile argmax of |grad|, separately for X and Y gradients.

    Returns (idx_x, coords_x, idx_y, coords_y): idx_* (..., Ht, Wt) int32
    flat within-tile argmax, coords_* (..., Ht, Wt, 2) int32 absolute (x, y).
    """
    t = tile_size
    h, w = grad_x.shape[-2], grad_x.shape[-1]
    ht, wt = h // t, w // t
    dev = grad_x.device
    g = torch.abs(torch.stack([grad_x, grad_y]))
    idx = torch.argmax(tile_view(g, t), dim=-1).to(torch.int32)
    ty = torch.arange(ht, dtype=torch.int32, device=dev)[:, None]
    tx = torch.arange(wt, dtype=torch.int32, device=dev)[None, :]
    coords = torch.stack([tx * t + idx % t, ty * t + idx // t], dim=-1)
    return idx[0], coords[0], idx[1], coords[1]


def tile_argmax_flat_index(idx, width: int, tile_size: int):
    """Flat ``y * W + x`` image index of each tile's argmax pixel."""
    t = tile_size
    ht, wt = idx.shape[-2], idx.shape[-1]
    dev = idx.device
    ty = torch.arange(ht, dtype=torch.int64, device=dev)[:, None]
    tx = torch.arange(wt, dtype=torch.int64, device=dev)[None, :]
    idx = idx.to(torch.int64)
    return (ty * t + idx // t) * width + tx * t + idx % t


def take_at_tile_argmax(img, idx, tile_size: int):
    """Read ``img`` (..., H, W) at each tile's argmax (``idx`` (..., Ht, Wt),
    leading axes broadcast) as float32 (..., Ht, Wt)."""
    h, w = img.shape[-2], img.shape[-1]
    flat_pos = tile_argmax_flat_index(idx, w, tile_size)
    lead = torch.broadcast_shapes(img.shape[:-2], idx.shape[:-2])
    flat_img = img.expand(lead + (h, w)).reshape(lead + (h * w,))
    pos = flat_pos.expand(lead + flat_pos.shape[-2:])
    vals = torch.gather(flat_img, -1, pos.reshape(lead + (-1,)))
    return vals.reshape(pos.shape).to(torch.float32)
