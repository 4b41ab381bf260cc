"""Per-tile sampling windows: sparse Lanczos2 sampling without random access
into the keyframe image.

Keypoints live one per tile, so once per keyframe a (P, P) window around
every tile is cut out (P = tile + 2*margin, repeat-edge padded) and each
warped sample becomes a weighted sum inside its own window. The port
stores them keypoint-major, (N, P, P) with N = Ht*Wt: window n is P rows of
P contiguous bytes, the order of the JAX package's ``extract_tile_windows``
(patches.py:41, (Ht, Wt, P, P)) with (Ht, Wt) flattened. A keypoint's 4x4
Lanczos2 taps are then 4 short rows of one window, a few 32-byte sectors on
the card. (The JAX package's ``extract_tile_windows_flat`` puts N on the
minor axis, (P, P, N), for the TPU's 128 lanes; there each tap of a
keypoint lies N bytes from the next. The checkpoint file keeps that
layout: ``utils/checkpoint.py`` converts.) The tile-grid layout (..., Ht,
Wt, P, P) of ``extract_tile_windows`` and its dense-weight sampler
``sample_windows`` are the gather-free oracles of ``ops/sparse.py``'s
``*_windows`` forms, as in the JAX package (patches.py:41-238).
"""

from __future__ import annotations

import torch

from video_stabilizer_tpu_torch.ops.lanczos import lanczos2
from video_stabilizer_tpu_torch.ops.pyr_down import pad_edge

# Lanczos2 taps with a possibly non-zero weight around a position r:
# floor(r) - 1 .. floor(r) + 2 (|tap - r| < 2). Every other tap of the
# window has weight exactly 0 and contributes an exact 0 to the sums.
NTAPS = 4


def window_size(tile: int, margin: int) -> int:
    return tile + 2 * margin


def _tile_windows(img, tile: int, margin: int):
    """(..., H, W) -> (..., Ht, Wt, P, P) view: window (i, j) covers padded
    rows [i*tile, i*tile + P) and columns [j*tile, j*tile + P) of the image
    edge-padded by (margin, margin + tile)."""
    h, w = img.shape[-2], img.shape[-1]
    t = tile
    p = window_size(t, margin)
    padded = pad_edge(img, margin, margin + t, margin, margin + t)
    wins = padded.unfold(-2, p, t).unfold(-2, p, t)   # (..., nI, nJ, P, P)
    return wins[..., :h // t, :w // t, :, :]


def extract_tile_windows_flat(img, tile: int, margin: int):
    """(..., H, W) u8 -> (..., Ht*Wt, P, P) u8 windows, keypoint-major: the
    same pixels, bit for bit, as the JAX package's (P, P, Ht*Wt) one-hot
    matmul construction with its tile axis moved first."""
    wins = _tile_windows(img, tile, margin)
    p = wins.shape[-1]
    return wins.reshape(wins.shape[:-4] + (-1, p, p)).contiguous()


def extract_tile_windows(img, tile: int, margin: int,
                         out_dtype=torch.bfloat16):
    """(..., H, W) u8 -> (..., Ht, Wt, P, P) windows, P = tile + 2*margin:
    window (i, j) covers rows [i*tile - margin, i*tile - margin + P) and
    the same columns of the edge-padded image (patches.py:41-53). u8 values
    are exact in bfloat16, the default storage."""
    return _tile_windows(img, tile, margin).to(out_dtype).contiguous()


def window_origins(ht: int, wt: int, tile: int, margin: int, device=None):
    """Image (x, y) of each window's [0, 0] corner as (Ht, Wt) grids
    (patches.py:180-186)."""
    oy = torch.arange(ht, dtype=torch.float32, device=device) * tile - margin
    ox = torch.arange(wt, dtype=torch.float32, device=device) * tile - margin
    return ox[None, :].expand(ht, wt), oy[:, None].expand(ht, wt)


def sample_windows(windows, rel_x, rel_y):
    """Weight-normalized Lanczos2 sample of (..., Ht, Wt, P, P) windows at
    window positions (..., Ht, Wt), pre-clamped to [2, P - 3): dense
    float32 weights over all P taps of each axis, zero beyond radius 2
    (patches.py:189-211)."""
    p = windows.shape[-1]
    taps = torch.arange(p, dtype=torch.float32, device=windows.device)
    wy = lanczos2(taps - rel_y[..., None].to(torch.float32))
    wx = lanczos2(taps - rel_x[..., None].to(torch.float32))
    num = (windows.to(torch.float32) * wy[..., :, None]
           * wx[..., None, :]).sum(dim=(-2, -1))
    den = wy.sum(dim=-1) * wx.sum(dim=-1)
    return num / den


def warp_rel_positions(coords, t_ul, ox, oy, p: int):
    """Warped window positions (rel_x, rel_y) (..., Ht, Wt) of integer
    keypoint ``coords`` (..., Ht, Wt, 2) under the origin-based ``t_ul``
    (4,), clamped to the window interior (patches.py:220-238)."""
    fx = coords[..., 0].to(torch.float32)
    fy = coords[..., 1].to(torch.float32)
    return warp_rel_positions_flat(fx, fy, t_ul, ox, oy, p)


def window_origins_flat(ht: int, wt: int, tile: int, margin: int,
                        device=None):
    """Flat (Ht*Wt,) image (x, y) of each window's [0, 0] corner."""
    ox, oy = window_origins(ht, wt, tile, margin, device)
    return ox.reshape(-1), oy.reshape(-1)


def clamp_rel(rel, p: int):
    """Clamp a window-relative position so all Lanczos taps stay inside:
    [2, p - 3) with a hair of room so floor() stays in range."""
    return torch.clamp(rel, 2.0, p - 3.0 - 1e-3)


def warp_rel_positions_flat(fx, fy, t_ul, ox, oy, p: int):
    """Warped window positions of keypoints (fx, fy) (..., N) under the
    origin-based ``t_ul`` (..., 4), whose leading axes broadcast against
    the keypoints' with trailing singleton axes added by the caller."""
    a, b, tx, ty = t_ul[..., 0], t_ul[..., 1], t_ul[..., 2], t_ul[..., 3]
    wx = (1.0 + a) * fx - b * fy + tx
    wy = b * fx + (1.0 + a) * fy + ty
    return clamp_rel(wx - ox, p), clamp_rel(wy - oy, p)


def tap_weights(rel):
    """(first tap (int64), (..., NTAPS) Lanczos2 weights) of positions
    ``rel`` (...,) already clamped to the window interior."""
    first = torch.floor(rel).to(torch.int64) - 1
    taps = first[..., None] + torch.arange(NTAPS, device=rel.device)
    return first, lanczos2(taps.to(torch.float32) - rel[..., None])


def sample_windows_flat(windows, rel_x, rel_y, key_index=None):
    """Weight-normalized Lanczos2 sample of the (N, P, P) windows.

    Args:
      windows: (N, P, P) u8, or (K, N, P, P) u8 with ``key_index``.
      rel_x, rel_y: (..., N) clamped window positions.
      key_index: with stacked windows, a (...,) int64 tensor naming the
        window stack each row of positions samples (broadcast over the
        positions' leading axes).

    The products run in bf16 — (window * wy) then * wx, each rounded to
    bf16 as in ``patches.sample_windows_flat`` (patches.py:157-162) — and
    the sums in float32. Only the 4x4 taps that can carry weight are read.
    """
    n, p = windows.shape[-3], windows.shape[-1]
    y0, wy = tap_weights(rel_y)                        # (..., N, 4)
    x0, wx = tap_weights(rel_x)
    ar = torch.arange(NTAPS, device=windows.device)
    rows = y0[..., :, None] + ar                       # (..., N, 4)
    cols = x0[..., :, None] + ar
    nidx = torch.arange(n, device=windows.device)
    flat = (nidx[:, None, None] * p + rows[..., :, :, None]) * p \
        + cols[..., :, None, :]                        # (..., N, 4, 4)
    if key_index is not None:
        kidx = key_index.reshape(key_index.shape
                                 + (1,) * (flat.dim() - key_index.dim()))
        flat = flat + kidx * (n * p * p)
    vals = windows.reshape(-1)[flat.reshape(-1)].reshape(flat.shape)
    bf = torch.bfloat16
    prod = (vals.to(bf) * wy[..., :, None].to(bf)) * wx[..., None, :].to(bf)
    num = prod.to(torch.float32).sum(dim=(-2, -1))
    den = wy.sum(dim=-1) * wx.sum(dim=-1)
    return num / den
