"""The global-base separable FIR output warp (``output_warp="fir"``).

Port of ``video_stabilizer_tpu.ops.fast_warp`` (fast_warp.py:42-174), in
plain PyTorch: there it is an XLA program, not a Pallas kernel. Per frame:

1. The bulk displacement, the sampling position's offset at the frame
   centre rounded to an integer and clipped to +-(max_shift - halo), is
   removed by reading a zero-padded window of the source at that offset.
2. The residual per-pixel displacement, clamped to +-residual_bound, is
   interpolated by a y pass and then an x pass over 2m+2 (bilinear) or
   2m+5 (Lanczos2) shifted slices, each pixel with its own weights. The y
   pass's output is rounded to bfloat16 where the JAX package rounds it
   (fast_warp.py:114-117), so u8 integers pass exactly and a subpixel
   sample loses under half an intensity level.

Every function takes frames on a leading batch axis as well; each frame has
its own bulk shift. The read of the shifted window is an index gather, so
nothing here waits for the device.
"""

from __future__ import annotations

import torch

from video_stabilizer_tpu_torch import homography as Hm
from video_stabilizer_tpu_torch.ops.lanczos import lanczos2
from video_stabilizer_tpu_torch.ops.warp import similarity_field


def _hat(t):
    """Bilinear weight: the unit hat function."""
    return torch.clamp(1.0 - torch.abs(t), min=0.0)


def _shifted_window(img, k0y, k0x, rows: int, cols: int, halo: int):
    """(B, rows, cols, C) window of the zero-bordered (B, H, W, C) ``img``
    whose [halo, halo] pixel is img[k0y, k0x] (per frame)."""
    bsz, h, w, _ = img.shape
    dev = img.device
    r = k0y[:, None] - halo + torch.arange(rows, device=dev)       # (B, rows)
    c = k0x[:, None] - halo + torch.arange(cols, device=dev)       # (B, cols)
    inside = (((r >= 0) & (r < h))[:, :, None]
              & ((c >= 0) & (c < w))[:, None, :])
    b = torch.arange(bsz, device=dev)[:, None, None]
    win = img[b, r.clamp(0, h - 1)[:, :, None], c.clamp(0, w - 1)[:, None, :]]
    return win * inside[..., None].to(win.dtype)


def warp_field_fast(img, wx, wy, interp: str = "bilinear",
                    residual_bound: int = 8, max_shift: int = 192,
                    out_dtype=torch.uint8):
    """dst(p) = interp(img, (wx(p), wy(p))) with zero border, gather-free
    per tap (fast_warp.py:42-137).

    Args:
      img: (H, W) or (H, W, C) u8 image, or (B, H, W, C) frames.
      wx, wy: (H, W) (or (B, H, W)) float32 sample positions per output
        pixel.
      interp: "bilinear" or "lanczos2".
      residual_bound: bound m on the per-pixel displacement after the bulk
        shift (taps span [-m, m+1], Lanczos2 two more each side).
      max_shift: bound on the bulk integer shift (pixels).
    Returns:
      the warped image, shaped as ``img``, in ``out_dtype``.
    """
    single = wx.dim() == 2
    if single:
        img, wx, wy = img[None], wx[None], wy[None]
    gray = img.dim() == 3
    if gray:
        img = img[..., None]
    _, h, w, _ = img.shape
    m = residual_bound
    halo = m + 2
    f32 = torch.float32
    dev = img.device

    # Bulk integer shift = the warp's displacement at the image centre.
    cx, cy = (w - 1) // 2, (h - 1) // 2
    lim = float(max_shift - halo)
    k0x = torch.clamp(torch.round(wx[:, cy, cx] - cx), -lim, lim)
    k0y = torch.clamp(torch.round(wy[:, cy, cx] - cy), -lim, lim)
    base = _shifted_window(img, k0y.to(torch.int64), k0x.to(torch.int64),
                           h + 2 * halo, w + 2 * halo, halo)

    # Residual positions; wy edge-extended by halo columns so the y pass
    # covers the x pass's taps (fast_warp.py:101-106).
    ys = torch.arange(h, dtype=f32, device=dev)[:, None]
    xs = torch.arange(w, dtype=f32, device=dev)[None, :]
    wy = wy.to(f32)
    wy_ext = torch.cat([wy[..., :1].expand(-1, -1, halo), wy,
                        wy[..., -1:].expand(-1, -1, halo)], dim=-1)
    ry_ext = torch.clamp(wy_ext - ys - k0y[:, None, None], -m, m)

    lanczos = interp != "bilinear"
    weight = lanczos2 if lanczos else _hat
    lo = -m - (2 if lanczos else 0)
    hi = m + (3 if lanczos else 2)

    # Y pass: tmp[y, x'] = sum_d weight(ry[y, x'] - d) * base[y + d, x'].
    tmp = torch.zeros(base.shape[:1] + (h,) + base.shape[2:], dtype=f32,
                      device=dev)
    den_y = torch.zeros_like(ry_ext) if lanczos else None
    for d in range(lo, hi):
        wgt = weight(ry_ext - d)
        tmp = tmp + wgt[..., None] * base[:, halo + d:halo + d + h].to(f32)
        if lanczos:
            den_y = den_y + wgt
    tmp = tmp.to(torch.bfloat16)

    # X pass: out[y, x] = sum_e weight(rx[y, x] - e) * tmp[y, x + e].
    rx = torch.clamp(wx.to(f32) - xs - k0x[:, None, None], -m, m)
    out = torch.zeros(tmp.shape[:2] + (w,) + tmp.shape[3:], dtype=f32,
                      device=dev)
    den_x = torch.zeros_like(rx) if lanczos else None
    for e in range(lo, hi):
        wgt = weight(rx - e)
        out = out + wgt[..., None] * tmp[:, :, halo + e:halo + e + w].to(f32)
        if lanczos:
            den_x = den_x + wgt * den_y[:, :, halo + e:halo + e + w]
    if lanczos:
        out = out / torch.clamp(den_x[..., None] * 1.0, min=1e-6)

    if not out_dtype.is_floating_point:
        info = torch.iinfo(out_dtype)
        out = torch.clamp(torch.round(out), info.min, info.max)
    out = out.to(out_dtype)
    if gray:
        out = out[..., 0]
    return out[0] if single else out


def homography_field(p, height: int, width: int):
    """(wx, wy) (..., H, W) sample positions of the normalized sampling
    homographies ``p`` (..., 8) (fast_warp.py:165-171)."""
    f32 = torch.float32
    ys = torch.arange(height, dtype=f32, device=p.device)
    xs = torch.arange(width, dtype=f32, device=p.device)
    grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)
    warped = Hm.warp_points(p[..., None, None, :], grid, width, height)
    return warped[..., 0], warped[..., 1]


def warp_image_fast(img, t_sample_ul, interp: str = "bilinear",
                    residual_bound: int = 8, max_shift: int = 192,
                    out_dtype=torch.uint8):
    """Similarity wrapper: dst(p) = interp(img, T(p)) with the origin-based
    sampling transform ``t_sample_ul`` (4,), or (B, 4) for (B, H, W, C)
    frames."""
    lead = t_sample_ul.dim() - 1
    h, w = img.shape[lead], img.shape[lead + 1]
    wx, wy = similarity_field(t_sample_ul, h, w)
    return warp_field_fast(img, wx, wy, interp=interp,
                           residual_bound=residual_bound,
                           max_shift=max_shift, out_dtype=out_dtype)


def warp_homography_fast(img, p, interp: str = "bilinear",
                         residual_bound: int = 8, max_shift: int = 192,
                         out_dtype=torch.uint8):
    """Homography wrapper: ``p`` is the (8,) normalized sampling homography
    (``homography.py``), or (B, 8) for (B, H, W, C) frames."""
    lead = p.dim() - 1
    h, w = img.shape[lead], img.shape[lead + 1]
    wx, wy = homography_field(p, h, w)
    return warp_field_fast(img, wx, wy, interp=interp,
                           residual_bound=residual_bound,
                           max_shift=max_shift, out_dtype=out_dtype)
