"""Dense whole-image warps by gather: the oracles of the output warps.

Port of ``video_stabilizer_tpu.ops.warp`` (warp.py:1-175):

- ``image_warp_ul`` / ``image_warp``: the reference's ``image_warp`` Halide
  generator (generators.cpp:126-196), a backward-sampling bilinear warp
  with repeat-edge border, u8 -> float32; the wrapper converts centre-pivot
  TX/TY with the (W-1)/2 convention (imgproc.cpp:125-131).
- ``warp_image_bgr`` / ``warp_by_similarity_transform``: the output-stage
  colour warp, bilinear (cv::warpAffine INTER_LINEAR parity,
  imgproc.cpp:446-484) or weight-normalized 5x5 Lanczos2, with a zero
  (cv::BORDER_CONSTANT) or edge border. Kernel A and the FIR warp
  (``ops/fast_warp.py``) are held to these.

Every function also takes a leading batch axis: (B, 4) transforms warp
(B, H, W[, C]) frames, each by its own. Each tap is one gather over the
frame, so memory stays at a few frame-sized tensors.
"""

from __future__ import annotations

import torch

from video_stabilizer_tpu_torch import transforms
from video_stabilizer_tpu_torch.ops.lanczos import lanczos2_weights_5tap


def similarity_field(t_ul, height: int, width: int):
    """Backward-sample positions (wx, wy) (..., H, W) of every output pixel
    under the origin-based (..., 4) ``t_ul`` (warp.py:33-52,
    fast_warp.py:147-155)."""
    f32 = torch.float32
    dev = t_ul.device
    x = torch.arange(width, dtype=f32, device=dev)[None, :]
    y = torch.arange(height, dtype=f32, device=dev)[:, None]
    a, b, tx, ty = (t_ul[..., k, None, None].to(f32) for k in range(4))
    return (1.0 + a) * x - b * y + tx, b * x + (1.0 + a) * y + ty


def _tap(img_f, yi, xi, border: str):
    """img_f (..., H, W) at integer (yi, xi) (..., H', W'): clamped to the
    frame, or 0 outside it for ``border == "zero"``."""
    h, w = img_f.shape[-2], img_f.shape[-1]
    idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
    lead = torch.broadcast_shapes(img_f.shape[:-2], idx.shape[:-2])
    flat = img_f.reshape(img_f.shape[:-2] + (h * w,)).expand(lead + (h * w,))
    v = torch.gather(flat, -1, idx.expand(lead + idx.shape[-2:]).reshape(
        lead + (-1,))).reshape(lead + idx.shape[-2:])
    if border == "zero":
        inside = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        v = torch.where(inside, v, torch.zeros_like(v))
    return v


def _bilinear_sample(img_f, wx, wy, border: str):
    """Bilinear sample of (..., H, W) float ``img_f`` at (wx, wy)
    (warp.py:55-87)."""
    x0f, y0f = torch.floor(wx), torch.floor(wy)
    fx, fy = wx - x0f, wy - y0f
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    v00 = _tap(img_f, y0, x0, border)
    v01 = _tap(img_f, y0, x0 + 1, border)
    v10 = _tap(img_f, y0 + 1, x0, border)
    v11 = _tap(img_f, y0 + 1, x0 + 1, border)
    top = v00 + (v01 - v00) * fx
    bot = v10 + (v11 - v10) * fx
    return top + (bot - top) * fy


def _lanczos_sample(img_f, wx, wy, border: str):
    """Weight-normalized 5x5 Lanczos2 sample of (..., H, W) float
    ``img_f`` at (wx, wy) (warp.py:90-105), tap by tap."""
    x0f, y0f = torch.floor(wx), torch.floor(wy)
    weights_x = lanczos2_weights_5tap(wx - x0f)          # (..., H', W', 5)
    weights_y = lanczos2_weights_5tap(wy - y0f)
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    num = den = 0.0
    for u in range(5):
        for v in range(5):
            w2d = weights_y[..., u] * weights_x[..., v]
            num = num + w2d * _tap(img_f, y0 + (u - 2), x0 + (v - 2), border)
            den = den + w2d
    return num / den


def image_warp_ul(img, t_ul, out_dtype=torch.float32):
    """output(p) = bilinear(input, W(p)), repeat-edge, W origin-based
    (generators.cpp:139-163). (..., H, W) u8 -> (..., H, W) ``out_dtype``."""
    h, w = img.shape[-2], img.shape[-1]
    wx, wy = similarity_field(t_ul, h, w)
    return _bilinear_sample(img.to(torch.float32), wx, wy,
                            "edge").to(out_dtype)


def image_warp(img, t_center, out_dtype=torch.float32):
    """Centre-pivot wrapper, (W-1)/2 convention (imgproc.cpp:116-133)."""
    h, w = img.shape[-2], img.shape[-1]
    t_ul = transforms.center_to_ul(t_center, w, h, minus_one=True)
    return image_warp_ul(img, t_ul, out_dtype=out_dtype)


def warp_field_bgr(img, wx, wy, interp: str = "bilinear",
                   border: str = "zero", out_dtype=torch.uint8):
    """dst(p) = interp(src, (wx(p), wy(p))) for any field of sample
    positions (..., H, W): the gather oracle of every output warp, the
    homography's too.

    Args:
      img: (H, W) or (H, W, C) u8; with batched fields (B, H, W[, C]).
      interp: "bilinear" (reference parity) or "lanczos2".
      border: "zero" (cv::BORDER_CONSTANT parity) or "edge".
    Returns:
      the warped image, shaped as ``img``, in ``out_dtype`` (an integer
      type rounds half to even and clips).
    """
    squeeze = img.dim() == wx.dim()
    if squeeze:
        img = img[..., None]
    sample = _bilinear_sample if interp == "bilinear" else _lanczos_sample
    chans = [sample(img[..., k].to(torch.float32), wx, wy, border)
             for k in range(img.shape[-1])]
    out = torch.stack(chans, dim=-1)
    if not out_dtype.is_floating_point:
        info = torch.iinfo(out_dtype)
        out = torch.clamp(torch.round(out), info.min, info.max)
    out = out.to(out_dtype)
    return out[..., 0] if squeeze else out


def warp_image_bgr(img, t_sample_ul, interp: str = "bilinear",
                   border: str = "zero", out_dtype=torch.uint8):
    """dst(p) = interp(src, T_sample(p)) (warp.py:132-162).

    Args:
      img: (H, W) or (H, W, C) u8; with (B, 4) transforms (B, H, W[, C]).
      t_sample_ul: (4,) or (B, 4) origin-based sampling transforms.
      interp: "bilinear" (reference parity) or "lanczos2".
      border: "zero" (cv::BORDER_CONSTANT parity) or "edge".
    """
    lead = t_sample_ul.dim() - 1
    wx, wy = similarity_field(t_sample_ul, img.shape[lead],
                              img.shape[lead + 1])
    return warp_field_bgr(img, wx, wy, interp=interp, border=border,
                          out_dtype=out_dtype)


def warp_by_similarity_transform(img, t_center, interp: str = "bilinear",
                                 out_dtype=torch.uint8):
    """``warpBySimilarityTransform(src, T)`` (imgproc.cpp:446-484): dst(p) =
    src(T^-1(p)), T centre-pivot with the (W-1)/2 convention, zero
    border."""
    lead = t_center.dim() - 1
    h, w = img.shape[lead], img.shape[lead + 1]
    t_ul = transforms.center_to_ul(t_center, w, h, minus_one=True)
    return warp_image_bgr(img, transforms.inverse(t_ul), interp=interp,
                          border="zero", out_dtype=out_dtype)
