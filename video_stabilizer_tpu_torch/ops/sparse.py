"""The sparse inverse-compositional LK kernel chain, by gather: the oracles
of the reference's ``sparse_jac`` / ``sparse_warpdiff`` / ``sparse_ica``
Halide generators (generators.cpp:332-423, 646-739, 429-640).

Port of ``video_stabilizer_tpu.ops.sparse`` (sparse.py:31-202). Keypoints
sit one per tile on the (Ht, Wt) grid; a warped keypoint is sampled with a
weight-normalized 5x5 Lanczos2 patch, repeat-edge at the image border. The
``*_windows`` forms sample the pre-extracted per-tile windows of
``ops/patches.py`` instead of the image; the level loop
(``models/aligner.py``) uses their flat-layout counterparts.

The ICA right-hand side carries the reference's implicit 1/4 step damping:
Jacobian rows with a factor 2 and the average of the X and Y sets.
"""

from __future__ import annotations

import torch

from video_stabilizer_tpu_torch.ops.lanczos import lanczos2_weights_5tap
from video_stabilizer_tpu_torch.ops.patches import (
    sample_windows, warp_rel_positions)


def sparse_jacobian(gval_x, gval_y, coords_x, coords_y, width, height,
                    dtype=torch.float32):
    """Per-keypoint steepest-descent rows (jac_x, jac_y), each
    (..., Ht, Wt, 4) (generators.cpp:332-423): X keypoints use grad_x
    only, Y keypoints grad_y only; (u, v) from the centre (W*0.5, H*0.5);
    A/B rows scaled by 1/width; every row times 2.

    Args:
      gval_x, gval_y: (..., Ht, Wt) gradients at each set's argmax pixels.
      coords_x, coords_y: (..., Ht, Wt, 2) integer (x, y) coordinates.
    """
    cx, cy = width * 0.5, height * 0.5
    scale = 1.0 / width

    def rows(gval, coords, is_x):
        g = gval.to(dtype)
        u = coords[..., 0].to(dtype) - cx
        v = coords[..., 1].to(dtype) - cy
        zero = torch.zeros_like(g)
        if is_x:
            return torch.stack([2.0 * g * u * scale, 2.0 * g * (-v) * scale,
                                2.0 * g, zero], dim=-1)
        return torch.stack([2.0 * g * v * scale, 2.0 * g * u * scale, zero,
                            2.0 * g], dim=-1)

    return rows(gval_x, coords_x, True), rows(gval_y, coords_y, False)


def sparse_warp_sample(keyframe, coords, t_ul):
    """Lanczos2 resample of the (H, W) u8 ``keyframe`` at the warped
    positions of integer ``coords`` (..., 2) under the origin-based
    ``t_ul`` (4,), repeat-edge (generators.cpp:459-498). Returns (...,)
    float32."""
    h, w = keyframe.shape[-2], keyframe.shape[-1]
    f32 = torch.float32
    ox = coords[..., 0].to(f32)
    oy = coords[..., 1].to(f32)
    a, b, tx, ty = t_ul[0], t_ul[1], t_ul[2], t_ul[3]
    wx = (1.0 + a) * ox - b * oy + tx
    wy = b * ox + (1.0 + a) * oy + ty
    x0f, y0f = torch.floor(wx), torch.floor(wy)
    weights_x = lanczos2_weights_5tap(wx - x0f)                    # (..., 5)
    weights_y = lanczos2_weights_5tap(wy - y0f)
    offs = torch.arange(-2, 3, device=keyframe.device)
    xs = torch.clamp(x0f.to(torch.int64)[..., None] + offs, 0, w - 1)
    ys = torch.clamp(y0f.to(torch.int64)[..., None] + offs, 0, h - 1)
    patch = keyframe[ys[..., :, None], xs[..., None, :]].to(f32)  # (..., 5, 5)
    w2d = weights_y[..., :, None] * weights_x[..., None, :]
    return (w2d * patch).sum(dim=(-2, -1)) / w2d.sum(dim=(-2, -1))


def sparse_warpdiff(template_vals, keyframe, coords, t_ul):
    """|warped keyframe - template| (..., Ht, Wt) float32 per keypoint
    (generators.cpp:646-739): the outlier-rejection signal."""
    warped = sparse_warp_sample(keyframe, coords, t_ul)
    return torch.abs(warped - template_vals.to(torch.float32))


def _ica_set(warped, template_vals, jac, mask, dtype):
    residual = (template_vals.to(torch.float32) - warped) * mask
    return (jac.to(dtype) * residual.to(dtype)[..., None]).reshape(
        -1, jac.shape[-1]).sum(dim=0)


def sparse_ica(template_vals_x, template_vals_y, keyframe, coords_x,
               coords_y, jac_x, jac_y, mask_x, mask_y, t_ul,
               dtype=torch.float32):
    """GN right-hand side (4,): the mean over the X and Y sets of
    sum(J^T (template - warped)) over the selected keypoints
    (generators.cpp:429-640, the set average at :595)."""
    rx = _ica_set(sparse_warp_sample(keyframe, coords_x, t_ul),
                  template_vals_x, jac_x, mask_x, dtype)
    ry = _ica_set(sparse_warp_sample(keyframe, coords_y, t_ul),
                  template_vals_y, jac_y, mask_y, dtype)
    return (rx + ry) * 0.5


def _window_sample(windows, coords, t_ul, ox, oy):
    rel_x, rel_y = warp_rel_positions(coords, t_ul, ox, oy,
                                      windows.shape[-1])
    return sample_windows(windows, rel_x, rel_y)


def sparse_warpdiff_windows(template_vals, windows, coords, t_ul, ox, oy):
    """``sparse_warpdiff`` sampling the (Ht, Wt, P, P) keyframe windows
    with origins (ox, oy) (Ht, Wt) instead of the image."""
    warped = _window_sample(windows, coords, t_ul, ox, oy)
    return torch.abs(warped - template_vals.to(torch.float32))


def sparse_ica_windows(template_vals_x, template_vals_y, windows, coords_x,
                       coords_y, jac_x, jac_y, mask_x, mask_y, t_ul, ox, oy,
                       dtype=torch.float32):
    """``sparse_ica`` sampling the keyframe windows instead of the image."""
    rx = _ica_set(_window_sample(windows, coords_x, t_ul, ox, oy),
                  template_vals_x, jac_x, mask_x, dtype)
    ry = _ica_set(_window_sample(windows, coords_y, t_ul, ox, oy),
                  template_vals_y, jac_y, mask_y, dtype)
    return (rx + ry) * 0.5
