"""Gaussian pyramid downsample (the ``pyr_down`` Halide generator,
generators.cpp:56-120): separable [1,4,6,4,1]/16 with repeat-edge boundary,
then 2x decimation, truncating u8 cast.

Computed in exact integer arithmetic: the 5x5 stencil has integer weights
c_i*c_j summing to 256, so ``out = floor(sum / 256)`` equals the reference's
float blur followed by its truncating cast bit for bit.
"""

from __future__ import annotations

import torch

_TAPS = (1, 4, 6, 4, 1)


def pad_edge(img, top: int, bottom: int, left: int, right: int):
    """Repeat-edge pad of the last two axes (any dtype, any leading axes)."""
    h, w = img.shape[-2], img.shape[-1]
    rows = torch.arange(-top, h + bottom, device=img.device).clamp_(0, h - 1)
    cols = torch.arange(-left, w + right, device=img.device).clamp_(0, w - 1)
    return img.index_select(-2, rows).index_select(-1, cols)


def pyr_down(img):
    """(..., H, W) u8 -> (..., H//2, W//2) u8."""
    h, w = img.shape[-2], img.shape[-1]
    h2, w2 = h // 2, w // 2
    x = pad_edge(img, 2, 2, 2, 2).to(torch.int32)
    tmp = sum(c * x[..., :, j:j + 2 * w2:2] for j, c in enumerate(_TAPS))
    out = sum(c * tmp[..., i:i + 2 * h2:2, :] for i, c in enumerate(_TAPS))
    return torch.div(out, 256, rounding_mode="floor").to(torch.uint8)


def build_pyramid(frame, num_levels: int):
    """Level 0 is the input; each next level is pyr_down of the previous
    (alignment.cpp:217-223). Returns a list of ``num_levels`` tensors."""
    levels = [frame]
    for _ in range(num_levels - 1):
        levels.append(pyr_down(levels[-1]))
    return levels
