"""Central-difference image gradients (the ``grad_xy`` Halide generator,
generators.cpp:202-254) with repeat-edge boundary."""

from __future__ import annotations

import torch

from video_stabilizer_tpu_torch.ops.pyr_down import pad_edge


def grad_xy(img):
    """(grad_x, grad_y) of a (..., H, W) u8 image as float32."""
    p = pad_edge(img, 1, 1, 1, 1).to(torch.float32)
    gx = 0.5 * (p[..., 1:-1, 2:] - p[..., 1:-1, :-2])
    gy = 0.5 * (p[..., 2:, 1:-1] - p[..., :-2, 1:-1])
    return gx, gy
