"""Colour conversion of the stabilizer's input frames."""

from __future__ import annotations

import torch


def bgr_to_gray(frame_bgr):
    """BGR u8 (..., 3) -> gray u8 (...): round(0.114*B + 0.587*G + 0.299*R)
    in float32, half to even (``video_stabilizer_tpu.models.stabilizer.
    bgr_to_gray``, stabilizer.py:86-99; torch.round is half to even like
    jnp.round)."""
    b = frame_bgr[..., 0].to(torch.float32)
    g = frame_bgr[..., 1].to(torch.float32)
    r = frame_bgr[..., 2].to(torch.float32)
    return torch.round(0.114 * b + 0.587 * g + 0.299 * r).to(torch.uint8)


def bgr_to_gray_batched(frames):
    """Convert iff a channel axis of 3 is present."""
    if frames.shape[-1] != 3:
        return frames
    return bgr_to_gray(frames)
