"""Gaussian pyramid downsample (the ``pyr_down`` Halide generator,
generators.cpp:56-120): separable [1,4,6,4,1]/16 with repeat-edge boundary,
then 2x decimation, truncating u8 cast. Kernel H of the port.

Computed in exact integer arithmetic: the 5x5 stencil has integer weights
c_i*c_j summing to 256, so ``out = floor(sum / 256)`` equals the reference's
float blur followed by its truncating cast bit for bit.

``pyr_down_kernel`` launches ``csrc/pyr_down.cu`` for CUDA tensors: one
launch a level over all frames, by its wide engine on a large level and
its narrow one on a small level. It replaces the JAX package's XLA stage
``video_stabilizer_tpu/ops/pyr_down.py::pyr_down`` (not a Pallas kernel);
see the source note in ``csrc/pyr_down.cu`` for the bound and the design.
``pyr_down_plain`` is the same stencil in plain PyTorch (about 29 kernels
a level): the CPU path and the card's reference, never the main path on a
card. ``pyr_down`` and ``build_pyramid`` dispatch between the two by
device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from video_stabilizer_tpu_torch.ops import cuda_build

_TAPS = (1, 4, 6, 4, 1)


def pad_edge(img, top: int, bottom: int, left: int, right: int):
    """Repeat-edge pad of the last two axes (any dtype, any leading axes)."""
    h, w = img.shape[-2], img.shape[-1]
    rows = torch.arange(-top, h + bottom, device=img.device).clamp_(0, h - 1)
    cols = torch.arange(-left, w + right, device=img.device).clamp_(0, w - 1)
    return img.index_select(-2, rows).index_select(-1, cols)


def pyr_down(img):
    """(..., H, W) u8 -> (..., H//2, W//2) u8. On the card one launch of
    kernel H; on the CPU the plain version."""
    if img.device.type == "cpu":
        return pyr_down_plain(img)
    return pyr_down_kernel(img)


def pyr_down_plain(img):
    """``pyr_down`` in plain PyTorch: the edge pad, then the 5x5 stride-2
    stencil as two passes of int32 multiplies and adds."""
    h, w = img.shape[-2], img.shape[-1]
    h2, w2 = h // 2, w // 2
    x = pad_edge(img, 2, 2, 2, 2).to(torch.int32)
    tmp = sum(c * x[..., :, j:j + 2 * w2:2] for j, c in enumerate(_TAPS))
    out = sum(c * tmp[..., i:i + 2 * h2:2, :] for i, c in enumerate(_TAPS))
    return torch.div(out, 256, rounding_mode="floor").to(torch.uint8)


def pyr_down_kernel(img):
    """``pyr_down_plain``'s function as one launch of kernel H on the CUDA
    card, over the contiguous (..., H, W) u8 input's frames. Raises on any
    other device or dtype, on fewer than 2 axes, and if the launch is
    refused. Each launch adds one to ``pyr_down_kernel.launches``."""
    if img.dtype != torch.uint8:
        raise ValueError(f"kernel H takes uint8 images, not {img.dtype}")
    if img.dim() < 2:
        raise ValueError(f"kernel H takes (..., H, W) images, not "
                         f"{tuple(img.shape)}")
    if img.device.type != "cuda":
        raise ValueError(f"kernel H runs on cuda, not {img.device}")
    h, w = img.shape[-2], img.shape[-1]
    src = img.contiguous()
    out = torch.empty(img.shape[:-2] + (h // 2, w // 2), dtype=torch.uint8,
                      device=img.device)
    if out.numel() == 0:
        return out
    frames = src.numel() // (h * w)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    err = _kernel()(src.data_ptr(), out.data_ptr(), frames, h, w, stream)
    if err != 0:
        raise RuntimeError(f"pyr_down kernel launch failed ({frames} frames "
                           f"of {h}x{w}): CUDA error {err}")
    pyr_down_kernel.launches += 1
    return out


@functools.cache
def _kernel():
    """``vs_pyr_down`` of the built ``csrc/pyr_down.cu``, typed."""
    fn = cuda_build.load("pyr_down").vs_pyr_down
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    return fn


pyr_down_kernel.launches = 0


def build_pyramid(frame, num_levels: int):
    """Level 0 is the input; each next level is pyr_down of the previous
    (alignment.cpp:217-223). Returns a list of ``num_levels`` tensors."""
    levels = [frame]
    for _ in range(num_levels - 1):
        levels.append(pyr_down(levels[-1]))
    return levels
