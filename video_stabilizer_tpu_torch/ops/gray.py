"""BGR to gray (OpenCV 5.x cvtColor BGR2GRAY in full float): kernel G of the
port.

``bgr_to_gray_kernel`` launches ``csrc/gray.cu`` for CUDA tensors: the
whole conversion in one launch. It replaces the JAX package's XLA stage
``video_stabilizer_tpu/models/stabilizer.py::bgr_to_gray`` (one fused pass;
not a Pallas kernel); see the source note in ``csrc/gray.cu`` for the
bound and the design.

``bgr_to_gray_plain`` is the same expression in plain PyTorch (about ten
kernels, four of them writing float32 tensors of the frames' size): the
CPU path and the card's reference, never the main path on a card.
``bgr_to_gray`` dispatches between the two by device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from video_stabilizer_tpu_torch.ops import cuda_build


def bgr_to_gray(frame_bgr):
    """BGR u8 (..., 3) -> gray u8 (...): round(0.114*B + 0.587*G + 0.299*R)
    in float32, half to even (``video_stabilizer_tpu.models.stabilizer.
    bgr_to_gray``, stabilizer.py:86-99).

    On the card this is one launch of kernel G (u8 only); on the CPU the
    plain version."""
    if frame_bgr.device.type == "cpu":
        return bgr_to_gray_plain(frame_bgr)
    return bgr_to_gray_kernel(frame_bgr)


def bgr_to_gray_plain(frame_bgr):
    """``bgr_to_gray`` in plain PyTorch: each product and sum rounded to
    float32 in that order (torch.round is half to even like jnp.round)."""
    b = frame_bgr[..., 0].to(torch.float32)
    g = frame_bgr[..., 1].to(torch.float32)
    r = frame_bgr[..., 2].to(torch.float32)
    return torch.round(0.114 * b + 0.587 * g + 0.299 * r).to(torch.uint8)


def bgr_to_gray_kernel(frame_bgr):
    """``bgr_to_gray_plain``'s function as one launch of kernel G on the
    CUDA card, on the contiguous (..., 3) u8 input. Raises on any other
    device, dtype or last axis, and if the launch is refused. Each launch
    adds one to ``bgr_to_gray_kernel.launches``."""
    if frame_bgr.dtype != torch.uint8:
        raise ValueError(f"kernel G takes uint8 frames, not {frame_bgr.dtype}")
    if frame_bgr.dim() < 1 or frame_bgr.shape[-1] != 3:
        raise ValueError(f"kernel G takes (..., 3) BGR frames, not "
                         f"{tuple(frame_bgr.shape)}")
    if frame_bgr.device.type != "cuda":
        raise ValueError(f"kernel G runs on cuda, not {frame_bgr.device}")
    bgr = frame_bgr.contiguous()
    gray = torch.empty(bgr.shape[:-1], dtype=torch.uint8, device=bgr.device)
    pixels = gray.numel()
    if pixels == 0:
        return gray
    stream = torch.cuda.current_stream(bgr.device).cuda_stream
    err = _kernel()(bgr.data_ptr(), gray.data_ptr(), pixels, stream)
    if err != 0:
        raise RuntimeError(f"bgr_to_gray kernel launch failed ({pixels} "
                           f"pixels): CUDA error {err}")
    bgr_to_gray_kernel.launches += 1
    return gray


@functools.cache
def _kernel():
    """``vs_bgr_to_gray`` of the built ``csrc/gray.cu``, typed."""
    fn = cuda_build.load("gray").vs_bgr_to_gray
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p]
    return fn


bgr_to_gray_kernel.launches = 0
