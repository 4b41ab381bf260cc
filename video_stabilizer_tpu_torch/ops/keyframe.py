"""One pyramid level's keyframe precompute (alignment.cpp:237-276): the
gradients, each tile's gradient argmax, the Jacobian rows at those pixels
and the u8 sampling windows, for K keyframes at once. Kernel I of the
port.

``keyframe_level_kernel`` launches ``csrc/keyframe.cu`` for CUDA tensors:
one launch a level over all K keyframes, for either model. It replaces
the JAX package's XLA stages ``video_stabilizer_tpu/models/aligner.py:163
_compute_keyframe`` and ``video_stabilizer_tpu/models/homography_aligner.py
:74 _compute_keyframe_h``, a level at a time (not Pallas kernels); see the
source note in ``csrc/keyframe.cu`` for the bound and the design.
``keyframe_level_plain`` is the same computation in plain PyTorch (about
70 kernels a level): the CPU path and the card's reference, never the main
path on a card. ``keyframe_level`` dispatches between the two by device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from video_stabilizer_tpu_torch import homography as Hm
from video_stabilizer_tpu_torch.ops import cuda_build
from video_stabilizer_tpu_torch.ops.argmax import (
    grad_argmax, take_at_tile_argmax)
from video_stabilizer_tpu_torch.ops.grad import grad_xy
from video_stabilizer_tpu_torch.ops.patches import (
    extract_tile_windows_flat, window_size)

MODELS = ("similarity", "homography")


class LevelKeyData(NamedTuple):
    """Per-level keyframe precompute, batched on a leading axis K."""
    idx_x: torch.Tensor    # (K, ht, wt) int32 flat within-tile argmax, X set
    idx_y: torch.Tensor
    coords: torch.Tensor   # (K, 2 xy, 2 sets, N) float32 keypoint coords
    jac: torch.Tensor      # (K, 4 or 8, 2 sets, N) float32 Jacobian rows
    windows: torch.Tensor  # (K, P, P, N) uint8 sampling windows


def jacobian_rows(model: str) -> int:
    if model not in MODELS:
        raise ValueError(f"unknown motion model {model!r}")
    return 4 if model == "similarity" else 8


def keyframe_level(img, spec, model: str = "similarity") -> LevelKeyData:
    """The keyframe precompute of one level: ``img`` (K, h, w) u8 at the
    level's ``spec`` (``models.aligner.LevelSpec``: width, height, tile,
    wt, ht, margin), Jacobian rows of ``model``. On the card one launch of
    kernel I; on the CPU the plain version."""
    if img.device.type == "cpu":
        return keyframe_level_plain(img, spec, model)
    return keyframe_level_kernel(img, spec, model)


def keyframe_level_plain(img, spec, model: str = "similarity"
                         ) -> LevelKeyData:
    """``keyframe_level`` in plain PyTorch: GradXY -> GradArgMax ->
    SparseJacobian (aligner.py:163-196, homography_aligner.py:74-113), the
    similarity's rows in centred pixel coordinates scaled by 1 / width, the
    homography's in centred width-normalized ones."""
    rows = jacobian_rows(model)
    s = spec
    gx, gy = grad_xy(img)
    idx_x, coords_x, idx_y, coords_y = grad_argmax(gx, gy, s.tile)
    gval = take_at_tile_argmax(torch.stack([gx, gy], dim=1),
                               torch.stack([idx_x, idx_y], dim=1), s.tile)
    k = img.shape[0]
    n = s.ht * s.wt
    if rows == 4:
        cx_l, cy_l = s.width * 0.5, s.height * 0.5
        scale = 1.0 / s.width
        gx_f = 2.0 * gval[:, 0].reshape(k, n)
        gy_f = 2.0 * gval[:, 1].reshape(k, n)
        ux = coords_x[..., 0].reshape(k, n).to(torch.float32) - cx_l
        vx = coords_x[..., 1].reshape(k, n).to(torch.float32) - cy_l
        uy = coords_y[..., 0].reshape(k, n).to(torch.float32) - cx_l
        vy = coords_y[..., 1].reshape(k, n).to(torch.float32) - cy_l
        zero = torch.zeros_like(gx_f)
        jac = torch.stack([
            torch.stack([gx_f * ux * scale, gy_f * vy * scale], dim=1),
            torch.stack([gx_f * (-vx) * scale, gy_f * uy * scale], dim=1),
            torch.stack([gx_f, zero], dim=1),
            torch.stack([zero, gy_f], dim=1),
        ], dim=1)                                             # (K, 4, 2, N)
        coords = torch.stack([
            torch.stack([ux + cx_l, uy + cx_l], dim=1),
            torch.stack([vx + cy_l, vy + cy_l], dim=1),
        ], dim=1)                                             # (K, 2, 2, N)
    else:
        w_l, h_l = float(s.width), float(s.height)
        fx = torch.stack([coords_x[..., 0].reshape(k, n),
                          coords_y[..., 0].reshape(k, n)], 1).to(torch.float32)
        fy = torch.stack([coords_x[..., 1].reshape(k, n),
                          coords_y[..., 1].reshape(k, n)], 1).to(torch.float32)
        u = (fx - w_l * 0.5) / w_l                               # (K, 2, N)
        v = (fy - h_l * 0.5) / w_l
        # The X set takes grad_x on the u row, the Y set grad_y on the v row.
        ju, jv = Hm.jacobian_rows(u, v)                          # (K, 2, N, 8)
        g = gval.reshape(k, 2, n) * w_l
        sel = torch.stack([ju[:, 0], jv[:, 1]], 1)
        jac = (sel * g[..., None]).permute(0, 3, 1, 2).contiguous()
        coords = torch.stack([fx, fy], 1)                        # (K, 2, 2, N)
    windows = extract_tile_windows_flat(img, s.tile, s.margin)
    return LevelKeyData(idx_x, idx_y, coords, jac, windows)


def kernel_scalars(spec):
    """The float32 scalars of the plain version's expressions as torch
    takes them on the card: w / 2 and h / 2 (exact); the similarity's
    ``* (1.0 / w)``, a Python float rounded to float32; the homography's
    ``/ w``, which torch on the card runs as a multiply by the float32
    reciprocal of float32(w) (``div_true_kernel_cuda`` with a CPU scalar);
    and float32(w)."""
    w = np.float32(spec.width)
    return (float(np.float32(spec.width * 0.5)),
            float(np.float32(spec.height * 0.5)),
            float(np.float32(1.0 / spec.width)),
            float(np.float32(1.0) / w), float(w))


def keyframe_level_kernel(img, spec, model: str = "similarity"
                          ) -> LevelKeyData:
    """``keyframe_level_plain``'s function as one launch of kernel I on the
    CUDA card, over the contiguous (K, h, w) u8 input's K keyframes. Raises
    on any other device, dtype or rank, on an image whose size is not the
    spec's, on a tile outside 2-32 or a margin under 1, and if the launch is
    refused. Each launch adds one to ``keyframe_level_kernel.launches``."""
    rows = jacobian_rows(model)
    if img.dtype != torch.uint8:
        raise ValueError(f"kernel I takes uint8 images, not {img.dtype}")
    if img.dim() != 3:
        raise ValueError(f"kernel I takes (K, h, w) images, not "
                         f"{tuple(img.shape)}")
    if img.device.type != "cuda":
        raise ValueError(f"kernel I runs on cuda, not {img.device}")
    keys, h, w = img.shape
    t, m = spec.tile, spec.margin
    if (h, w) != (spec.height, spec.width) or not 2 <= t <= 32 or m < 1:
        raise ValueError(f"kernel I: image {h}x{w}, tile {t}, margin {m} "
                         f"against the spec's {spec.height}x{spec.width}")
    n, p = spec.ht * spec.wt, window_size(t, m)
    dev = img.device
    out = LevelKeyData(
        torch.empty((keys, spec.ht, spec.wt), dtype=torch.int32, device=dev),
        torch.empty((keys, spec.ht, spec.wt), dtype=torch.int32, device=dev),
        torch.empty((keys, 2, 2, n), dtype=torch.float32, device=dev),
        torch.empty((keys, rows, 2, n), dtype=torch.float32, device=dev),
        torch.empty((keys, p, p, n), dtype=torch.uint8, device=dev))
    if keys == 0 or n == 0:
        return out
    src = img.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(src.data_ptr(), keys, h, w, t, m, int(rows == 8),
                    *kernel_scalars(spec),
                    *(x.data_ptr() for x in out), stream)
    if err != 0:
        raise RuntimeError(f"keyframe kernel launch failed ({keys} keyframes "
                           f"of {h}x{w}, tile {t}, margin {m}): CUDA error "
                           f"{err}")
    keyframe_level_kernel.launches += 1
    return out


@functools.cache
def _kernel():
    """``vs_keyframe`` of the built ``csrc/keyframe.cu``, typed."""
    fn = cuda_build.load("keyframe").vs_keyframe
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 5 + [ctypes.c_void_p] * 6)
    return fn


keyframe_level_kernel.launches = 0
