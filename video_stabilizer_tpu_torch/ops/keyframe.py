"""A keyframe set's precompute (alignment.cpp:237-276) at every pyramid
level: the gradients, each tile's gradient argmax, the Jacobian rows at
those pixels and the u8 sampling windows, for K keyframes at once. Kernel
I of the port.

``keyframe_levels_kernel`` launches ``csrc/keyframe.cu`` for CUDA tensors:
one launch for every level of the set, for either model, from inputs with
any keyframe stride (rows contiguous) into outputs at any row offset of the
caller's set. It replaces the JAX package's XLA stages
``video_stabilizer_tpu/models/aligner.py:163 _compute_keyframe`` and
``video_stabilizer_tpu/models/homography_aligner.py:74
_compute_keyframe_h`` (not Pallas kernels); see the source note in
``csrc/keyframe.cu`` for the bound and the design.
``keyframe_level_plain`` is the same computation of one level in plain
PyTorch (about 70 kernels a level): the CPU path and the card's reference,
never the main path on a card. ``keyframe_levels`` and ``keyframe_level``
(one level) dispatch between the two by device.
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
    windows: torch.Tensor  # (K, N, P, P) uint8 sampling windows


def jacobian_rows(model: str) -> int:
    if model not in MODELS:
        raise ValueError(f"unknown motion model {model!r}")
    return 4 if model == "similarity" else 8


def keyframe_level(img, spec, model: str = "similarity") -> LevelKeyData:
    """The keyframe precompute of one level: ``img`` (K, h, w) u8 at the
    level's ``spec`` (``models.aligner.LevelSpec``: width, height, tile,
    wt, ht, margin), Jacobian rows of ``model``. On the card one launch of
    kernel I (that level's work list alone); on the CPU the plain
    version."""
    return keyframe_levels([img], [spec], model)[0]


def keyframe_levels(imgs, specs, model: str = "similarity", out=None,
                    offset: int = 0):
    """The keyframe precompute of a set of K keyframes at every level:
    ``imgs`` holds one u8 (K, h, w) tensor a level, rows contiguous, any
    keyframe stride (a view of every other frame goes in as it is);
    ``specs`` the levels' ``LevelSpec``. Returns one ``LevelKeyData`` a
    level. ``out``, where given, holds one ``LevelKeyData`` a level whose
    fields have a leading extent of at least ``offset + K``: keyframe k's
    results land in row ``offset + k``, no other row is written, and
    ``out`` is returned. On the card one launch of kernel I for all levels;
    on the CPU the plain version level by level."""
    if imgs[0].device.type == "cpu":
        got = [keyframe_level_plain(img, s, model)
               for img, s in zip(imgs, specs)]
        if out is None:
            return tuple(got)
        _check_out(out, imgs, specs, model, offset)
        for o, g in zip(out, got):
            for dst, src in zip(o, g):
                dst[offset:offset + src.shape[0]].copy_(src)
        return out
    return keyframe_levels_kernel(imgs, specs, model, out, offset)


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


@functools.lru_cache(maxsize=None)
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
    """One level's work list alone through kernel I: ``keyframe_levels_
    kernel`` on that level (one launch)."""
    return keyframe_levels_kernel([img], [spec], model)[0]


# Levels one launch takes (csrc/keyframe.cu's MAX_LEVELS).
MAX_LEVELS = 8


class _LevelArgs(ctypes.Structure):
    """``KeyframeLevelArgs`` of csrc/keyframe.cu: one level of a set."""
    _fields_ = [("img", ctypes.c_void_p), ("kstride", ctypes.c_longlong),
                ("h", ctypes.c_int), ("w", ctypes.c_int),
                ("t", ctypes.c_int), ("m", ctypes.c_int),
                ("cx", ctypes.c_float), ("cy", ctypes.c_float),
                ("scale", ctypes.c_float), ("inv_w", ctypes.c_float),
                ("wf", ctypes.c_float),
                ("idx_x", ctypes.c_void_p), ("idx_y", ctypes.c_void_p),
                ("coords", ctypes.c_void_p), ("jac", ctypes.c_void_p),
                ("windows", ctypes.c_void_p)]


def _check_imgs(imgs, specs):
    """(K, device): every level a u8 (K, h, w) image of its spec's size with
    contiguous rows, all on one device with one K; else ValueError."""
    if len(imgs) != len(specs) or not imgs:
        raise ValueError(f"kernel I takes one image a level: {len(imgs)} "
                         f"images for {len(specs)} specs")
    keys, dev = imgs[0].shape[0] if imgs[0].dim() else 0, imgs[0].device
    for img, s in zip(imgs, specs):
        if img.dtype != torch.uint8:
            raise ValueError(f"kernel I takes uint8 images, not {img.dtype}")
        if img.dim() != 3:
            raise ValueError(f"kernel I takes (K, h, w) images, not "
                             f"{tuple(img.shape)}")
        if img.device != dev or img.shape[0] != keys:
            raise ValueError(f"kernel I: every level holds the same {keys} "
                             f"keyframes on {dev}, not {img.shape[0]} on "
                             f"{img.device}")
        k, h, w = img.shape
        t, m = s.tile, s.margin
        if (h, w) != (s.height, s.width) or not 2 <= t <= 32 or m < 1:
            raise ValueError(f"kernel I: image {h}x{w}, tile {t}, margin {m} "
                             f"against the spec's {s.height}x{s.width}")
        if (w > 1 and img.stride(2) != 1) or (h > 1 and img.stride(1) != w):
            raise ValueError(f"kernel I takes images with contiguous rows, "
                             f"not strides {img.stride()}")
    return keys, dev


def _out_shapes(spec, rows):
    n, p = spec.ht * spec.wt, window_size(spec.tile, spec.margin)
    return (((spec.ht, spec.wt), torch.int32), ((spec.ht, spec.wt),
                                                 torch.int32),
            ((2, 2, n), torch.float32), ((rows, 2, n), torch.float32),
            ((n, p, p), torch.uint8))


def _check_out(out, imgs, specs, model, offset):
    """``out`` takes rows [offset, offset + K) of every level; else
    ValueError."""
    rows = jacobian_rows(model)
    keys, dev = imgs[0].shape[0], imgs[0].device
    if len(out) != len(specs) or offset < 0:
        raise ValueError(f"kernel I: out holds {len(out)} levels for "
                         f"{len(specs)}, offset {offset}")
    for o, s in zip(out, specs):
        for name, f, (shape, dtype) in zip(LevelKeyData._fields, o,
                                           _out_shapes(s, rows)):
            if (f.dtype != dtype or f.device != dev
                    or tuple(f.shape[1:]) != shape
                    or f.shape[0] < offset + keys or not f.is_contiguous()):
                raise ValueError(
                    f"kernel I: out.{name} {tuple(f.shape)} {f.dtype} on "
                    f"{f.device} (contiguous: {f.is_contiguous()}) cannot "
                    f"take rows [{offset}, {offset + keys}) of {shape} "
                    f"{dtype} on {dev}")


def _level_args(img, spec, fields, offset):
    """The ``_LevelArgs`` of one level: the image and the output fields'
    row ``offset``."""
    keys, h, w = img.shape
    ptrs = [f.data_ptr() + offset * f.stride(0) * f.element_size()
            for f in fields]
    return _LevelArgs(img.data_ptr(), img.stride(0) if keys > 1 else h * w,
                      h, w, spec.tile, spec.margin, *kernel_scalars(spec),
                      *ptrs)


def keyframe_levels_kernel(imgs, specs, model: str = "similarity", out=None,
                           offset: int = 0):
    """``keyframe_levels``' function on the CUDA card: one launch of kernel
    I for every level (up to ``MAX_LEVELS``; more take a launch each eight).
    Raises on any other device, dtype or rank, on an image whose size is not
    its spec's or whose rows are not contiguous, on a tile outside 2-32 or a
    margin under 1, on ``out`` of the wrong shape, dtype or device, and if
    the launch is refused. Each launch adds one to
    ``keyframe_levels_kernel.launches``. A set of no keyframes, or levels of
    no tiles, launches nothing for them."""
    rows = jacobian_rows(model)
    keys, dev = _check_imgs(imgs, specs)
    if dev.type != "cuda":
        raise ValueError(f"kernel I runs on cuda, not {dev}")
    if out is None:
        if offset:
            raise ValueError("kernel I: an offset needs out")
        out = tuple(LevelKeyData(*(torch.empty((keys,) + shape, dtype=dtype,
                                               device=dev)
                                   for shape, dtype in _out_shapes(s, rows)))
                    for s in specs)
    else:
        _check_out(out, imgs, specs, model, offset)
    todo = [(img, s, o) for img, s, o in zip(imgs, specs, out)
            if s.ht * s.wt > 0]
    if keys == 0 or not todo:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    for at in range(0, len(todo), MAX_LEVELS):
        group = todo[at:at + MAX_LEVELS]
        args = (_LevelArgs * len(group))(
            *(_level_args(img, s, o, offset) for img, s, o in group))
        err = _kernel()(len(group), keys, int(rows == 8), args, stream)
        if err != 0:
            raise RuntimeError(
                f"keyframe kernel launch failed ({keys} keyframes, levels "
                f"{[tuple(img.shape[1:]) for img, _, _ in group]}, tiles "
                f"{[s.tile for _, s, _ in group]}, margins "
                f"{[s.margin for _, s, _ in group]}): CUDA error {err}")
        keyframe_levels_kernel.launches += 1
    return out


@functools.cache
def _kernel():
    """``vs_keyframe_levels`` of the built ``csrc/keyframe.cu``, typed."""
    fn = cuda_build.load("keyframe").vs_keyframe_levels
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.POINTER(_LevelArgs), ctypes.c_void_p]
    return fn


keyframe_levels_kernel.launches = 0
