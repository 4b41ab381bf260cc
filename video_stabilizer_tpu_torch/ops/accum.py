"""The stabilizer's accumulator scan (stabilizer.cpp:32-88): kernel F of the
port.

``accum_scan_kernel`` launches ``csrc/accum.cu`` for CUDA tensors: every
step of every sequence in one launch, one thread per sequence. It replaces
the JAX package's ``lax.scan`` of the accumulator
(``video_stabilizer_tpu/models/chunked.py:180-201``, ``batch.py:284-331``,
``homography_aligner.py:340-377``), which XLA fuses into one device loop
(not a Pallas kernel); see the source note in ``csrc/accum.cu`` for the
bound and the design.

The scan's layout is the kernel's: B sequences of T steps, ``meas`` and
``smoothed`` (B, T, P), ``succ`` and ``valid`` (B, T) bool, the starting
accumulator (B, P), and ``decay`` None (``params``' four values) or one
(min_disp, max_disp, min_decay, max_decay) row per sequence (B, 4). Each
call site (the chunk, the clip and the sweeps) lays its inputs out so.

``accum_scan_plain`` is the same loop in plain PyTorch, one ``fold_jitter``
per step (142 kernels a step for the similarity model, 232 for the
homography): the CPU path and the card's reference, never the main path on
a card. ``accum_scan`` dispatches between the two by device.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from video_stabilizer_tpu_torch import homography as H
from video_stabilizer_tpu_torch import transforms as T
from video_stabilizer_tpu_torch.ops import cuda_build

# Per model: (P, compose, inverse, max_corner_displacement).
ALGEBRA = {
    "similarity": (4, T.compose, T.inverse, T.max_corner_displacement),
    "homography": (8, H.compose, H.inverse, H.max_corner_displacement),
}


def fold_jitter(accum, meas, smoothed, params, width: int, height: int,
                model: str = "similarity", decay=None):
    """One accumulator fold (stabilizer.cpp:48-87): jitter = meas o
    smoothed^-1 folded into ``accum`` with displacement-based decay, which
    multiplies every parameter of either model. ``decay``: None for
    ``params``' (min_disp, max_disp, min_decay, max_decay), or a (..., 4)
    float32 tensor of them that broadcasts against ``accum``'s batch axes
    (one per combo of the smoother sweep)."""
    _, compose, inverse, mcd = ALGEBRA[model]
    if params.enable_smoother:
        jitter = compose(meas, inverse(smoothed))
    else:
        jitter = meas
    new = compose(accum, jitter)
    disp = mcd(new, width, height)[..., None]
    if decay is None:
        lo_d, hi_d, lo_k, hi_k = (params.min_disp, params.max_disp,
                                  params.min_decay, params.max_decay)
    else:
        lo_d, hi_d, lo_k, hi_k = (
            x[..., None] for x in decay.to(disp).unbind(-1))

    def like(x):
        return (x.expand_as(disp) if isinstance(x, torch.Tensor)
                else torch.full_like(disp, x))

    f = torch.clamp((disp - lo_d) / (hi_d - lo_d), 0.0, 1.0)
    factor = torch.where(
        disp > hi_d, like(hi_k),
        torch.where(disp > lo_d, lo_k * (1.0 - f) + hi_k * f, like(lo_k)))
    return new * factor


def accum_scan(accum0, meas, smoothed, succ, valid, params, width: int,
               height: int, model: str = "similarity", decay=None):
    """The accumulator over B sequences of T steps: (accums (B, T, P), the
    accumulator after each step, and the last one (B, P)). Step t resets
    the accumulator where ``succ[:, t]`` is False, then folds
    ``meas[:, t]`` (with ``smoothed[:, t]`` when ``params.enable_smoother``;
    ``smoothed`` is None otherwise) where ``valid[:, t]`` (None: every
    step). On the card one launch of kernel F; on the CPU the plain
    version."""
    if meas.device.type == "cpu":
        return accum_scan_plain(accum0, meas, smoothed, succ, valid, params,
                                width, height, model, decay)
    return accum_scan_kernel(accum0, meas, smoothed, succ, valid, params,
                             width, height, model, decay)


def accum_scan_plain(accum0, meas, smoothed, succ, valid, params,
                     width: int, height: int, model: str = "similarity",
                     decay=None):
    """``accum_scan`` in plain PyTorch: one ``fold_jitter`` per step."""
    accum = accum0
    accums = []
    for t in range(meas.shape[1]):
        accum = torch.where(succ[:, t, None], accum, torch.zeros_like(accum))
        folded = fold_jitter(accum, meas[:, t],
                             None if smoothed is None else smoothed[:, t],
                             params, width, height, model, decay)
        accum = folded if valid is None else torch.where(
            valid[:, t, None], folded, accum)
        accums.append(accum)
    if not accums:
        return meas.new_zeros(meas.shape), accum0
    return torch.stack(accums, dim=1), accum


@functools.lru_cache(maxsize=None)
def corner_consts(model: str, width: int, height: int, decay: tuple):
    """Kernel F's float32 constants (``Consts`` of ``csrc/accum.cu``, 25
    floats in host memory): the corners as the plain version's scalar
    operands reach torch, the four ``decay`` values, their span
    (max_disp - min_disp, a Python float subtraction) and the float32
    reciprocal of the span, which torch on the card multiplies by where the
    plain version divides by the Python float."""
    f32 = np.float32
    w, h = float(width), float(height)
    cx, cy = w * 0.5, h * 0.5
    corners = ((0.0, 0.0), (w, 0.0), (0.0, h), (w, h))
    if model == "similarity":
        ca = [f32(x - cx) for x, _ in corners]
        cb = [f32(y - cy) for _, y in corners]
    else:
        s = f32(1.0 / w)
        ca = [f32(x - cx) * s for x, _ in corners]
        cb = [f32(y - cy) * s for _, y in corners]
    lo_d, hi_d, lo_k, hi_k = decay
    span = hi_d - lo_d
    with np.errstate(divide="ignore"):
        inv_span = f32(1.0) / f32(span)
    vals = (ca + cb + [f32(x) for x, _ in corners]
            + [f32(y) for _, y in corners]
            + [f32(w), f32(cx), f32(cy), f32(lo_d), f32(hi_d), f32(lo_k),
               f32(hi_k), f32(span), inv_span])
    return (ctypes.c_float * 25)(*(float(v) for v in vals))


def accum_scan_kernel(accum0, meas, smoothed, succ, valid, params,
                      width: int, height: int, model: str = "similarity",
                      decay=None):
    """``accum_scan_plain``'s function as one launch of kernel F on the CUDA
    card (float32). Raises on any other device, on another dtype or shape,
    and if the launch is refused. Each launch adds one to
    ``accum_scan_kernel.launches``."""
    p = ALGEBRA[model][0]
    if meas.dim() != 3 or meas.shape[-1] != p:
        raise ValueError(f"kernel F takes (B, T, {p}) measurements for the "
                         f"{model} model, got {tuple(meas.shape)}")
    b, steps = meas.shape[:2]
    floats = [("meas", meas, (b, steps, p)), ("accum0", accum0, (b, p))]
    if params.enable_smoother:
        floats.append(("smoothed", smoothed, (b, steps, p)))
    for name, x, shape in floats:
        if x is None or x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(
                f"kernel F takes float32 {name} of shape {shape}, got "
                f"{None if x is None else (x.dtype, tuple(x.shape))}")
    flags = [succ] + ([] if valid is None else [valid])
    if any(f.dtype != torch.bool or tuple(f.shape) != (b, steps)
           for f in flags):
        raise ValueError(f"kernel F takes (B, T) = {(b, steps)} bool succ "
                         "and valid")
    tensors = [x for _, x, _ in floats] + flags
    if any(x.device.type != "cuda" or x.device != meas.device
           for x in tensors):
        raise ValueError(f"kernel F runs on cuda, not "
                         f"{sorted({str(x.device) for x in tensors})}")
    out = torch.empty((b, steps, p), dtype=torch.float32, device=meas.device)
    if b == 0 or steps == 0:
        return out, accum0.clone()
    last = torch.empty((b, p), dtype=torch.float32, device=meas.device)
    table = None
    if decay is not None:
        d = decay.to(device=meas.device, dtype=torch.float32).expand(b, 4)
        table = torch.cat([d, (d[:, 1] - d[:, 0])[:, None]], 1)
    consts = corner_consts(model, int(width), int(height), (
        float(params.min_disp), float(params.max_disp),
        float(params.min_decay), float(params.max_decay)))
    # Contiguous copies are freed after the launch is queued; the caching
    # allocator reuses them only behind it on this stream.
    operands = [meas, smoothed if params.enable_smoother else None, succ,
                valid, accum0, table]
    operands = [None if x is None else x.contiguous() for x in operands]
    ptrs = [None if x is None else x.data_ptr() for x in operands]
    stream = torch.cuda.current_stream(meas.device).cuda_stream
    err = _kernel()(*ptrs, out.data_ptr(), last.data_ptr(), b, steps, p,
                    consts, stream)
    if err != 0:
        raise RuntimeError(f"accum kernel launch failed ({b} sequences of "
                           f"{steps} steps, P = {p}): CUDA error {err}")
    accum_scan_kernel.launches += 1
    return out, last


@functools.cache
def _kernel():
    """``vs_accum_scan`` of the built ``csrc/accum.cu``, typed."""
    fn = cuda_build.load("accum").vs_accum_scan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
    return fn


accum_scan_kernel.launches = 0
