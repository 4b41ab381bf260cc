"""TV-L1 trajectory smoother: kernel D of the port.

``tvl1_smooth_kernel`` launches ``csrc/tvl1.cu`` for CUDA tensors: the
whole ``iterations``-step loop in one launch, one thread per row. It
replaces the device loop of
``video_stabilizer_tpu/models/smoother.py::tvl1_smooth`` (a ``lax.scan``
that XLA fuses, not a Pallas kernel); see the source note in
``csrc/tvl1.cu`` for the bound and the design. ``pack_rows`` lays the
batched call out as the kernel reads it: (R, N) float32 rows and one
``lam`` and one ``valid_len`` per row.

``tvl1_smooth_plain`` is the same loop in plain PyTorch, one torch
operation per expression (about 30,000 kernels at the chunk's windows of
16): the CPU path and the card's reference, never the main path on a card.
``models/smoother.py::tvl1_smooth`` dispatches between the two by device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from video_stabilizer_tpu_torch.ops import cuda_build


def tvl1_smooth_plain(data, lam, iterations: int = 100, valid_len=None):
    """TV-L1 smooth along the last axis, batched over leading axes.

    ``lam``: a float, or a tensor broadcastable to ``data.shape[:-1]`` (one
    smoothing strength per row, as the JAX package's traced ``lam`` is
    under vmap). ``valid_len``: optional int or integer tensor
    broadcastable to ``data.shape[:-1]``; only the first ``valid_len``
    entries of a row are real and pair updates beyond them are inert.
    """
    n = data.shape[-1]
    tiny = torch.finfo(data.dtype).tiny
    # A Python float enters each op as a float32 scalar, as the JAX
    # package's float32 ``lam`` does, without a host-to-device copy.
    if isinstance(lam, torch.Tensor):
        lam_t = lam.to(device=data.device, dtype=data.dtype)
    else:
        lam_t = float(lam)
    if valid_len is None:
        valid_len = n
    if not isinstance(valid_len, torch.Tensor):
        valid_len = torch.full(data.shape[:-1], int(valid_len),
                               device=data.device)
    valid_len = valid_len.expand(data.shape[:-1])
    active = [(i + 1) < valid_len for i in range(n - 1)]
    data_cols = list(data.unbind(-1))
    cols = list(data_cols)
    for _ in range(iterations):
        cols = [0.5 * c + 0.5 * d for c, d in zip(cols, data_cols)]
        for i in range(n - 1):
            xi, xj = cols[i], cols[i + 1]
            diff = xj - xi
            mag = torch.abs(diff)
            shrink = (mag - lam_t) / torch.clamp(mag, min=tiny) * 0.5
            mid = 0.5 * (xi + xj)
            take = mag > lam_t
            new_i = torch.where(take, xi + diff * shrink, mid)
            new_j = torch.where(take, xj - diff * shrink, mid)
            cols[i] = torch.where(active[i], new_i, xi)
            cols[i + 1] = torch.where(active[i], new_j, xj)
    return torch.stack(cols, dim=-1)


def pack_rows(data, lam, valid_len=None):
    """Kernel D's operands for ``tvl1_smooth(data, lam, valid_len=...)``:
    (rows (R, N) contiguous, lam (R,) float32, valid_len (R,) int32), R
    the product of ``data.shape[:-1]``. A float ``lam`` or int
    ``valid_len`` is filled on the device (no host copy); a tensor is
    broadcast to ``data.shape[:-1]``. ``valid_len=None`` is N."""
    lead, n = data.shape[:-1], data.shape[-1]
    rows = data.reshape(-1, n).contiguous()
    r, dev = rows.shape[0], data.device
    if isinstance(lam, torch.Tensor):
        lam_r = lam.to(device=dev, dtype=torch.float32).expand(lead)
        lam_r = lam_r.reshape(r).contiguous()
    else:
        lam_r = torch.full((r,), float(lam), dtype=torch.float32, device=dev)
    if valid_len is None:
        valid_len = n
    if isinstance(valid_len, torch.Tensor):
        valid_r = valid_len.to(device=dev, dtype=torch.int32).expand(lead)
        valid_r = valid_r.reshape(r).contiguous()
    else:
        valid_r = torch.full((r,), int(valid_len), dtype=torch.int32,
                             device=dev)
    return rows, lam_r, valid_r


def tvl1_smooth_kernel(data, lam, iterations: int = 100, valid_len=None):
    """``tvl1_smooth_plain``'s function as one launch of kernel D on the
    CUDA card (float32 only), on ``pack_rows``' contiguous operands.
    Raises on any other device, on another dtype, and if the launch is
    refused. Each launch adds one to ``tvl1_smooth_kernel.launches``."""
    if data.device.type != "cuda":
        raise ValueError(f"kernel D runs on cuda, not {data.device}")
    if data.dtype != torch.float32:
        raise ValueError(f"kernel D takes float32 data, not {data.dtype}")
    if data.dim() < 1 or data.shape[-1] < 1 or iterations < 0:
        raise ValueError(f"kernel D: want (..., N >= 1) data and iterations "
                         f">= 0, got {tuple(data.shape)}, {iterations}")
    rows, lam_r, valid_r = pack_rows(data, lam, valid_len)
    r, n = rows.shape
    if r == 0:
        return data.clone()
    out = torch.empty_like(rows)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    err = _kernel()(rows.data_ptr(), lam_r.data_ptr(), valid_r.data_ptr(),
                    out.data_ptr(), r, n, iterations, stream)
    if err != 0:
        raise RuntimeError(f"tvl1 kernel launch failed ({r} rows of {n}): "
                           f"CUDA error {err}")
    tvl1_smooth_kernel.launches += 1
    return out.reshape(data.shape)


@functools.cache
def _kernel():
    """``vs_tvl1_smooth`` of the built ``csrc/tvl1.cu``, typed."""
    fn = cuda_build.load("tvl1").vs_tvl1_smooth
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    return fn


tvl1_smooth_kernel.launches = 0
