"""The stabilizer's batched output warp: kernel A of the port.

``warp_frames`` launches ``csrc/warp.cu`` for a CUDA tensor and runs
``warp_frames_plain`` for a CPU tensor. It replaces
``video_stabilizer_tpu/ops/pallas_warp.py::_warp_kernel`` in its similarity +
bilinear form (the main path's); see the source note in ``csrc/warp.cu`` for
what it computes, what bounds it on the card and how the design meets it.
"""

from __future__ import annotations

import ctypes

import torch

from video_stabilizer_tpu_torch.ops import cuda_build

TILE_H = 216          # the Pallas grid's output tile: part of the contract
TILE_W = 512
MAX_SHIFT = 192       # clip of the per-tile integer base
LOCAL_BOUND = 3       # residual bound m after the per-tile base
_XT = LOCAL_BOUND + 2
_PAD_LO = MAX_SHIFT + _XT + 128   # fixes the Pallas kernel's row remainder
MAX_CHANNELS = 4


def OPS_PER_PIXEL(channels: int) -> int:
    """Float32 operations of csrc/warp.cu per output pixel (each add,
    multiply, min, max, abs, floor and rint counted once): the x position
    and its residual (9), then for each of the two x taps its weight, read
    column, y residual and two y taps of 2 ops per channel (25 + 6 C),
    and the rounding and clamp of each channel (3 C)."""
    return 9 + 2 * (25 + 6 * channels) + 3 * channels


def _hat(t):
    return torch.clamp(1.0 - torch.abs(t), min=0.0)


def warp_frames_plain(frames, ts, crop: int = 0):
    """Plain PyTorch version of kernel A: same per-pixel arithmetic, in the
    same f32 order, with the two non-zero bilinear taps per axis gathered."""
    bsz, h, w, c = frames.shape
    dev = frames.device
    f32 = torch.float32
    m = float(LOCAL_BOUND)
    ho, wo = h - 2 * crop, w - 2 * crop
    r = torch.arange(crop, crop + ho, device=dev)[None, :, None]
    col = torch.arange(crop, crop + wo, device=dev)[None, None, :]
    y0 = (r // TILE_H) * TILE_H
    x0 = (col // TILE_W) * TILE_W
    y0f, x0f = y0.to(f32), x0.to(f32)
    rowf, colf = r.to(f32), col.to(f32)
    a, b, tx, ty = (ts[:, k].to(f32).reshape(bsz, 1, 1) for k in range(4))
    pa = 1.0 + a

    # Integer base of each pixel's 216x512 tile: the warp at the tile centre.
    xc = x0f + TILE_W * 0.5
    yc = y0f + TILE_H * 0.5
    wxc = pa * xc - b * yc + tx
    wyc = b * xc + pa * yc + ty
    kxf = torch.clamp(torch.round(wxc - xc), -MAX_SHIFT, MAX_SHIFT)
    kyf = torch.clamp(torch.round(wyc - yc), -MAX_SHIFT, MAX_SHIFT)
    kx, ky = kxf.to(torch.int64), kyf.to(torch.int64)
    qy = (y0 + ky + _PAD_LO - _XT) % 8
    qyf = qy.to(f32)

    wx = pa * colf - b * rowf + tx
    rx = torch.clamp((wx - colf) - kxf, -m, m)
    e0 = torch.floor(rx)
    flat_src = frames.reshape(-1, c)
    bidx = torch.arange(bsz, device=dev).reshape(bsz, 1, 1)
    out = torch.zeros((bsz, ho, wo, c), dtype=f32, device=dev)
    for k in range(2):
        e = e0 + k
        wgt = _hat(rx - e)
        u = (colf - x0f) + _XT + e
        colr = (u - _XT) + x0f
        wy = b * colr + pa * rowf + ty
        ry = torch.clamp((wy - rowf) - kyf, -m, m)
        ry_eff = (ry + _XT) + qyf
        d0 = torch.floor(ry_eff)
        sc = col + kx + e.to(torch.int64)
        tmp = torch.zeros_like(out)
        for l in range(2):
            d = d0 + l
            wyw = _hat(ry_eff - d)
            sr = r + ky - _XT - qy + d.to(torch.int64)
            inside = (sr >= 0) & (sr < h) & (sc >= 0) & (sc < w)
            idx = (bidx * h + sr.clamp(0, h - 1)) * w + sc.clamp(0, w - 1)
            v = flat_src[idx].to(f32) * inside[..., None]
            tmp = tmp + wyw[..., None] * v
        out = out + wgt[..., None] * tmp
    return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)


def _check(frames, ts, crop):
    if frames.dtype != torch.uint8 or frames.dim() != 4:
        raise ValueError(f"frames must be (B, H, W, C) uint8, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    bsz, h, w, c = frames.shape
    if ts.shape != (bsz, 4) or ts.dtype != torch.float32:
        raise ValueError(f"ts must be ({bsz}, 4) float32, got "
                         f"{tuple(ts.shape)} {ts.dtype}")
    if ts.device != frames.device:
        raise ValueError("frames and ts must be on one device")
    if not 0 <= crop or h - 2 * crop < 1 or w - 2 * crop < 1:
        raise ValueError(f"crop {crop} leaves no output of {h}x{w}")
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} channels, got {c}")


def warp_frames(frames, ts, crop: int = 0):
    """Batched dst(p) = bilinear(src, W(p)) with zero border, cropped.

    Args:
      frames: (B, H, W, C) u8.
      ts: (B, 4) float32 origin-based sampling similarity [a, b, tx, ty].
      crop: pixels cut from each side of the output.
    Returns:
      (B, H - 2*crop, W - 2*crop, C) u8.
    """
    _check(frames, ts, crop)
    if frames.device.type == "cpu":
        return warp_frames_plain(frames, ts, crop)
    if frames.device.type != "cuda":
        raise ValueError(f"warp_frames runs on cuda or cpu, not "
                         f"{frames.device}")
    if not (frames.is_contiguous() and ts.is_contiguous()):
        raise ValueError("warp_frames needs contiguous frames and ts")
    bsz, h, w, c = frames.shape
    lib = cuda_build.load("warp")
    fn = lib.vs_warp_frames
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    out = torch.empty((bsz, h - 2 * crop, w - 2 * crop, c), dtype=torch.uint8,
                      device=frames.device)
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    err = fn(frames.data_ptr(), ts.data_ptr(), out.data_ptr(), bsz, h, w, c,
             crop, stream)
    if err != 0:
        raise RuntimeError(f"warp kernel launch failed: CUDA error {err}")
    warp_frames.launches += 1
    return out


warp_frames.launches = 0
