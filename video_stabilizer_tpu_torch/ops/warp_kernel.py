"""The stabilizer's batched output warp: kernel A of the port.

``warp_frames`` (one contiguous batch) and ``warp_frame_segments`` (frames
read where they lie, from up to two strided segments: the chunked path's
carried tail and chunk, a clip's strided view) launch ``csrc/warp.cu`` for
a CUDA tensor and run ``warp_frames_plain`` for a CPU tensor. It replaces
``video_stabilizer_tpu/ops/pallas_warp.py::_warp_kernel`` in each of its
forms: the sampling transform is a 4-parameter origin-based similarity or
an 8-parameter normalized homography (``model``), and the interpolation is
bilinear or weight-normalized Lanczos2 (``interp``). On the card a block
covers 8 x 128 output pixels inside one 216x512 tile: it stages the source
window in shared memory, computes each y-pass value once per (row, read
column) and shares it across the x taps. See the source note in
``csrc/warp.cu`` for what it computes, what bounds it on the card and how
the design meets it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from video_stabilizer_tpu_torch.ops import cuda_build
from video_stabilizer_tpu_torch.ops.lanczos import lanczos2

TILE_H = 216          # the Pallas grid's output tile: part of the contract
TILE_W = 512
MAX_SHIFT = 192       # clip of the per-tile integer base
LOCAL_BOUND = 3       # residual bound m after the per-tile base
_XT = LOCAL_BOUND + 2
_PAD_LO = MAX_SHIFT + _XT + 128   # fixes the Pallas kernel's row remainder
MAX_CHANNELS = 4
MODELS = {"similarity": (0, 4), "homography": (1, 8)}   # (code, parameters)
INTERPS = {"bilinear": 0, "lanczos2": 1}


def OPS_PER_PIXEL(channels: int, interp: str = "bilinear",
                  model: str = "similarity") -> int:
    """Float32 operations the separable warp needs per output pixel (each
    add, multiply, divide, min, max, abs, floor and rint counted once).

    The y-pass value at (row, read column) serves every output pixel whose
    x taps read that column, so it is counted once per output pixel: one
    read column per output column (csrc/warp.cu computes it once per block;
    the few extra columns of a block's halo are not counted).

    A sample position takes 4 (similarity, after 1 + a) or 17 (homography:
    normalized coordinates, numerator, denominator, its reciprocal, back to
    pixels) ops per coordinate. A weight takes 4 (bilinear hat) or 16
    (Lanczos2 polynomial). The y pass at one read column: the column (2),
    the y position, its residual (4), row offset (2) and floor (1), then per
    y tap its weight, 2 ops per channel and, for Lanczos2, 1 for the y
    normalizer. The x pass: the x position and its residual (5 + 4 or
    17 + 4), then per x tap its weight, 2 ops per channel and, for
    Lanczos2, 2 for the normalizer. Lanczos2 ends with the clamp of the
    normalizer and a division per channel; every form with the rounding and
    clamp of each channel (3 per channel). Similarity + bilinear at 3
    channels: 33 + 29 + 9 = 71; homography + Lanczos2: 118 + 117 + 13 =
    248."""
    lanczos = interp == "lanczos2"
    taps, wt, dn = (4, 16, 1) if lanczos else (2, 4, 0)
    pos_x, pos_y = (5, 4) if model == "similarity" else (17, 17)
    y_pass = 2 + pos_y + 4 + 2 + 1 + taps * (wt + 2 * channels + dn)
    x_pass = pos_x + 4 + taps * (wt + 2 * channels + 2 * dn)
    tail = (1 + channels if lanczos else 0) + 3 * channels
    return y_pass + x_pass + tail


def _hat(t):
    return torch.clamp(1.0 - torch.abs(t), min=0.0)


def _positions(ts, rows, cols, model: str, width: int, height: int):
    """Sampling positions (wx, wy) of output pixels (rows, cols) under the
    per-frame transforms ``ts`` (B, P): pallas_warp.py:91-114, in the same
    f32 order."""
    bsz = ts.shape[0]
    t = [ts[:, k].to(torch.float32).reshape(bsz, 1, 1)
         for k in range(ts.shape[1])]
    if model == "similarity":
        a, b, tx, ty = t
        pa = 1.0 + a
        return pa * cols - b * rows + tx, b * cols + pa * rows + ty
    img_w, img_h = float(width), float(height)
    cx, cy = img_w * 0.5, img_h * 0.5
    inv_w = 1.0 / img_w
    u = (cols - cx) * inv_w
    v = (rows - cy) * inv_w
    num_x = (1.0 + t[0]) * u + t[1] * v + t[2]
    num_y = t[3] * u + (1.0 + t[4]) * v + t[5]
    den = t[6] * u + t[7] * v + 1.0
    inv_den = 1.0 / den
    return num_x * inv_den * img_w + cx, num_y * inv_den * img_w + cy


def warp_frames_plain(frames, ts, crop: int = 0, interp: str = "bilinear",
                      model: str = "similarity"):
    """Plain PyTorch version of kernel A: the same per-pixel arithmetic, in
    the same f32 order, with the taps of non-zero weight gathered (2 per
    axis for bilinear, the <= 4 with |argument| < 2 for Lanczos2). A tap
    outside the frame reads 0, and its Lanczos2 weight still counts in the
    normalizer, as the Pallas kernel's zero-padded source gives."""
    bsz, h, w, c = frames.shape
    dev = frames.device
    f32 = torch.float32
    m = float(LOCAL_BOUND)
    lanczos = interp == "lanczos2"
    weight = lanczos2 if lanczos else _hat
    ntaps = 4 if lanczos else 2
    first = -1 if lanczos else 0
    ho, wo = h - 2 * crop, w - 2 * crop
    r = torch.arange(crop, crop + ho, device=dev)[None, :, None]
    col = torch.arange(crop, crop + wo, device=dev)[None, None, :]
    y0 = (r // TILE_H) * TILE_H
    x0 = (col // TILE_W) * TILE_W
    y0f, x0f = y0.to(f32), x0.to(f32)
    rowf, colf = r.to(f32), col.to(f32)

    def positions(rows, cols):
        return _positions(ts, rows, cols, model, w, h)

    # Integer base of each pixel's 216x512 tile: the warp at the tile centre.
    xc = x0f + TILE_W * 0.5
    yc = y0f + TILE_H * 0.5
    wxc, wyc = positions(yc, xc)
    kxf = torch.clamp(torch.round(wxc - xc), -MAX_SHIFT, MAX_SHIFT)
    kyf = torch.clamp(torch.round(wyc - yc), -MAX_SHIFT, MAX_SHIFT)
    kx, ky = kxf.to(torch.int64), kyf.to(torch.int64)
    qy = (y0 + ky + _PAD_LO - _XT) % 8
    qyf = qy.to(f32)

    wx = positions(rowf, colf)[0]
    rx = torch.clamp((wx - colf) - kxf, -m, m)
    e0 = torch.floor(rx) + first
    flat_src = frames.reshape(-1, c)
    bidx = torch.arange(bsz, device=dev).reshape(bsz, 1, 1)
    out = torch.zeros((bsz, ho, wo, c), dtype=f32, device=dev)
    den = torch.zeros((bsz, ho, wo), dtype=f32, device=dev)
    for k in range(ntaps):
        e = e0 + k
        wgt = weight(rx - e)
        u = (colf - x0f) + _XT + e
        colr = (u - _XT) + x0f
        wy = positions(rowf, colr)[1]
        ry = torch.clamp((wy - rowf) - kyf, -m, m)
        ry_eff = (ry + _XT) + qyf
        d0 = torch.floor(ry_eff) + first
        sc = col + kx + e.to(torch.int64)
        tmp = torch.zeros_like(out)
        den_y = torch.zeros_like(den)
        for l in range(ntaps):
            d = d0 + l
            wyw = weight(ry_eff - d)
            sr = r + ky - _XT - qy + d.to(torch.int64)
            inside = (sr >= 0) & (sr < h) & (sc >= 0) & (sc < w)
            idx = (bidx * h + sr.clamp(0, h - 1)) * w + sc.clamp(0, w - 1)
            v = flat_src[idx].to(f32) * inside[..., None]
            tmp = tmp + wyw[..., None] * v
            den_y = den_y + wyw
        out = out + wgt[..., None] * tmp
        den = den + wgt * den_y
    if lanczos:
        out = out / torch.clamp(den, min=1e-6)[..., None]
    return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)


class FrameSegments(NamedTuple):
    """S streams of ``n_out`` frames each, read where they lie: frame j of
    stream s is ``seg0[s, j]`` for j < n0 = ``seg0.shape[1]``, else
    ``seg1[s, j - n0]``. Each segment is (S, n, H, W[, C]) u8 with any
    stream and frame strides; ``seg1`` may be None where n0 >= n_out. The
    chunked path's delayed frames are (carried tail, chunk); a clip's are
    one strided view of the clip."""
    seg0: torch.Tensor
    seg1: torch.Tensor | None
    n_out: int

    def batch(self):
        """The (S, n_out, H, W[, C]) frames as one new contiguous tensor."""
        n0 = self.seg0.shape[1]
        out = self.seg0.new_empty(self.seg0.shape[:1] + (self.n_out,)
                                  + self.seg0.shape[2:])
        out[:, :n0].copy_(self.seg0[:, :self.n_out])
        if n0 < self.n_out:
            out[:, n0:].copy_(self.seg1[:, :self.n_out - n0])
        return out


def _check_form(ts, bsz, h, w, c, crop, interp, model, device):
    if model not in MODELS:
        raise ValueError(f"model must be one of {sorted(MODELS)}, got "
                         f"{model!r}")
    if interp not in INTERPS:
        raise ValueError(f"interp must be one of {sorted(INTERPS)}, got "
                         f"{interp!r}")
    npar = MODELS[model][1]
    if ts.shape != (bsz, npar) or ts.dtype != torch.float32:
        raise ValueError(f"ts must be ({bsz}, {npar}) float32, got "
                         f"{tuple(ts.shape)} {ts.dtype}")
    if ts.device != device:
        raise ValueError("frames and ts must be on one device")
    if not 0 <= crop or h - 2 * crop < 1 or w - 2 * crop < 1:
        raise ValueError(f"crop {crop} leaves no output of {h}x{w}")
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} channels, got {c}")


def _check(frames, ts, crop, interp, model):
    if frames.dtype != torch.uint8 or frames.dim() != 4:
        raise ValueError(f"frames must be (B, H, W, C) uint8, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    _check_form(ts, *frames.shape, crop, interp, model, frames.device)


def _frames_dense(seg) -> bool:
    """Whether each (H, W, C) frame of ``seg`` is contiguous."""
    h, w, c = seg.shape[-3:]
    return all(n == 1 or st == want for n, st, want in
               zip((h, w, c), seg.stride()[-3:], (w * c, c, 1)))


def _check_segments(seg0, seg1, n_out):
    for name, seg in (("seg0", seg0), ("seg1", seg1)):
        if seg is None:
            continue
        if seg.dtype != torch.uint8 or seg.dim() != 5:
            raise ValueError(f"{name} must be (S, n, H, W, C) uint8, got "
                             f"{tuple(seg.shape)} {seg.dtype}")
        if not _frames_dense(seg):
            raise ValueError(f"{name}'s frames must be contiguous (H, W, C) "
                             f"blocks, got strides {seg.stride()}")
    n1 = 0
    if seg1 is not None:
        if (seg1.shape[0] != seg0.shape[0]
                or seg1.shape[2:] != seg0.shape[2:]):
            raise ValueError(f"segments {tuple(seg0.shape)} and "
                             f"{tuple(seg1.shape)} differ in streams or "
                             "frame shape")
        if seg1.device != seg0.device:
            raise ValueError("segments must be on one device")
        n1 = seg1.shape[1]
    if not 1 <= n_out <= seg0.shape[1] + n1:
        raise ValueError(f"{n_out} output frames from segments of "
                         f"{seg0.shape[1]} and {n1} frames")


def _launch(seg0, seg1, n_out, ts, crop, interp, model):
    """One launch of kernel A on ``n_out`` frames of each stream of the
    segments; counts it."""
    streams, n0, h, w, c = seg0.shape
    lib = cuda_build.load("warp")
    fn = lib.vs_warp_segments
    fn.restype = ctypes.c_int
    # (base, stream stride, frame stride) of each segment, n0 after the
    # first: csrc/warp.cu vs_warp_segments.
    seg = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
    fn.argtypes = seg + [ctypes.c_int] + seg + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + \
        [ctypes.c_float, ctypes.c_void_p]
    second = ((seg1.data_ptr(), seg1.stride(0), seg1.stride(1))
              if seg1 is not None else (None, 0, 0))
    out = torch.empty((streams * n_out, h - 2 * crop, w - 2 * crop, c),
                      dtype=torch.uint8, device=seg0.device)
    stream = torch.cuda.current_stream(seg0.device).cuda_stream
    err = fn(seg0.data_ptr(), seg0.stride(0), seg0.stride(1), n0,
             second[0], second[1], second[2], streams, n_out,
             ts.data_ptr(), out.data_ptr(), h, w, c, crop,
             MODELS[model][0], INTERPS[interp], 1.0 / w, stream)
    if err != 0:
        raise RuntimeError(f"warp kernel launch failed: CUDA error {err}")
    warp_frames.launches += 1
    form = (model, interp)
    warp_frames.form_launches[form] = warp_frames.form_launches.get(form,
                                                                    0) + 1
    return out


def warp_frames(frames, ts, crop: int = 0, interp: str = "bilinear",
                model: str = "similarity"):
    """Batched dst(p) = interp(src, W(p)) with zero border, cropped.

    Args:
      frames: (B, H, W, C) u8.
      ts: (B, 4) float32 origin-based sampling similarity [a, b, tx, ty],
        or (B, 8) float32 normalized sampling homography with
        ``model="homography"``.
      crop: pixels cut from each side of the output.
      interp: "bilinear" or "lanczos2" (normalized by its weight sum).
    Returns:
      (B, H - 2*crop, W - 2*crop, C) u8.

    On the card the batch is kernel A's one-segment case
    (``warp_frame_segments``). Each launch adds one to
    ``warp_frames.launches`` and to
    ``warp_frames.form_launches[(model, interp)]``.
    """
    _check(frames, ts, crop, interp, model)
    if frames.device.type == "cpu":
        return warp_frames_plain(frames, ts, crop, interp, model)
    if frames.device.type != "cuda":
        raise ValueError(f"warp_frames runs on cuda or cpu, not "
                         f"{frames.device}")
    if not (frames.is_contiguous() and ts.is_contiguous()):
        raise ValueError("warp_frames needs contiguous frames and ts")
    return _launch(frames[None], None, frames.shape[0], ts, crop, interp,
                   model)


def warp_frame_segments(seg0, seg1, n_out: int, ts, crop: int = 0,
                        interp: str = "bilinear", model: str = "similarity"):
    """``warp_frames`` of the first ``n_out`` frames of each stream of
    ``FrameSegments(seg0, seg1, n_out)``, read where they lie.

    Args:
      seg0, seg1: (S, n0, H, W, C) and (S, n1, H, W, C) u8 (``seg1`` may be
        None where n0 >= n_out), any stream and frame strides, each frame's
        (H, W, C) contiguous.
      ts: (S * n_out, P) float32, stream-major.
    Returns:
      (S * n_out, H - 2*crop, W - 2*crop, C) u8, stream-major.

    On the card one launch of kernel A, counted as ``warp_frames``'
    launches are; on the CPU the plain version of the frames copied into
    one batch.
    """
    _check_segments(seg0, seg1, n_out)
    streams, _, h, w, c = seg0.shape
    _check_form(ts, streams * n_out, h, w, c, crop, interp, model,
                seg0.device)
    if seg0.device.type == "cpu":
        frames = FrameSegments(seg0, seg1, n_out).batch()
        return warp_frames_plain(frames.flatten(0, 1), ts, crop, interp,
                                 model)
    if seg0.device.type != "cuda":
        raise ValueError(f"warp_frame_segments runs on cuda or cpu, not "
                         f"{seg0.device}")
    if not ts.is_contiguous():
        raise ValueError("warp_frame_segments needs contiguous ts")
    return _launch(seg0, seg1, n_out, ts, crop, interp, model)


def reset_launches():
    """Set kernel A's launch counts to 0."""
    warp_frames.launches = 0
    warp_frames.form_launches = {}


reset_launches()
