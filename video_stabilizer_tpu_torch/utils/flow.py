"""Dense optical flow for the jitter metric, on the device.

Port of ``video_stabilizer_tpu.utils.flow`` (flow.py:1-178): a pyramidal
iterative dense Lucas-Kanade flow in float32, a measurement instrument in
place of the reference's host Farneback flow (eval_jitter.cpp:50-51), so
that a parameter sweep scores its combos without leaving the device. The
same expressions as the JAX module, batched over leading axes (frame pairs,
and the combos of a sweep):

  - the per-pixel 2x2 LK normal equations use box-window sums formed from
    cumulative sums (O(1) per pixel for any window);
  - the flow-compensated warp is a per-pixel bilinear gather with
    edge-clamped indices, as ``jax.scipy.ndimage.map_coordinates(order=1,
    mode="nearest")`` forms it;
  - the pyramid is a float32 [1, 4, 6, 4, 1] / 16 blur with repeated edges
    and 2x decimation.

On the card ``median_flow_px`` and ``median_jitter_px_device_impl`` are
programs, as they are jits in the JAX package (flow.py:141, 154): each is
captured once per static configuration (``levels``, ``radius``, ``iters``,
``crop``) and input shape as a CUDA graph and replayed (utils/graphs.py),
keeping one key per card; inside ``median_jitter_px_device_impl`` the
per-group ``median_flow_px`` runs inline.

Plain PyTorch: the JAX package runs this as XLA, not as a Pallas kernel.
The box sums differ from the JAX package's in the last bits, because a
cumulative sum adds in another order (on the CPU torch accumulates it in
double); the tests state the resulting gap.
"""

from __future__ import annotations

import numpy as np
import torch

from video_stabilizer_tpu_torch.device import resolve_device
from video_stabilizer_tpu_torch.utils.graphs import Program

# Pixels of float32 work per call of ``median_flow_px`` in
# ``median_jitter_px_device_impl``: a 1080p pair holds some 25 full-size
# float32 intermediates (~200 MB), so 32 M pixels keep a group of 16 such
# pairs near 3 GB.
PAIR_GROUP_PIXELS = 32 * 1024 * 1024

_BLUR = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _pyr_down_f32(img):
    """[1,4,6,4,1]/16 separable blur + 2x decimation of (..., H, W) f32,
    repeated edges (flow.py:33-49)."""
    def blur_1d(x, dim):
        n = x.shape[dim]
        idx = torch.clamp(torch.arange(-2, n + 2, device=x.device), 0, n - 1)
        xp = x.index_select(dim, idx)
        out = torch.zeros_like(x)
        for i, k in enumerate(_BLUR):
            out = out + np.float32(k) * xp.narrow(dim, i, n)
        return out

    return blur_1d(blur_1d(img, -2), -1)[..., ::2, ::2]


def _box_sum(x, radius: int):
    """(2*radius+1)-box windowed sum of (..., H, W) along both axes via
    cumulative sums (flow.py:52-64)."""
    for dim in (-2, -1):
        n = x.shape[dim]
        pad = [0, 0, 0, 0]
        # F.pad lists the last axis first.
        pad[(-1 - dim) * 2:(-1 - dim) * 2 + 2] = [radius + 1, radius]
        c = torch.cumsum(torch.nn.functional.pad(x, pad), dim=dim)
        x = c.narrow(dim, 2 * radius + 1, n) - c.narrow(dim, 0, n)
    return x


def _gradient(img):
    """(gy, gx) of (..., H, W) as ``jnp.gradient``: central differences
    inside, one-sided at the edges."""
    def grad(x, dim):
        n = x.shape[dim]
        first = x.narrow(dim, 1, 1) - x.narrow(dim, 0, 1)
        mid = (x.narrow(dim, 2, n - 2) - x.narrow(dim, 0, n - 2)) / 2.0
        last = x.narrow(dim, n - 1, 1) - x.narrow(dim, n - 2, 1)
        return torch.cat([first, mid, last], dim=dim)

    return grad(img, -2), grad(img, -1)


def _warp_by_flow(img, u, v):
    """Bilinear sample of (..., H, W) ``img`` at (x + u, y + v) with
    edge-clamped indices, as map_coordinates(order=1, mode="nearest")
    forms it: weights from the unclamped coordinate, the four products
    summed in (y0 x0, y0 x1, y1 x0, y1 x1) order (flow.py:67-74)."""
    h, w = img.shape[-2:]
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    cy, cx = ys + v, xs + u
    fy, fx = torch.floor(cy), torch.floor(cx)
    wy1, wx1 = cy - fy, cx - fx
    wy0, wx0 = 1 - wy1, 1 - wx1
    iy0, ix0 = fy.to(torch.int64), fx.to(torch.int64)
    flat = img.reshape(img.shape[:-2] + (h * w,))

    def tap(iy, ix):
        idx = torch.clamp(iy, 0, h - 1) * w + torch.clamp(ix, 0, w - 1)
        idx = idx.expand(img.shape).reshape(flat.shape)
        return flat.gather(-1, idx).reshape(img.shape)

    out = (wy0 * wx0) * tap(iy0, ix0)
    out = out + (wy0 * wx1) * tap(iy0, ix0 + 1)
    out = out + (wy1 * wx0) * tap(iy0 + 1, ix0)
    return out + (wy1 * wx1) * tap(iy0 + 1, ix0 + 1)


def _lk_refine(prev, curr, u, v, radius: int, iters: int):
    """Iterative windowed LK refinement at one pyramid level
    (flow.py:77-102)."""
    gy, gx = _gradient(prev)
    sxx = _box_sum(gx * gx, radius)
    sxy = _box_sum(gx * gy, radius)
    syy = _box_sum(gy * gy, radius)
    det = sxx * syy - sxy * sxy
    # Flat or aperture-limited windows are damped toward zero flow.
    eps = 1e-3 * torch.clamp(torch.mean(sxx + syy, dim=(-2, -1),
                                        keepdim=True), min=1e-6)
    inv_det = 1.0 / (det + eps * eps)
    for _ in range(iters):
        it = _warp_by_flow(curr, u, v) - prev
        sxt = _box_sum(gx * it, radius)
        syt = _box_sum(gy * it, radius)
        du = -(syy * sxt - sxy * syt) * inv_det
        dv = -(sxx * syt - sxy * sxt) * inv_det
        u = u + torch.clamp(du, -radius, radius)
        v = v + torch.clamp(dv, -radius, radius)
    return u, v


def dense_flow_lk(prev, curr, levels: int = 3, radius: int = 7,
                  iters: int = 3):
    """Dense pyramidal LK flow prev -> curr (flow.py:105-138).

    Args:
      prev, curr: (..., H, W) u8 or float gray frames on one device.
      levels: pyramid levels (the coarsest absorbs ~2^(levels-1) px).
      radius: LK window radius (window 2*radius + 1, Farneback's 15).
      iters: refinement iterations per level (Farneback's 3).
    Returns (u, v): (..., H, W) f32 per-pixel flow.
    """
    a = prev.to(torch.float32)
    b = curr.to(torch.float32)
    pyr = [(a, b)]
    for _ in range(levels - 1):
        a = _pyr_down_f32(a)
        b = _pyr_down_f32(b)
        pyr.append((a, b))
    u = torch.zeros_like(pyr[-1][0])
    v = torch.zeros_like(pyr[-1][0])
    for lvl in range(levels - 1, -1, -1):
        pa, pb = pyr[lvl]
        if lvl != levels - 1:
            h, w = pa.shape[-2:]
            u = (u * 2.0).repeat_interleave(2, -2).repeat_interleave(
                2, -1)[..., :h, :w]
            v = (v * 2.0).repeat_interleave(2, -2).repeat_interleave(
                2, -1)[..., :h, :w]
        u, v = _lk_refine(pa, pb, u, v, radius, iters)
    return u, v


def _median(x, dim: int = -1):
    """``jnp.median`` along ``dim``: the mean of the two middle values of
    an even count, formed as (lo + hi) * 0.5."""
    n = x.shape[dim]
    s = torch.sort(x, dim=dim).values
    lo = s.narrow(dim, (n - 1) // 2, 1)
    hi = s.narrow(dim, n // 2, 1)
    return ((lo + hi) * 0.5).squeeze(dim)


def _median_flow_px(prev, curr, levels: int = 3, radius: int = 7,
                    iters: int = 3, crop: int = 8):
    """Median |flow| between (..., H, W) frame pairs, border-cropped (the
    per-pair statistic of eval_jitter.cpp:59-65, flow.py:141-151): (...,)
    f32."""
    u, v = dense_flow_lk(prev, curr, levels, radius, iters)
    mag = torch.hypot(u, v)
    if crop > 0:
        mag = mag[..., crop:-crop, crop:-crop]
    return _median(mag.flatten(-2))


_FLOW_STATICS = ("levels", "radius", "iters", "crop")
median_flow_px = Program(_median_flow_px, static_argnames=_FLOW_STATICS,
                         name="median_flow_px", max_keys=1)


def _median_jitter_px_device_impl(gray_clip, levels: int = 3,
                                  radius: int = 7, iters: int = 3,
                                  crop: int = 8):
    """(..., T, H, W) gray clips -> (...,) f32 medians over their
    consecutive-pair medians, on the clips' device (flow.py:154-164). The
    pairs of all clips run in groups of PAIR_GROUP_PIXELS."""
    lead, (t_n, h, w) = gray_clip.shape[:-3], gray_clip.shape[-3:]
    clips = gray_clip.reshape((-1, t_n, h, w))
    prevs = clips[:, :-1].reshape(-1, h, w)
    currs = clips[:, 1:].reshape(-1, h, w)
    group = max(1, PAIR_GROUP_PIXELS // (h * w))
    meds = torch.cat([
        median_flow_px(prevs[i:i + group], currs[i:i + group], levels,
                       radius, iters, crop)
        for i in range(0, prevs.shape[0], group)])
    return _median(meds.reshape(clips.shape[0], t_n - 1)).reshape(lead)


median_jitter_px_device_impl = Program(_median_jitter_px_device_impl,
                                       static_argnames=_FLOW_STATICS,
                                       name="median_jitter_px_device_impl",
                                       max_keys=1)


def gray_f32(frames):
    """(..., H, W) gray, or (..., H, W, 3) BGR converted as the JAX package
    converts it (round of 0.114 B + 0.587 G + 0.299 R in f32), in f32."""
    if frames.shape[-1] != 3:
        return frames.to(torch.float32)
    f = frames.to(torch.float32)
    return torch.round(0.114 * f[..., 0] + 0.587 * f[..., 1]
                       + 0.299 * f[..., 2])


def median_jitter_px_device(frames, levels: int = 3, radius: int = 7,
                            iters: int = 3, device=None) -> float:
    """``median_jitter_px`` of (T, H, W[, 3]) u8 frames with the dense-LK
    flow, on the device (flow.py:167-178): a tensor's own device, or
    ``device`` (the CUDA card unless given) for numpy frames or a list of
    them."""
    if not isinstance(frames, torch.Tensor):
        frames = torch.as_tensor(np.stack([np.asarray(f) for f in frames]))
        frames = frames.to(resolve_device(device))
    return float(median_jitter_px_device_impl(gray_f32(frames), levels,
                                              radius, iters))
