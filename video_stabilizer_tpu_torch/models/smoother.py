"""L1 / total-variation trajectory smoother (smoother.cpp:18-127).

Per transform parameter, 100 fixed iterations of (a) relaxation toward the
data (alpha = 0.5) and (b) a sequential left-to-right sweep of pairwise
difference shrinkage. Same expressions as
``video_stabilizer_tpu.models.smoother.tvl1_smooth`` (smoother.py:30-80):
on the card kernel D runs the whole loop (``ops/tvl1.py``).
``L1SmootherCenter`` is the streaming form (smoother.py:109-159): one
measurement in, one finalized smoothed transform out, ``lag_ahead`` late.
"""

from __future__ import annotations

import numpy as np
import torch

from video_stabilizer_tpu_torch.device import resolve_device
from video_stabilizer_tpu_torch.ops.tvl1 import (
    tvl1_smooth_kernel, tvl1_smooth_plain)
from video_stabilizer_tpu_torch.utils.graphs import Program


def tvl1_smooth(data, lam, iterations: int = 100, valid_len=None):
    """TV-L1 smooth along the last axis, batched over leading axes.

    ``lam``: a float, or a tensor broadcastable to ``data.shape[:-1]`` (one
    smoothing strength per row, as the JAX package's traced ``lam`` is
    under vmap). ``valid_len``: optional int or integer tensor
    broadcastable to ``data.shape[:-1]``; only the first ``valid_len``
    entries of a row are real and pair updates beyond them are inert.

    On the card this is one launch of kernel D (``ops/tvl1.py``, float32);
    on the CPU the plain version.
    """
    if data.device.type == "cpu":
        return tvl1_smooth_plain(data, lam, iterations, valid_len)
    return tvl1_smooth_kernel(data, lam, iterations, valid_len)


def tvl1_smooth_np(data, lam, iterations: int = 100):
    """Pure-numpy float64 twin of ``tvl1_smooth`` (smoother.py:83-99): the
    host mode of ``L1SmootherCenter`` and an oracle for tests."""
    x = np.array(data, np.float64, copy=True)
    d = np.asarray(data, np.float64)
    n = x.shape[-1]
    for _ in range(iterations):
        x = 0.5 * x + 0.5 * d
        for i in range(n - 1):
            diff = x[..., i + 1] - x[..., i]
            mag = np.abs(diff)
            gt = mag > lam
            shrink = np.where(gt, (mag - lam) / np.maximum(mag, 1e-300) * 0.5,
                              0.0)
            mid = 0.5 * (x[..., i] + x[..., i + 1])
            x[..., i] = np.where(gt, x[..., i] + diff * shrink, mid)
            x[..., i + 1] = np.where(gt, x[..., i + 1] - diff * shrink, mid)
    return x


def _smooth_window_body(buf, lam: float, middle: int, count: int,
                        iterations: int):
    """Smooth a (window, 4) float32 buffer whose first ``count`` rows are
    valid and return its ``middle`` row (smoother.py:101-106)."""
    sm = tvl1_smooth(buf.T, lam, iterations=iterations, valid_len=count)
    return sm[:, middle]


# The JAX package's jitted window (smoother.py:101): on the card one
# captured graph per (count, middle), one in steady state.
_smooth_window = Program(
    _smooth_window_body,
    static_argnames=("lam", "middle", "count", "iterations"),
    name="_smooth_window")


class L1SmootherCenter:
    """Streaming lagged smoother (smoother.cpp:66-127, smoother.py:109-159):
    finalizes measurement k once k + lag_ahead measurements exist, smoothing
    the window [k - lag_behind, k + lag_ahead] and emitting its element k.

    The window is a fixed ring buffer on the host. ``jit_smooth=True`` (the
    JAX package's default, whose jitted float32 smooth it mirrors) smooths
    in float32 on ``device`` (the CUDA card unless given) through
    ``_smooth_window`` (on the card a replayed graph; the window goes up
    from a pinned host buffer); ``jit_smooth=False`` smooths in float64 on
    the host (the reference's double math).
    """

    def __init__(self, lag_behind: int, lag_ahead: int, lambda_: float = 1.0,
                 iterations: int = 100, jit_smooth: bool = True,
                 device=None):
        self.lag_behind = lag_behind
        self.lag_ahead = lag_ahead
        self.lambda_ = lambda_
        self.iterations = iterations
        self.jit_smooth = jit_smooth
        self.device = resolve_device(device)
        self.window = lag_behind + lag_ahead + 1
        self._buf = np.zeros((self.window, 4), np.float64)  # ring
        # The float32 window sent to the device. Pinned on the card, so the
        # upload is asynchronous: the next update refills it only after
        # this one's result has been read back.
        self._stage = torch.zeros((self.window, 4), dtype=torch.float32,
                                  pin_memory=self.device.type == "cuda")
        self._total = 0           # measurements received
        self._next_to_finalize = 0

    def update(self, meas):
        """Push one (4,) measurement. Returns the finalized (4,) float64
        numpy transform, or None until the window ahead is full
        (smoother.cpp:84-86)."""
        self._buf[self._total % self.window] = np.asarray(meas, np.float64)
        self._total += 1
        newest = self._total - 1
        k = self._next_to_finalize
        if k + self.lag_ahead > newest:
            return None
        start = max(0, k - self.lag_behind)
        end = k + self.lag_ahead                      # inclusive
        idx = np.arange(start, end + 1)
        window_vals = self._buf[idx % self.window]    # (n, 4)
        middle = k - start
        if self.jit_smooth:
            stage = self._stage.numpy()
            stage[:] = 0.0
            stage[:len(idx)] = window_vals
            sm = _smooth_window(self._stage.to(self.device, non_blocking=True),
                                self.lambda_, middle, len(idx),
                                self.iterations)
            out = sm.cpu().numpy().astype(np.float64)
        else:
            sm = tvl1_smooth_np(window_vals.T, self.lambda_, self.iterations)
            out = sm[:, middle]
        self._next_to_finalize += 1
        return out
