"""Residual-jitter evaluation metric.

Port of ``video_stabilizer_tpu.utils.jitter`` (jitter.py:1-103). Reference:
eval_jitter.cpp:46-71 — per consecutive-frame pair, dense Farneback optical
flow, the median flow magnitude over pixels; ``median_jitter_px`` is the
median of those per-frame medians. The grid searches score combos by the
ratio out_jitter / in_jitter (grid_search_align.cpp:183-184).

Uses cv2's Farneback (the reference's algorithm and parameters), on the
host. cv2 is optional: without it this metric refuses to run rather than
silently substituting another statistic, unless
``VIDSTAB_ALLOW_JITTER_FALLBACK=1`` opts into the dense-LK twin
(``utils/flow.py``), whose values are not comparable with Farneback-based
baselines.
"""

from __future__ import annotations

import os
import warnings

import numpy as np

try:
    import cv2  # type: ignore

    HAS_CV2 = True
except Exception:  # pragma: no cover
    cv2 = None
    HAS_CV2 = False

# Farneback parameters as in eval_jitter.cpp:50-51.
_FARNEBACK_ARGS = dict(pyr_scale=0.5, levels=3, winsize=15, iterations=3,
                       poly_n=5, poly_sigma=1.2, flags=0)


def _flow_median_cv2(prev_gray, gray):
    flow = cv2.calcOpticalFlowFarneback(prev_gray, gray, None,
                                        **_FARNEBACK_ARGS)
    mag = np.hypot(flow[..., 0], flow[..., 1])
    return float(np.median(mag))


def _flow_median_fallback(prev_gray, gray, device=None):
    """Opt-in cv2-free path: the dense-LK median |flow| (utils/flow.py),
    on ``device`` (the CUDA card unless given). Guarded by
    VIDSTAB_ALLOW_JITTER_FALLBACK so that a missing cv2 never silently
    changes a regression baseline."""
    if os.environ.get("VIDSTAB_ALLOW_JITTER_FALLBACK") != "1":
        raise RuntimeError(
            "median_jitter_px requires cv2 for the reference-exact Farneback "
            "statistic (eval_jitter.cpp:50-51). cv2 is unavailable; set "
            "VIDSTAB_ALLOW_JITTER_FALLBACK=1 to use the on-device dense-LK "
            "twin (different algorithm — do not compare against "
            "Farneback-based baselines), or use "
            "utils.flow.median_jitter_px_device explicitly.")
    warnings.warn("median_jitter_px: cv2 unavailable — using the dense-LK "
                  "fallback; values are not comparable with Farneback-based "
                  "baselines.", RuntimeWarning, stacklevel=3)
    import torch

    from video_stabilizer_tpu_torch.device import resolve_device
    from video_stabilizer_tpu_torch.utils.flow import median_flow_px

    dev = resolve_device(device)
    return float(median_flow_px(
        torch.as_tensor(np.asarray(prev_gray, np.float32)).to(dev),
        torch.as_tensor(np.asarray(gray, np.float32)).to(dev)))


def median_jitter_px(frames, device=None) -> float:
    """``median_jitter_px`` over an iterable of frames (BGR u8 or gray u8):
    the median over frames of the per-frame median Farneback-flow magnitude
    (eval_jitter.cpp:59-71). ``device`` serves only the opt-in cv2-free
    fallback."""
    per_frame = []
    prev = None
    for frame in frames:
        frame = np.asarray(frame)
        if frame.ndim == 3:
            if HAS_CV2:
                gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            else:
                f = frame.astype(np.float64)
                gray = np.clip(np.round(
                    0.114 * f[..., 0] + 0.587 * f[..., 1] + 0.299 * f[..., 2]),
                    0, 255).astype(np.uint8)
        else:
            gray = frame
        if prev is not None:
            if HAS_CV2:
                per_frame.append(_flow_median_cv2(prev, gray))
            else:
                per_frame.append(_flow_median_fallback(prev, gray, device))
        prev = gray
    if not per_frame:
        return 0.0
    return float(np.median(np.asarray(per_frame)))


def jitter_ratio(input_frames, output_frames) -> float:
    """out/in jitter ratio — the grid searches' objective
    (grid_search_align.cpp:183-184). Lower is better."""
    in_j = median_jitter_px(input_frames)
    out_j = median_jitter_px(output_frames)
    return out_j / max(in_j, 1e-12)
