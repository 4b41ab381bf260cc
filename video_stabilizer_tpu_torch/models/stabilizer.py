"""The streaming video stabilizer, and the colour conversion of its input.

Port of ``video_stabilizer_tpu.models.stabilizer`` (VideoStabilizer::
processFrame, stabilizer.cpp:9-117). Per frame: buffer the input, measure
the inter-frame motion with the aligner, update the lagged TV-L1 smoother,
and once more than ``lag`` measurements exist, pop the earliest, form the
residual jitter ``meas o smoothed^-1`` (stabilizer.cpp:58-64), fold it into
the running accumulator with displacement-based decay (stabilizer.cpp:
69-87), and warp the delayed frame by it, cropped (stabilizer.cpp:96-109).

On the device: the colour conversion (kernel G, ``ops/gray.py``), the
aligner and the output warp (kernel A at one frame). On the host: the
4-vector bookkeeping and the decay algebra in float64, exactly as the JAX
package (stabilizer.py:40-83).
The measurement and its success flag come to the host once per frame, and
the smoother's output once per finalized frame. On the card each device
step is a replayed graph (utils/graphs.py): ``_to_gray``, the aligner's
``_align_next_frame_impl``, the smoother's ``_smooth_window`` and
``_warp_fn``, as each is a jitted program in the JAX package.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from video_stabilizer_tpu_torch import transforms as T
from video_stabilizer_tpu_torch.config import StabilizerParams
from video_stabilizer_tpu_torch.device import resolve_device
from video_stabilizer_tpu_torch.models.aligner import VideoAligner
from video_stabilizer_tpu_torch.models.smoother import L1SmootherCenter
from video_stabilizer_tpu_torch.ops.gray import bgr_to_gray
from video_stabilizer_tpu_torch.utils.graphs import Program
from video_stabilizer_tpu_torch.utils.spans import span


# The JAX package's jitted colour conversion (stabilizer.py:102): a replayed
# graph on the card.
_to_gray = Program(bgr_to_gray, name="_to_gray")


def _warp_body(frame, accum, params: StabilizerParams):
    """Warp the delayed (H, W, C) frame by ``accum``^-1, its (4,) float32
    centre-pivot correction: sample the source at accum(p), through its
    origin-based form on the frame's own size (stabilizer.py:125-139)."""
    # batch.py imports this module: import it at call time.
    from video_stabilizer_tpu_torch.models.batch import output_warp
    h, w = frame.shape[0], frame.shape[1]
    t = accum.to(frame.device)
    return output_warp(frame, T.center_to_ul(t, w, h, minus_one=True),
                       params)


# The JAX package's jitted output warp (stabilizer.py:137); the correction
# comes in through the graph's static input.
_warp_fn = Program(_warp_body, static_argnames=("params",), name="_warp_fn")


def bgr_to_gray_batched(frames):
    """Convert iff a channel axis of 3 is present."""
    if frames.shape[-1] != 3:
        return frames
    return bgr_to_gray(frames)


# Host float64 similarity algebra (stabilizer.py:44-72): the reference does
# the stabilizer's bookkeeping in double on the host.

def _np_inverse(t):
    p = 1.0 + t[0]
    q = t[1]
    denom = p * p + q * q
    return np.array([p / denom - 1.0, -q / denom,
                     (-p * t[2] - q * t[3]) / denom,
                     (q * t[2] - p * t[3]) / denom])


def _np_compose(t1, t2):
    p1, q1 = 1.0 + t1[0], t1[1]
    p2, q2 = 1.0 + t2[0], t2[1]
    return np.array([p2 * p1 - q2 * q1 - 1.0,
                     p2 * q1 + q2 * p1,
                     p2 * t1[2] - q2 * t1[3] + t2[2],
                     q2 * t1[2] + p2 * t1[3] + t2[3]])


def _np_max_corner_displacement(t, width, height):
    cx, cy = width * 0.5, height * 0.5
    a, b, tx, ty = t
    corners = np.array([[0, 0], [width, 0], [0, height], [width, height]],
                       np.float64)
    px = corners[:, 0] - cx
    py = corners[:, 1] - cy
    wx = (1 + a) * px - b * py + cx + tx
    wy = b * px + (1 + a) * py + cy + ty
    d = np.hypot(wx - corners[:, 0], wy - corners[:, 1])
    return float(np.max(d))


def decay_factor(displacement, params: StabilizerParams):
    """Displacement-based decay of the accumulator (stabilizer.cpp:69-87)."""
    if displacement > params.max_disp:
        return params.max_decay
    if displacement > params.min_disp:
        f = (displacement - params.min_disp) / (params.max_disp
                                                - params.min_disp)
        f = min(max(f, 0.0), 1.0)
        return params.min_decay * (1.0 - f) + params.max_decay * f
    return params.min_decay


class VideoStabilizer:
    """Streaming stabilizer with the reference's processFrame contract
    (stabilizer.hpp:32-39): feed (H, W, 3) BGR u8 frames one at a time; it
    returns None until more than ``lag`` frames have come, then one
    stabilized, cropped frame per call, on the device. Runs on ``device``,
    the CUDA card unless given (raises without one); ``device="cpu"`` runs
    the plain versions. ``utils.checkpoint.save_stabilizer`` /
    ``load_stabilizer`` carry it across processes, from the JAX package's
    files too."""

    def __init__(self, params: StabilizerParams = StabilizerParams(),
                 device=None):
        self.params = params
        self.device = resolve_device(device)
        self.aligner = VideoAligner(params.aligner, self.device)
        # lagBehind = lag, lagAhead = smoother_memory (stabilizer.cpp:3-4).
        self.smoother = L1SmootherCenter(
            params.lag, params.smoother_memory, params.lambda_,
            device=self.device)
        self._meas = collections.deque()
        self._frames = collections.deque()
        self._accum = np.zeros(4, np.float64)
        # The float32 correction sent to the warp. Pinned on the card, so
        # the upload is asynchronous: the next frame refills it only after
        # its measurement has been read back.
        self._accum_host = torch.zeros(4, dtype=torch.float32,
                                       pin_memory=self.device.type == "cuda")
        self.frame_index = 0
        self.align_failures = 0

    def _warp(self, frame, accum):
        """Warp the delayed frame by accum^-1 (``_warp_fn``)."""
        self._accum_host.copy_(torch.from_numpy(accum))
        t = self._accum_host.to(self.device, non_blocking=True)
        return _warp_fn(frame, t, self.params)

    def process_frame(self, frame_bgr):
        """Process one (H, W, 3) BGR u8 frame; returns the stabilized,
        cropped frame as a tensor on the device, or None while filling the
        lag."""
        self.frame_index += 1
        frame = torch.as_tensor(frame_bgr).to(self.device)
        h, w = frame.shape[0], frame.shape[1]
        self._frames.append(frame)

        # The reference's TIME_FUNCTION labels (alignment.cpp:150-701).
        with span("ConvertToGray"):
            gray = _to_gray(frame)
        with span("AlignNextFrame"):
            t_meas, ok = self.aligner.align_next_frame(gray)
        # One read of the device per frame: the measurement and ok.
        host = torch.cat([t_meas, ok[None].to(t_meas.dtype)]).cpu()
        current_meas = host[:4].numpy().astype(np.float64)
        success = bool(host[4])
        if not success and self.frame_index > 1:
            # The first frame always reports success=False (no pair yet,
            # alignment.cpp:231-234): warm-up, not a failure.
            self.align_failures += 1

        earliest_smoothed = None
        if self.params.enable_smoother:
            with span("SmootherUpdate"):
                earliest_smoothed = self.smoother.update(current_meas)

        # Alignment failure resets the accumulator (stabilizer.cpp:39-41).
        if not success:
            self._accum = np.zeros(4, np.float64)

        self._meas.append(current_meas)
        if len(self._meas) <= self.params.lag:
            return None

        earliest = self._meas.popleft()
        if self.params.enable_smoother and earliest_smoothed is not None:
            jitter = _np_compose(earliest, _np_inverse(earliest_smoothed))
        else:
            jitter = earliest
        new_accum = _np_compose(self._accum, jitter)
        # The displacement on the newest frame's size (stabilizer.py:183).
        disp = _np_max_corner_displacement(new_accum, w, h)
        new_accum = new_accum * decay_factor(disp, self.params)
        self._accum = new_accum

        if not self._frames:
            return None
        with span("WarpBySimilarityTransform"):
            return self._warp(self._frames.popleft(), new_accum)

    @property
    def accumulated_correction(self):
        return self._accum.copy()
