"""Video and image I/O (host side) and synthetic test footage.

Port of ``video_stabilizer_tpu.utils.io`` (io.py:1-221). The reference uses
OpenCV VideoCapture / VideoWriter (video_test.cpp:27-75); cv2 is the
primary backend here too, with an imageio fallback, and both are optional
imports: ``.y4m`` files read through the native reader (``utils/native.py``)
without either. ``natural_texture`` and ``synth_shaky_clip`` give the JAX
package's frames for the same seeds: the texture is made with numpy as
there, and the crops run in float64 torch ops in the same order as the
numpy version's, on the CPU or on a card (IEEE float64 elementwise ops
round alike on both).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np
import torch

try:
    import cv2  # type: ignore

    HAS_CV2 = True
except Exception:  # pragma: no cover
    cv2 = None
    HAS_CV2 = False


def read_video(path: str,
               max_frames: Optional[int] = None) -> Iterator[np.ndarray]:
    """Yield (H, W, 3) BGR u8 frames. ``.y4m`` files use the native
    zero-dependency reader (utils/native.py); everything else cv2, or
    imageio without cv2."""
    if path.endswith(".y4m"):
        from video_stabilizer_tpu_torch.utils import native

        if native.available():
            r = native.Y4MReader(path)
            try:
                for n, frame in enumerate(r.frames_bgr()):
                    if max_frames is not None and n >= max_frames:
                        break
                    yield frame
            finally:
                r.close()
            return
    if HAS_CV2:
        cap = cv2.VideoCapture(path)
        try:
            n = 0
            while max_frames is None or n < max_frames:
                ok, frame = cap.read()
                if not ok:
                    break
                yield frame
                n += 1
        finally:
            cap.release()
    else:  # pragma: no cover
        import imageio.v2 as imageio

        reader = imageio.get_reader(path)
        try:
            for n, rgb in enumerate(reader):
                if max_frames is not None and n >= max_frames:
                    break
                yield rgb[..., ::-1].copy()  # RGB -> BGR
        finally:
            reader.close()


class VideoWriter:
    """Minimal BGR u8 mp4 writer (video_test.cpp:61-75 analog)."""

    def __init__(self, path: str, fps: float = 30.0):
        self.path = path
        self.fps = fps
        self._writer = None

    def write(self, frame_bgr: np.ndarray):
        frame_bgr = np.asarray(frame_bgr, np.uint8)
        if self._writer is None:
            h, w = frame_bgr.shape[:2]
            if HAS_CV2:
                fourcc = cv2.VideoWriter_fourcc(*"mp4v")
                self._writer = cv2.VideoWriter(self.path, fourcc, self.fps,
                                               (w, h))
            else:  # pragma: no cover
                import imageio.v2 as imageio

                self._writer = imageio.get_writer(self.path, fps=self.fps)
        if HAS_CV2:
            self._writer.write(frame_bgr)
        else:  # pragma: no cover
            self._writer.append_data(frame_bgr[..., ::-1])

    def close(self):
        if self._writer is not None:
            if HAS_CV2:
                self._writer.release()
            else:  # pragma: no cover
                self._writer.close()
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def gray_to_bgr(gray: np.ndarray) -> np.ndarray:
    return np.repeat(np.asarray(gray, np.uint8)[..., None], 3, axis=-1)


def make_textured_image(height: int, width: int, seed: int = 12345,
                        smooth: int = 2) -> np.ndarray:
    """Blurred-noise texture (u8 grayscale). Its gradient autocorrelation
    oscillates (goes negative beyond ~2px), which defeats the LK scheme's
    fixed-keyframe-gradient linearization for multi-pixel motion: use
    ``natural_texture`` for alignment-facing fixtures."""
    r = np.random.default_rng(seed)
    img = r.uniform(0, 255, size=(height, width)).astype(np.float64)
    for _ in range(smooth):
        acc = np.zeros_like(img)
        for s in (-2, -1, 0, 1, 2):
            acc += np.roll(img, s, axis=0) + np.roll(img, s, axis=1)
        img = acc / 10.0
    img -= img.min()
    img = img / max(img.max(), 1e-9) * 255.0
    return img.astype(np.uint8)


def natural_texture(height: int, width: int, seed: int = 42) -> np.ndarray:
    """1/f-spectrum multi-octave texture with natural-image-like positive
    gradient autocorrelation — the synthetic stand-in for real footage."""
    r = np.random.default_rng(seed)
    img = np.zeros((height, width))
    for octave, amp in [(4, 1.0), (8, 2.0), (16, 4.0), (32, 8.0), (64, 16.0)]:
        small = r.uniform(-1, 1, (height // octave + 2, width // octave + 2))
        ups = np.kron(small, np.ones((octave, octave)))[: height + octave,
                                                        : width + octave]
        for ax in (0, 1):
            ups = np.cumsum(ups, axis=ax)
            ups = (np.roll(ups, -octave, axis=ax) - ups) / octave
        img += amp * ups[:height, :width]
    img -= img.min()
    img = img / max(img.max(), 1e-9) * 255.0
    return img.astype(np.uint8)


def synth_shaky_clip(num_frames: int, height: int, width: int,
                     seed: int = 7, jitter_px: float = 4.0,
                     pan_px_per_frame: float = 0.5,
                     color: bool = True,
                     rot_jitter: float = 0.0,
                     zoom_jitter: float = 0.0, *,
                     device="cpu", poses: bool = False):
    """Synthesize a shaky clip: a large textured canvas viewed through a
    window whose pose = smooth pan + per-frame similarity jitter.

    ``rot_jitter`` / ``zoom_jitter`` are the per-frame standard deviations
    of the window's B (rotation, rad) and A (zoom) parameters — the full
    4-DOF model of imgproc.hpp:40-46, so E2E fixtures exercise the same
    A/B axes the aligner solves for (translation-only fixtures can't catch
    rotational regressions). They draw from an independent RNG stream, so
    translation-only clips are bit-identical to the pre-extension fixture.

    ``device`` is where the crops are computed; the clip is returned as
    numpy either way. Returns (T, H, W, 3) BGR u8 (or (T, H, W) if
    color=False); with ``poses=True`` also the (T, 4) float64 window poses
    (A, B, x offset, y offset) of each frame, the ground truth of its
    motion.
    """
    r = np.random.default_rng(seed)
    r_ab = np.random.default_rng(seed + 104729)  # independent A/B stream
    radius = float(np.hypot(width, height)) * 0.5
    margin = int(np.ceil(jitter_px * 4 + pan_px_per_frame * num_frames
                         + (3.0 * rot_jitter + 3.0 * zoom_jitter) * radius)
                 ) + 8
    f64 = dict(dtype=torch.float64, device=device)
    canvas = torch.from_numpy(natural_texture(
        height + 2 * margin, width + 2 * margin, seed=seed)).to(**f64)
    use_sim = rot_jitter > 0 or zoom_jitter > 0
    if use_sim:
        ys_g, xs_g = torch.meshgrid(torch.arange(height, **f64),
                                    torch.arange(width, **f64), indexing="ij")
        px = xs_g - (width - 1) * 0.5
        py = ys_g - (height - 1) * 0.5
    frames = torch.empty((num_frames, height, width), dtype=torch.uint8,
                         device=device)
    pose = np.zeros((num_frames, 4))
    for t in range(num_frames):
        ox = margin + pan_px_per_frame * t + r.normal(0, jitter_px)
        oy = margin + r.normal(0, jitter_px)
        if use_sim:
            a_t = r_ab.normal(0, zoom_jitter) if zoom_jitter > 0 else 0.0
            b_t = r_ab.normal(0, rot_jitter) if rot_jitter > 0 else 0.0
            pose[t] = a_t, b_t, ox, oy
            # Window-center similarity: canvas pos of output pixel p.
            wx = (1.0 + a_t) * px - b_t * py + ox + (width - 1) * 0.5
            wy = b_t * px + (1.0 + a_t) * py + oy + (height - 1) * 0.5
            x0 = torch.floor(wx).to(torch.int64)
            y0 = torch.floor(wy).to(torch.int64)
            fx = wx - x0
            fy = wy - y0
            x0 = x0.clamp(0, canvas.shape[1] - 2)
            y0 = y0.clamp(0, canvas.shape[0] - 2)
            top = canvas[y0, x0] * (1 - fx) + canvas[y0, x0 + 1] * fx
            bot = canvas[y0 + 1, x0] * (1 - fx) + canvas[y0 + 1, x0 + 1] * fx
        else:
            pose[t] = 0.0, 0.0, ox, oy
            # Bilinear crop at subpixel offset (fast translation-only path).
            x0, y0 = int(np.floor(ox)), int(np.floor(oy))
            fx, fy = ox - x0, oy - y0
            win = canvas[y0: y0 + height + 1, x0: x0 + width + 1]
            top = win[:-1, :-1] * (1 - fx) + win[:-1, 1:] * fx
            bot = win[1:, :-1] * (1 - fx) + win[1:, 1:] * fx
        frames[t] = (top * (1 - fy) + bot * fy).to(torch.uint8)
    if color:
        frames = frames[..., None].expand(-1, -1, -1, 3)
    clip = frames.contiguous().cpu().numpy()
    return (clip, pose) if poses else clip


def ensure_test_clip(path: str, num_frames: int = 60, height: int = 360,
                     width: int = 640) -> str:
    """Write (once) and return the path of the bundled synthetic test clip."""
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        clip = synth_shaky_clip(num_frames, height, width)
        with VideoWriter(path) as w:
            for f in clip:
                w.write(f)
    return path
