"""video_stabilizer_tpu_torch — the PyTorch + CUDA port of
``video_stabilizer_tpu`` for NVIDIA Hopper (H100).

Layer map, mirroring the JAX package:

  config.py          AlignerParams / StabilizerParams (same fields)
  transforms.py      similarity-transform algebra on (..., 4) tensors
  homography.py      8-DOF homography algebra on (..., 8) tensors
  ops/               plain PyTorch ops (phase correlation, top-k and
                     histogram selection, the FIR output warp fast_warp.py,
                     the gather oracles warp.py and sparse.py) and the
                     hand-written CUDA kernels: warp_kernel.py (kernel A,
                     output warp, csrc/warp.cu), gn_solve.py (kernel B,
                     per-level 4-DOF GN loop, csrc/gn_solve.cu) and
                     gn8_solve.py (kernel C, per-level 8-DOF GN loop,
                     csrc/gn8_solve.cu), built at first use by cuda_build.py
  models/aligner.py  coarse-to-fine inverse-compositional LK aligner: the
                     batched level loop (per-item DynAlignParams), and its
                     streaming form (init_state, align_next_frame,
                     VideoAligner)
  models/homography_aligner.py  its 8-DOF homography counterpart
  models/smoother.py TV-L1 smoother, and the streaming L1SmootherCenter
  models/stabilizer.py  VideoStabilizer: one frame in, one stabilized
                     frame out, ``lag`` frames late (kernel A at one frame,
                     kernel B at one item per level)
  models/batch.py    clip and multi-stream pipelines (model="similarity" or
                     "homography"), and the streaming output_warp
  models/chunked.py  chunked serving with carried StreamState
  utils/checkpoint.py  save / load of a VideoStabilizer mid-stream, in the
                     JAX package's .npz layout
  utils/graphs.py    the program layer (jax.jit's counterpart): on the
                     card the chunk, the clip (align, stabilize, streams),
                     the streaming align step, gray and warp, the smoother
                     window, the dense-LK metric and the sweeps' programs
                     are captured once per static configuration as CUDA
                     graphs and replayed; ``graphs.eager()`` runs them
                     un-captured
  utils/spans.py     named CUDA-event spans of the pipeline stages (read
                     from the un-captured path)
  utils/metrics.py   PerformanceMetrics / time_function timers (CUDA events
                     when given a CUDA device), device_trace (torch.profiler)
  utils/flow.py      dense LK flow and median_jitter_px_device, on the device
  utils/jitter.py    the cv2 Farneback median_jitter_px (cv2 optional)
  utils/io.py        video I/O (cv2 optional, .y4m natively) and synthetic
                     footage
  utils/native.py    ctypes binding of native/libframepipe.so
  apps/              the JAX package's apps, ``python -m
                     video_stabilizer_tpu_torch.apps.<name> --device ...``

Entry points take ``device=None``, which means the CUDA card, and raise when
there is none; ``device="cpu"`` runs the plain PyTorch versions. The package
imports neither jax nor the JAX package.

Streaming, on the card or the CPU::

    from video_stabilizer_tpu_torch.config import StabilizerParams
    from video_stabilizer_tpu_torch.models import VideoStabilizer
    stab = VideoStabilizer(StabilizerParams(), device="cpu")  # None: card
    for frame in frames:                     # (H, W, 3) BGR u8
        out = stab.process_frame(frame)      # None for the first ``lag``

Resuming a stream that the JAX package checkpointed with its
``save_stabilizer``: ``utils.checkpoint.load_stabilizer(path, params)``.
"""

from video_stabilizer_tpu_torch import transforms
from video_stabilizer_tpu_torch.config import (
    AlignerParams,
    StabilizerParams,
    pyramid_shapes,
    tile_size_for,
)

__version__ = "0.1.0"

__all__ = [
    "transforms",
    "AlignerParams",
    "StabilizerParams",
    "pyramid_shapes",
    "tile_size_for",
]
