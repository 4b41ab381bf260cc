"""Compute ops of the PyTorch port: plain PyTorch, and the hand-written
CUDA kernels A-J (``warp_kernel``, ``gn_solve``, ``gn8_solve``, ``tvl1``,
``linalg``'s pseudo-inverse, ``accum``, ``gray``, ``pyr_down``,
``keyframe``, ``prelude``) built from ``csrc/`` at first use. The names
exported here are those of ``video_stabilizer_tpu.ops``; the ``prelude``
module (kernel J) has no counterpart there."""

from video_stabilizer_tpu_torch.ops.lanczos import lanczos2, lanczos2_exact
from video_stabilizer_tpu_torch.ops.pyr_down import pyr_down, build_pyramid
from video_stabilizer_tpu_torch.ops.grad import grad_xy
from video_stabilizer_tpu_torch.ops.argmax import (
    grad_argmax, tile_view, take_at_tile_argmax)
from video_stabilizer_tpu_torch.ops.warp import (
    image_warp,
    image_warp_ul,
    warp_image_bgr,
    warp_by_similarity_transform,
)
from video_stabilizer_tpu_torch.ops.sparse import (
    sparse_jacobian,
    sparse_warp_sample,
    sparse_warpdiff,
    sparse_ica,
)
from video_stabilizer_tpu_torch.ops.fast_warp import (
    warp_field_fast,
    warp_homography_fast,
    warp_image_fast,
)
from video_stabilizer_tpu_torch.ops.phase_corr import phase_correlate
from video_stabilizer_tpu_torch.ops.select import histogram_mask, topk_mask
from video_stabilizer_tpu_torch.ops.linalg import (
    eigh_sym, regularized_pinv_sym4)
# Kernel J's module, select's prelude: no JAX counterpart to mirror.
from video_stabilizer_tpu_torch.ops import prelude  # noqa: F401

__all__ = [
    "lanczos2", "lanczos2_exact",
    "pyr_down", "build_pyramid",
    "grad_xy",
    "grad_argmax", "tile_view", "take_at_tile_argmax",
    "image_warp", "image_warp_ul", "warp_image_bgr",
    "warp_by_similarity_transform",
    "sparse_jacobian", "sparse_warp_sample", "sparse_warpdiff", "sparse_ica",
    "warp_field_fast", "warp_homography_fast", "warp_image_fast",
    "phase_correlate", "histogram_mask", "topk_mask",
    "eigh_sym", "regularized_pinv_sym4",
]
