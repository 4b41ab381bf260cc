"""Configuration for the aligner and stabilizer (PyTorch port).

Field for field the same names and defaults as ``video_stabilizer_tpu.config``
so that a params object of the JAX package converts 1:1
(``params_from_jax_dict``), with the JAX package's construction-time
refusals (config.py:151-176). The one setting this port does not implement,
``dtype != "float32"``, raises ``NotImplementedError`` at construction
instead of being silently ignored.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class AlignerParams:
    """Per-frame alignment parameters (reference: alignment.hpp:5-41)."""

    phase_correlate: bool = False
    phase_correlate_threshold: float = 0.5
    # GN convergence: stop when the max corner movement in one iteration is
    # below this (pixels).
    threshold: float = 0.02
    # Fraction of keypoints (per axis set) kept after warp-diff rejection.
    smallest_fraction: float = 0.8
    # Max GN iterations per pyramid level.
    max_iters: int = 64
    # Fixed-iteration GN mode: every level of the 4-DOF aligner runs exactly
    # this many iterations (kernel B's fixed mode: no early stop, no
    # max_iters cap; converged means the last step moved no corner by the
    # threshold). None keeps the converge-or-max_iters loop. The 8-DOF
    # homography aligner ignores it, as the JAX package's does.
    fixed_iters: int | None = None
    # Accepted for 1:1 conversion: the JAX package merges the GN loops of
    # this many coarsest levels into one program (a program-shape option
    # whose result tests/test_merged_levels.py holds to the unmerged one).
    # The port runs the unmerged level loop whatever the value.
    merge_coarse: int = 0
    pyramid_min_width: int = 20
    pyramid_min_height: int = 20
    # Fail the frame if the converged per-level displacement exceeds this.
    max_displacement: float = 10.0
    selection: str = "mask"
    dtype: str = "float32"
    # Accepted for 1:1 conversion from the JAX package. The port runs every
    # level's GN loop in its own kernel (ops/gn_solve.py) whatever the value.
    gn_kernel: str = "auto"
    # Margin (pixels) of the per-tile sampling windows: the two coarsest
    # levels use window_margin, finer levels window_margin_fine.
    window_margin: int = 12
    window_margin_fine: int = 6
    # A TPU scheduling floor in the JAX package; kept for conversion only.
    gn_min_bytes: int | None = None
    # Accepted for 1:1 conversion: the JAX package runs a pair step's two
    # aligns as one 2-lane program (batch.py:109-122). The port already
    # aligns all of a chunk's pairs as one batch per level.
    pair_vmap: bool = False

    def __post_init__(self):
        if self.selection not in ("mask", "topk"):
            raise ValueError(f"selection must be 'mask' or 'topk', got "
                             f"{self.selection!r}")
        if self.gn_kernel not in ("auto", "pallas", "xla"):
            raise ValueError(f"gn_kernel must be 'auto', 'pallas' or 'xla',"
                             f" got {self.gn_kernel!r}")
        if self.merge_coarse >= 2:
            # The JAX package's refusals (config.py:151-176), word for word.
            if self.selection != "mask":
                raise ValueError(
                    "merge_coarse >= 2 requires selection='mask' (the "
                    "merged loop's in-loop selection is histogram "
                    f"masking); got selection={self.selection!r}")
            if self.fixed_iters is not None:
                raise ValueError(
                    "merge_coarse >= 2 is incompatible with fixed_iters "
                    "(the fixed-iteration mode has no while_loops to "
                    "merge)")
            if self.gn_kernel == "pallas":
                raise ValueError(
                    "merge_coarse >= 2 is incompatible with "
                    "gn_kernel='pallas' (the Pallas in-VMEM kernel has no "
                    "merged multi-level form); use 'auto' or 'xla'")
        if self.dtype != "float32":
            raise NotImplementedError(
                f"AlignerParams dtype={self.dtype!r} is not implemented by "
                "the PyTorch port (kernels B and C take float32 operands)")


@dataclasses.dataclass(frozen=True)
class StabilizerParams:
    """Stabilizer parameters (reference: stabilizer.hpp:13-30)."""

    aligner: AlignerParams = dataclasses.field(default_factory=AlignerParams)
    # Frames of delay before output; also the smoother's lag-behind window.
    lag: int = 10
    # The smoother's lag-ahead window ("memory").
    smoother_memory: int = 5
    lambda_: float = 4.0
    enable_smoother: bool = True
    # Crop the stabilized output by this many pixels on each side.
    crop_pixels: int = 32
    # Displacement-based decay of the accumulated correction.
    min_disp: float = 48.0
    max_disp: float = 64.0
    min_decay: float = 0.9
    max_decay: float = 0.7
    output_interp: str = "bilinear"
    # "auto" and "pallas" both mean the tile-local-base output warp
    # (ops/warp_kernel.py: kernel A on the card, its plain version on the
    # CPU); "fir" the global-base separable FIR (ops/fast_warp.py), cropped
    # after the warp. The one deliberate difference from the JAX package:
    # there "auto" picks the accelerator's kernel only on a TPU and FIR
    # elsewhere (models/batch.py:45-49), so on a CPU JAX's "auto" is FIR and
    # the port's is not. Tests that compare the two on a CPU pass
    # output_warp explicitly.
    output_warp: str = "auto"
    output_residual_bound: int | None = None

    def __post_init__(self):
        if self.output_interp not in ("bilinear", "lanczos2"):
            raise ValueError(f"output_interp must be 'bilinear' or "
                             f"'lanczos2', got {self.output_interp!r}")
        if self.output_warp not in ("auto", "pallas", "fir"):
            raise ValueError(f"output_warp must be 'auto', 'pallas' or "
                             f"'fir', got {self.output_warp!r}")


def params_from_jax_dict(d: dict):
    """Build the port's params from ``dataclasses.asdict`` of a JAX
    ``AlignerParams`` or ``StabilizerParams`` (the nested ``aligner`` of a
    stabilizer dict may itself be a dict)."""
    if "aligner" in d:
        fields = dict(d)
        al = fields.pop("aligner")
        if not isinstance(al, AlignerParams):
            al = AlignerParams(**al)
        return StabilizerParams(aligner=al, **fields)
    return AlignerParams(**d)


def default_residual_bound(width: int, height: int) -> int:
    """Per-resolution residual bound of the global-base FIR output warp:
    4 px at <=1080p, 7 px at 4K (|A,B| <= ~0.0027 at the image radius)."""
    radius = math.hypot(width, height) * 0.5
    return max(4, math.ceil(0.0027 * radius + 1.0))


def resolve_residual_bound(params: StabilizerParams, width: int,
                           height: int) -> int:
    if params.output_residual_bound is not None:
        return params.output_residual_bound
    return default_residual_bound(width, height)


def pyramid_shapes(width: int, height: int,
                   params: AlignerParams) -> Tuple[Tuple[int, int], ...]:
    """(width, height) of each pyramid level: halve until the next level
    would fall below pyramid_min (alignment.cpp:164-169)."""
    levels = []
    w, h = width, height
    while True:
        levels.append((w, h))
        w //= 2
        h //= 2
        if not (w >= params.pyramid_min_width
                and h >= params.pyramid_min_height):
            break
    return tuple(levels)


def tile_size_for(width: int, height: int, min_tiles: int = 1000,
                  max_tile_size: int = 20) -> int:
    """Largest even tile size in [2, 20] keeping >= min_tiles tiles
    (imgproc.cpp:151-162)."""
    tile_size = 2
    for i in range(4, max_tile_size + 1, 2):
        if (width // i) * (height // i) < min_tiles:
            break
        tile_size = i
    return tile_size
