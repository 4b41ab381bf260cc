"""The coarse-to-fine inverse-compositional Lucas-Kanade aligner.

Port of ``video_stabilizer_tpu.models.aligner`` (the XLA path): keyframe
precompute (gradients, per-tile argmax, Jacobian rows, u8 sampling windows),
then per level the warp-diff keypoint selection and the Hessian at the
incoming transform, its regularized inverse, and the GN loop in kernel B
(``ops/gn_solve.py``). Every function of the level loop works on a batch of
items: an item is one alignment of a template pyramid against a keyframe,
and it names its keyframe by index so that several items share one
keyframe's windows.

The traced parameters of the JAX package (``DynAlignParams``: threshold,
keep fraction, failure bound) enter the level loop as ``dyn``, one value
for all items or one per item, so a parameter sweep puts its combos on the
item axis: kernel B takes one threshold per item.

The streaming form (``init_state``, ``align_next_frame``, ``VideoAligner``)
aligns one frame at a time against the alternating keyframe through the same
level loop, with one item and one keyframe. Its buffer index and frame count
are host ints, so the branch "compute the keyframe on keyframe frames"
(aligner.py:703-708) is taken on the host without reading the device, and
on the card each branch is one captured graph (``_align_next_frame_impl``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from video_stabilizer_tpu_torch import transforms as T
from video_stabilizer_tpu_torch.config import (
    AlignerParams, pyramid_shapes, tile_size_for)
from video_stabilizer_tpu_torch.device import resolve_device
from video_stabilizer_tpu_torch.ops import prelude
from video_stabilizer_tpu_torch.ops.gn_solve import gn_solve, item_thresholds
from video_stabilizer_tpu_torch.ops.keyframe import (
    LevelKeyData, keyframe_levels)
from video_stabilizer_tpu_torch.ops.linalg import regularized_pinv_sym4
from video_stabilizer_tpu_torch.ops.patches import (
    window_origins_flat, window_size)
from video_stabilizer_tpu_torch.ops.phase_corr import phase_correlate
from video_stabilizer_tpu_torch.ops.pyr_down import build_pyramid
# The plain prelude's steps, re-exported under their old module.
from video_stabilizer_tpu_torch.ops.prelude import (  # noqa: F401
    selection_mask, template_intensities)
from video_stabilizer_tpu_torch.utils.graphs import Program
from video_stabilizer_tpu_torch.utils.spans import span

# Alternating keyframe buffers (alignment.hpp:61-66).
KEYFRAME_INDEX = 1
NON_KEYFRAME_INDEX = 0
# Pyramid level of the phase-correlation init (alignment.hpp:69).
PHASE_LEVEL = 2


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    """Static geometry of one pyramid level."""
    width: int
    height: int
    tile: int
    wt: int       # tiles across
    ht: int       # tiles down
    margin: int   # sampling-window margin


def level_specs(width: int, height: int,
                params: AlignerParams) -> Tuple[LevelSpec, ...]:
    """Per-level geometry for a resolution (alignment.cpp:155-204); the two
    coarsest levels get the full window margin."""
    shapes = pyramid_shapes(width, height, params)
    n = len(shapes)
    specs = []
    for lvl, (w, h) in enumerate(shapes):
        t = tile_size_for(w, h)
        m = params.window_margin if lvl >= n - 2 else params.window_margin_fine
        specs.append(LevelSpec(w, h, t, w // t, h // t, m))
    return tuple(specs)


class DynAlignParams(NamedTuple):
    """The aligner's parameters that the JAX package traces, so that a
    sweep over them runs as one program (aligner.py:97-107). Each field is
    a float32 tensor: 0-d for every item, or one value per item of the
    level loop (``align_all_levels``) or per combo of a clip
    (``batch.align_clip_impl``)."""
    threshold: torch.Tensor            # GN step convergence (px)
    smallest_fraction: torch.Tensor    # keypoint keep fraction
    max_displacement: torch.Tensor     # per-level failure bound (px)


def make_dyn_params(params: AlignerParams, dtype=torch.float32,
                    device=None) -> DynAlignParams:
    """0-d ``DynAlignParams`` from ``params`` (aligner.py:110-115), on
    ``device`` (the CUDA card unless given)."""
    dev = resolve_device(device)
    return DynAlignParams(*(torch.tensor(v, dtype=dtype, device=dev)
                            for v in (params.threshold,
                                      params.smallest_fraction,
                                      params.max_displacement)))


def per_item_params(dyn, params: AlignerParams, items: int, device):
    """(threshold (items,) f32 tensor, keep fraction, failure bound) of a
    level loop: from ``dyn``, each field 0-d or (items,), or from
    ``params`` as Python floats when ``dyn`` is None."""
    if dyn is None:
        return (item_thresholds(params.threshold, items, device),
                params.smallest_fraction, params.max_displacement)
    for name, v in zip(dyn._fields, dyn):
        if v.dim() not in (0, 1) or (v.dim() == 1 and v.shape[0] != items):
            raise ValueError(f"dyn.{name}: want () or ({items},), got "
                             f"{tuple(v.shape)}")
    return (item_thresholds(dyn.threshold, items, device),
            dyn.smallest_fraction, dyn.max_displacement)


def _compute_keyframe(key_imgs, specs) -> Tuple[LevelKeyData, ...]:
    """GradXY -> GradArgMax -> SparseJacobian per level
    (alignment.cpp:237-276): ``ops.keyframe.keyframe_levels`` over every
    level (kernel I on the card, one launch for all levels). ``key_imgs``:
    per level (K, h, w) u8."""
    return keyframe_levels(list(key_imgs), specs, "similarity")


def _level_prelude(spec: LevelSpec, key: LevelKeyData, key_index, templates,
                   template_index, transform, params: AlignerParams,
                   fraction=None):
    """Everything of one level before the GN loop, at the incoming transform:
    template intensities, warp-diff selection (alignment.cpp:409-431, centre
    convention W*0.5; keep ``fraction`` as ``selection_mask`` takes it) and
    the Hessian over both selected sets (``ops.prelude``: kernel J on the
    card, the histogram mask or the exact count of ``selection="topk"``),
    then its regularized inverse (kernel E) (aligner.py:316-345). Returns (tmpl (B, 2, N),
    jac_masked (B, 4, 2, N) with the ICA X/Y-set average folded in,
    hinv (B, 4, 4), ox, oy)."""
    tmpl, jac_masked, hess = prelude.level_prelude(
        spec, key, key_index, templates, template_index, transform, params,
        fraction, "similarity")
    hinv = regularized_pinv_sym4(hess)
    ox, oy = window_origins_flat(spec.ht, spec.wt, spec.tile, spec.margin,
                                 device=transform.device)
    return tmpl, jac_masked, hinv.contiguous(), ox, oy


def _align_level(spec: LevelSpec, key: LevelKeyData, key_index, templates,
                 template_index, transform, params: AlignerParams,
                 item_params=None):
    """One pyramid level for B items: the prelude at the incoming transform,
    then the GN loop in kernel B (in its fixed-iteration mode when
    ``params.fixed_iters`` is set).

    Args:
      key: keyframe data of K keyframes; ``key_index`` (B,) picks each
        item's.
      templates: (M, h, w) u8 template images; ``template_index`` (B,).
      transform: (B, 4) incoming centre-pivot transforms.
      item_params: (threshold, keep fraction, failure bound) as
        ``per_item_params`` gives them; ``params``' values if None.
    Returns (t_raw, t_up, level_failed, iters), as aligner.py:443-452.
    """
    if item_params is None:
        item_params = per_item_params(None, params, transform.shape[0],
                                      transform.device)
    threshold, fraction, max_disp = item_params
    w, h = spec.width, spec.height
    # Kernel B's fixed mode takes -1 for off; a negative count runs no
    # iteration, as the JAX package's unrolled loop does.
    fixed = -1 if params.fixed_iters is None else max(params.fixed_iters, 0)
    with span(f"select {w}x{h}"):
        tmpl, jac_masked, hinv, ox, oy = _level_prelude(
            spec, key, key_index, templates, template_index, transform,
            params, fraction)
    with span(f"gn {w}x{h}"):
        t_final, converged, disp01, iters = gn_solve(
            key.windows, key_index, tmpl, jac_masked, hinv,
            key.coords[:, 0].contiguous(), key.coords[:, 1].contiguous(),
            ox, oy, transform.contiguous(), threshold=threshold,
            width=w, height=h, max_iters=params.max_iters,
            fixed_iters=fixed)

    # Failure 1: max_iters without convergence (alignment.cpp:661-667).
    # Failure 2: level displacement > max_displacement (670-677).
    level_failed = (~converged) | (disp01 > max_disp)
    # TX/TY double moving up a level (alignment.cpp:683-687).
    t_up = torch.cat([t_final[:, :2], t_final[:, 2:] * 2.0], dim=1)
    return t_final, t_up, level_failed, iters


def align_all_levels(templates, template_index, key, key_index, specs,
                     params: AlignerParams, t_init, dyn=None):
    """The coarse-to-fine level loop (alignment.cpp:390-688) for B items,
    with the traced parameters ``dyn`` (``DynAlignParams``, each field 0-d
    or (B,); ``params``' values if None), as aligner.py:640-675.

    With ``params.merge_coarse >= 2`` the JAX package runs the coarsest
    levels as one merged while_loop (aligner.py:487), a program-shape
    option held to the unmerged result (tests/test_merged_levels.py); here
    every level runs on its own whatever the value.

    Args:
      templates: per level (M, h, w) u8 template images.
      key: per level LevelKeyData of K keyframes.
      t_init: (B, 4) initial transforms.
    Returns (transform (B, 4), failed (B,)): the pre-inversion transform,
    frozen at the first failing level like the reference's early returns.
    """
    transform = t_init
    failed = torch.zeros(t_init.shape[0], dtype=torch.bool,
                         device=t_init.device)
    item_params = per_item_params(dyn, params, t_init.shape[0],
                                  t_init.device)
    for lvl in range(len(specs) - 1, -1, -1):
        t_raw, t_up, level_failed, _ = _align_level(
            specs[lvl], key[lvl], key_index, templates[lvl], template_index,
            transform, params, item_params)
        t_next = torch.where(level_failed[:, None], t_raw, t_up) \
            if lvl > 0 else t_raw
        transform = torch.where(failed[:, None], transform, t_next)
        failed = failed | level_failed
    return transform, failed


def phase_shift(img_prev, img_curr, num_levels: int, params: AlignerParams,
                flip):
    """Phase-correlation TX/TY init from two phase-level images
    (alignment.cpp:369-388, aligner.py:455-474), batched over leading axes:
    (shift * scale * flip (..., 2) f32, ok (...,) bool). The scale is the
    reference's (1 << PHASE_LEVEL) / (1 << levels), an implicit extra 0.5,
    kept as it is; ``flip`` is -1 on keyframes (alignment.cpp:383-386); ok
    is the response above the threshold."""
    lvl = min(PHASE_LEVEL, num_levels - 1)
    shift, response = phase_correlate(img_prev, img_curr)
    scale = (1 << lvl) / float(1 << num_levels)
    return shift * scale * flip, response > params.phase_correlate_threshold


def phase_init_pair(img_prev, img_curr, num_levels: int,
                    params: AlignerParams, is_keyframe: bool):
    """The (..., 4) initial transform of one alignment: the phase-correlation
    translation, or the identity where the response is at or below the
    threshold."""
    shift, ok = phase_shift(img_prev, img_curr, num_levels, params,
                            -1.0 if is_keyframe else 1.0)
    t = torch.cat([torch.zeros_like(shift), shift], dim=-1)
    return torch.where(ok[..., None], t, torch.zeros_like(t))


class AlignerState(NamedTuple):
    """Carried state of the streaming aligner. Axis 0 of each pyramid level
    is the double buffer: 0 = non-keyframe, 1 = keyframe
    (alignment.hpp:62-66). ``key`` holds one keyframe (K = 1)."""
    pyramid: Tuple[torch.Tensor, ...]   # per level (2, h, w) u8
    key: Tuple[LevelKeyData, ...]
    curr_idx: int                       # which buffer holds frame t
    frames_seen: int                    # saturates at 2


def init_state(width: int, height: int, params: AlignerParams,
               device=None) -> AlignerState:
    """The zero pre-stream state (aligner.py:139-160) on ``device`` (the
    CUDA card unless given)."""
    dev = resolve_device(device)
    specs = level_specs(width, height, params)
    pyramid = tuple(torch.zeros((2, s.height, s.width), dtype=torch.uint8,
                                device=dev) for s in specs)
    key = []
    for s in specs:
        n, p = s.ht * s.wt, window_size(s.tile, s.margin)
        key.append(LevelKeyData(
            idx_x=torch.zeros((1, s.ht, s.wt), dtype=torch.int32,
                              device=dev),
            idx_y=torch.zeros((1, s.ht, s.wt), dtype=torch.int32,
                              device=dev),
            coords=torch.zeros((1, 2, 2, n), device=dev),
            jac=torch.zeros((1, 4, 2, n), device=dev),
            windows=torch.zeros((1, n, p, p), dtype=torch.uint8,
                                device=dev)))
    return AlignerState(pyramid=pyramid, key=tuple(key), curr_idx=0,
                        frames_seen=0)


def _align_next_frame_body(state: AlignerState, gray,
                           params: AlignerParams, width: int, height: int):
    """The streaming align step (aligner.py:683-739). ``state``'s host ints
    (buffer index, frames seen) pick the branch, and key its graph."""
    specs = level_specs(width, height, params)
    # Buffer flip (alignment.cpp:158-159, 206-207): first frame -> buffer 0.
    curr = 0 if state.frames_seen == 0 else 1 - state.curr_idx
    with span("pyramid"):
        levels = build_pyramid(gray, len(specs))
        pyramid = tuple(torch.stack([lv, buf[1]] if curr == 0
                                    else [buf[0], lv])
                        for buf, lv in zip(state.pyramid, levels))
    # Keyframe precompute on keyframe frames (alignment.cpp:357-367).
    if curr == KEYFRAME_INDEX:
        with span("keyframe"):
            key = _compute_keyframe(
                [p[KEYFRAME_INDEX:KEYFRAME_INDEX + 1] for p in pyramid],
                specs)
    else:
        key = state.key
    if params.phase_correlate:
        lvl = min(PHASE_LEVEL, len(specs) - 1)
        with span("phase"):
            t_init = phase_init_pair(pyramid[lvl][1 - curr][None],
                                     pyramid[lvl][curr][None], len(specs),
                                     params, curr == KEYFRAME_INDEX)
    else:
        t_init = torch.zeros((1, 4), device=gray.device)
    one = torch.zeros(1, dtype=torch.int64, device=gray.device)
    templates = [p[NON_KEYFRAME_INDEX:NON_KEYFRAME_INDEX + 1]
                 for p in pyramid]
    transform, failed = align_all_levels(templates, one, key, one, specs,
                                         params, t_init)
    transform, failed = transform[0], failed[0]
    # Non-keyframes report the inverse (alignment.cpp:690-693); the
    # early-return failure paths skip the inversion.
    if curr != KEYFRAME_INDEX:
        transform = torch.where(failed, transform, T.inverse(transform))
    # The first frame has nothing to align to (alignment.cpp:231-234).
    if state.frames_seen == 0:
        transform = torch.zeros_like(transform)
        success = torch.zeros_like(failed)
    else:
        success = ~failed
    new_state = AlignerState(pyramid=pyramid, key=key, curr_idx=curr,
                             frames_seen=min(state.frames_seen + 1, 2))
    return new_state, transform, success


# The JAX package's jitted step (aligner.py:683): on the card one captured
# graph per branch (first frame, second, then keyframe and non-keyframe
# alternating), the state's buffers copied in at each replay.
_align_next_frame_impl = Program(
    _align_next_frame_body, static_argnames=("params", "width", "height"),
    name="_align_next_frame_impl")


def align_next_frame(state: AlignerState, gray, params: AlignerParams):
    """Align one (H, W) u8 gray frame, on the state's device, against the
    alternating keyframe (aligner.py:741-754); on the card a replay of
    ``_align_next_frame_impl``. ``state`` is left as it was.

    Returns (new_state, transform (4,) f32, success () bool), both on the
    device: ``transform`` measures the motion from the previous frame to
    this one; ``success`` is False for the first frame and on track loss.
    """
    h, w = gray.shape[-2], gray.shape[-1]
    return _align_next_frame_impl(state, gray, params, w, h)


class VideoAligner:
    """Stateful wrapper with the reference's VideoAligner API
    (alignment.hpp:51-58, aligner.py:757-779): re-initializes its state on a
    change of resolution (alignment.cpp:155). Runs on ``device``, the CUDA
    card unless given; ``device="cpu"`` runs the plain versions."""

    def __init__(self, params: AlignerParams = AlignerParams(), device=None):
        self.params = params
        self.device = resolve_device(device)
        self._state = None
        self._shape = None

    def align_next_frame(self, gray):
        """(H, W) u8 frame -> (transform (4,), success ()) on the device."""
        gray = torch.as_tensor(gray).to(self.device)
        shape = (gray.shape[-2], gray.shape[-1])
        if self._state is None or shape != self._shape:
            self._state = init_state(shape[1], shape[0], self.params,
                                     self.device)
            self._shape = shape
        self._state, t, ok = align_next_frame(self._state, gray, self.params)
        return t, ok

    def reset(self):
        self._state = None
        self._shape = None
