"""8-DOF homography alignment and stabilization, batched.

Port of ``video_stabilizer_tpu.models.homography_aligner``: the same
pyramid, per-tile argmax keypoints, u8 sampling windows and keypoint
selection (``selection``: histogram or exact top-k) as the similarity
aligner (``models/aligner.py``); 8 parameters
over centered width-normalized coordinates (``homography.py``), an 8x8
Hessian with the round-robin Jacobi pseudo-inverse, textbook GN steps (no
0.5 set average, no 1/width scaling of dt) and no TX/TY doubling between
levels. Each level's GN loop runs in kernel C (``ops/gn8_solve.py``).
``AlignerParams.fixed_iters`` is ignored here, as in the JAX package, whose
``_align_level_h`` always runs its converging while_loop
(homography_aligner.py:126-215): kernel C has no fixed-iteration mode.

An item is one alignment of a template pyramid against a keyframe, named by
index, as in ``models/aligner.py``. The clip, stream and chunked pipelines
are those of ``models/batch.py`` and ``models/chunked.py`` with
``model="homography"``; the entry points below name them. The JAX
package's three homography clip programs (homography_aligner.py:326, 436,
449) are batch's clip programs keyed on ``model="homography"``: the same
captured graphs as the entry points below replay.
"""

from __future__ import annotations

import functools

import torch

from video_stabilizer_tpu_torch.config import AlignerParams, StabilizerParams
from video_stabilizer_tpu_torch.models.aligner import (
    LevelKeyData, LevelSpec, per_item_params)
from video_stabilizer_tpu_torch.models.batch import (
    _align_clip_jit, _stabilize_clip_jit, _stabilize_streams_jit, align_clip,
    stabilize_clip, stabilize_clip_core, stabilize_streams, warp_delayed)
from video_stabilizer_tpu_torch.ops import prelude
from video_stabilizer_tpu_torch.ops.gn8_solve import (
    gn8_solve, normalized_keypoints)
from video_stabilizer_tpu_torch.ops.keyframe import keyframe_levels
from video_stabilizer_tpu_torch.ops.linalg import regularized_pinv_sym4
from video_stabilizer_tpu_torch.ops.patches import window_origins_flat
from video_stabilizer_tpu_torch.utils.spans import span

# The homography keyframe carries the similarity one's fields; only ``jac``
# differs in shape: (K, 8, 2 sets, N).
LevelKeyDataH = LevelKeyData


def _compute_keyframe_h(key_imgs, specs):
    """Per level: gradients, per-tile argmax, the (K, 8, 2, N) Jacobian
    rows in normalized coordinates and the u8 windows
    (homography_aligner.py:74-113): ``ops.keyframe.keyframe_levels`` over
    every level (kernel I on the card, one launch for all levels).
    ``key_imgs``: per level (K, h, w) u8."""
    return keyframe_levels(list(key_imgs), specs, "homography")


def _level_prelude_h(spec: LevelSpec, key: LevelKeyData, key_index,
                     templates, template_index, p, params: AlignerParams,
                     fraction=None):
    """Template intensities, warp-diff selection at the incoming ``p`` (keep
    ``fraction`` as ``aligner.selection_mask`` takes it), the 8x8 Hessian
    (``ops.prelude``: kernel J on the card, either selection) and its
    regularized inverse (kernel E)
    (homography_aligner.py:126-149). Returns (tmpl (B, 2, N), jac_masked
    (B, 8, 2, N), hinv (B, 8, 8), u, v (K, 2, N), ox, oy)."""
    tmpl, jac_masked, hess = prelude.level_prelude(
        spec, key, key_index, templates, template_index, p, params,
        fraction, "homography")
    hinv = regularized_pinv_sym4(hess)
    ox, oy = window_origins_flat(spec.ht, spec.wt, spec.tile, spec.margin,
                                 device=p.device)
    u, v = normalized_keypoints(key, spec)
    return tmpl, jac_masked, hinv.contiguous(), u, v, ox, oy


def _align_level_h(spec: LevelSpec, key: LevelKeyData, key_index, templates,
                   template_index, p, params: AlignerParams,
                   item_params=None):
    """One pyramid level for B items: the prelude at the incoming ``p``
    (B, 8), then the GN loop in kernel C, with ``item_params`` (threshold,
    keep fraction, failure bound) as ``aligner.per_item_params`` gives them
    (``params``' values if None). Returns (p_final, level_failed, iters)."""
    if item_params is None:
        item_params = per_item_params(None, params, p.shape[0], p.device)
    threshold, fraction, max_disp = item_params
    w, h = spec.width, spec.height
    with span(f"select {w}x{h}"):
        tmpl, jac_masked, hinv, u, v, ox, oy = _level_prelude_h(
            spec, key, key_index, templates, template_index, p, params,
            fraction)
    # No fixed_iters here: the JAX package's 8-DOF level always runs its
    # converging loop (homography_aligner.py:126-215).
    with span(f"gn8 {w}x{h}"):
        p_fin, converged, disp01, iters = gn8_solve(
            key.windows, key_index, tmpl, jac_masked, hinv, u, v, ox, oy,
            p.contiguous(), threshold=threshold, width=w, height=h,
            max_iters=params.max_iters)
    level_failed = (~converged) | (disp01 > max_disp)
    return p_fin, level_failed, iters


def align_all_levels_h(templates, template_index, key, key_index, specs,
                       params: AlignerParams, p_init, dyn=None):
    """Coarse to fine for B items, with the traced parameters ``dyn``
    (``aligner.DynAlignParams``, each field 0-d or (B,); ``params``' values
    if None); the normalized parameters carry unchanged between levels, and
    a failing level freezes the item's ``p`` (homography_aligner.py:
    219-231). Returns (p (B, 8), failed (B,))."""
    p = p_init
    failed = torch.zeros(p_init.shape[0], dtype=torch.bool,
                         device=p_init.device)
    item_params = per_item_params(dyn, params, p_init.shape[0],
                                  p_init.device)
    for lvl in range(len(specs) - 1, -1, -1):
        p_new, level_failed, _ = _align_level_h(
            specs[lvl], key[lvl], key_index, templates[lvl], template_index,
            p, params, item_params)
        p = torch.where((failed | level_failed)[:, None], p, p_new)
        failed = failed | level_failed
    return p, failed


def warp_delayed_homography(delayed, accums, params: StabilizerParams,
                            width: int, height: int):
    """Warp + crop delayed frames by their (..., 8) corrections, which are
    the sampling homographies themselves (homography_aligner.py:382-408)."""
    return warp_delayed(delayed, accums, params, width, height,
                        model="homography")


_align_clip_h_jit = functools.partial(_align_clip_jit, model="homography")
_stabilize_clip_h_jit = functools.partial(_stabilize_clip_jit,
                                          model="homography")
_stabilize_streams_h_jit = functools.partial(_stabilize_streams_jit,
                                             model="homography")


def align_clip_homography(frames, params=None, device=None):
    """(T, H, W[, 3]) u8 -> ((T, 8) homographies, (T,) success)."""
    return align_clip(frames, params, device, model="homography")


def stabilize_clip_homography_core(frames, params: StabilizerParams,
                                   width: int, height: int):
    """Align + smooth + accumulate (no warp) of (S, T, H, W[, 3]) u8."""
    return stabilize_clip_core(frames, params, width, height,
                               model="homography")


def stabilize_streams_homography(frames,
                                 params: StabilizerParams = StabilizerParams(),
                                 device=None):
    """(S, T, H, W[, 3]) u8 -> (S, T - lag, ...) with the 8-DOF model."""
    return stabilize_streams(frames, params, device, model="homography")


def stabilize_clip_homography(frames,
                              params: StabilizerParams = StabilizerParams(),
                              device=None):
    """Full 8-DOF stabilization of a (T, H, W[, 3]) u8 clip."""
    return stabilize_clip(frames, params, device, model="homography")
