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

from video_stabilizer_tpu_torch import homography as Hm
from video_stabilizer_tpu_torch.config import AlignerParams, StabilizerParams
from video_stabilizer_tpu_torch.models.aligner import (
    LevelKeyData, LevelSpec, per_item_params, selection_mask,
    template_intensities)
from video_stabilizer_tpu_torch.models.batch import (
    _align_clip_jit, _stabilize_clip_jit, _stabilize_streams_jit, align_clip,
    stabilize_clip, stabilize_clip_core, stabilize_streams, warp_delayed)
from video_stabilizer_tpu_torch.ops.argmax import (
    grad_argmax, take_at_tile_argmax)
from video_stabilizer_tpu_torch.ops.gn8_solve import (
    gn8_solve, warp_rel_positions_h)
from video_stabilizer_tpu_torch.ops.grad import grad_xy
from video_stabilizer_tpu_torch.ops.linalg import regularized_pinv_sym4
from video_stabilizer_tpu_torch.ops.patches import (
    extract_tile_windows_flat, sample_windows_flat, window_origins_flat)
from video_stabilizer_tpu_torch.utils.spans import span

# The homography keyframe carries the similarity one's fields; only ``jac``
# differs in shape: (K, 8, 2 sets, N).
LevelKeyDataH = LevelKeyData


def _compute_keyframe_h(key_imgs, specs):
    """Per level: gradients, per-tile argmax, the (K, 8, 2, N) Jacobian
    rows in normalized coordinates and the u8 windows
    (homography_aligner.py:74-113). ``key_imgs``: per level (K, h, w) u8."""
    out = []
    for img, s in zip(key_imgs, specs):
        gx, gy = grad_xy(img)
        idx_x, coords_x, idx_y, coords_y = grad_argmax(gx, gy, s.tile)
        gval = take_at_tile_argmax(torch.stack([gx, gy], dim=1),
                                   torch.stack([idx_x, idx_y], dim=1), s.tile)
        k = img.shape[0]
        n = s.ht * s.wt
        w_l, h_l = float(s.width), float(s.height)
        fx = torch.stack([coords_x[..., 0].reshape(k, n),
                          coords_y[..., 0].reshape(k, n)], 1).to(torch.float32)
        fy = torch.stack([coords_x[..., 1].reshape(k, n),
                          coords_y[..., 1].reshape(k, n)], 1).to(torch.float32)
        u = (fx - w_l * 0.5) / w_l                               # (K, 2, N)
        v = (fy - h_l * 0.5) / w_l
        # The X set takes grad_x on the u row, the Y set grad_y on the v row.
        ju, jv = Hm.jacobian_rows(u, v)                          # (K, 2, N, 8)
        g = gval.reshape(k, 2, n) * w_l
        sel = torch.stack([ju[:, 0], jv[:, 1]], 1)
        jac = (sel * g[..., None]).permute(0, 3, 1, 2).contiguous()
        coords = torch.stack([fx, fy], 1)                        # (K, 2, 2, N)
        windows = extract_tile_windows_flat(img, s.tile, s.margin)
        out.append(LevelKeyDataH(idx_x, idx_y, coords, jac, windows))
    return tuple(out)


def normalized_keypoints(key: LevelKeyData, spec: LevelSpec):
    """(u, v) (K, 2, N): the keypoints in centered width-normalized
    coordinates, as ``_warp_rel_h`` forms them (homography_aligner.py:
    118-119)."""
    w_l, h_l = float(spec.width), float(spec.height)
    u = (key.coords[:, 0] - w_l * 0.5) / w_l
    v = (key.coords[:, 1] - h_l * 0.5) / w_l
    return u.contiguous(), v.contiguous()


def _level_prelude_h(spec: LevelSpec, key: LevelKeyData, key_index,
                     templates, template_index, p, params: AlignerParams,
                     fraction=None):
    """Template intensities, warp-diff selection at the incoming ``p`` (keep
    ``fraction`` as ``aligner.selection_mask`` takes it), the 8x8 Hessian
    and its regularized inverse (homography_aligner.py:126-149).
    Returns (tmpl (B, 2, N), jac_masked (B, 8, 2, N), hinv (B, 8, 8),
    u, v (K, 2, N), ox, oy)."""
    p_size = key.windows.shape[1]
    tmpl = template_intensities(spec, key, key_index, templates,
                                template_index)
    jac = key.jac[key_index]                                  # (B, 8, 2, N)
    ox, oy = window_origins_flat(spec.ht, spec.wt, spec.tile, spec.margin,
                                 device=p.device)
    u, v = normalized_keypoints(key, spec)
    rel_x0, rel_y0 = warp_rel_positions_h(
        p[:, None, None, :], u[key_index], v[key_index], spec.width,
        spec.height, ox, oy, p_size)
    wd = torch.abs(sample_windows_flat(key.windows, rel_x0, rel_y0,
                                       key_index=key_index) - tmpl)
    mask = selection_mask(wd, params, fraction)               # (B, 2, N)
    jac_masked = jac * mask[:, None]
    hess = (jac_masked[:, :, None] * jac[:, None, :]).sum(dim=(3, 4))
    hinv = regularized_pinv_sym4(hess)
    return (tmpl, jac_masked.contiguous(), hinv.contiguous(), u, v, ox, oy)


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
