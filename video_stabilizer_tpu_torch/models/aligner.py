"""The coarse-to-fine inverse-compositional Lucas-Kanade aligner, batched.

Port of ``video_stabilizer_tpu.models.aligner`` (the XLA path): keyframe
precompute (gradients, per-tile argmax, Jacobian rows, u8 sampling windows),
then per level the warp-diff keypoint selection and the Hessian at the
incoming transform, its regularized inverse, and the GN loop in kernel B
(``ops/gn_solve.py``). Every function works on a batch of items: an item is
one alignment of a template pyramid against a keyframe, and it names its
keyframe by index so that several items share one keyframe's windows.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from video_stabilizer_tpu_torch import transforms as T
from video_stabilizer_tpu_torch.config import (
    AlignerParams, pyramid_shapes, tile_size_for)
from video_stabilizer_tpu_torch.ops.argmax import (
    grad_argmax, take_at_tile_argmax, tile_argmax_flat_index)
from video_stabilizer_tpu_torch.ops.gn_solve import gn_solve
from video_stabilizer_tpu_torch.ops.grad import grad_xy
from video_stabilizer_tpu_torch.ops.linalg import regularized_pinv_sym4
from video_stabilizer_tpu_torch.ops.patches import (
    extract_tile_windows_flat, sample_windows_flat, warp_rel_positions_flat,
    window_origins_flat)
from video_stabilizer_tpu_torch.ops.select import histogram_mask
from video_stabilizer_tpu_torch.utils.spans import span

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


class LevelKeyData(NamedTuple):
    """Per-level keyframe precompute, batched on a leading axis K."""
    idx_x: torch.Tensor    # (K, ht, wt) int32 flat within-tile argmax, X set
    idx_y: torch.Tensor
    coords: torch.Tensor   # (K, 2 xy, 2 sets, N) float32 keypoint coords
    jac: torch.Tensor      # (K, 4, 2 sets, N) float32 Jacobian rows
    windows: torch.Tensor  # (K, P, P, N) uint8 sampling windows


def _compute_keyframe(key_imgs, specs) -> Tuple[LevelKeyData, ...]:
    """GradXY -> GradArgMax -> SparseJacobian per level
    (alignment.cpp:237-276). ``key_imgs``: per level (K, h, w) u8."""
    out = []
    for img, s in zip(key_imgs, specs):
        gx, gy = grad_xy(img)
        idx_x, coords_x, idx_y, coords_y = grad_argmax(gx, gy, s.tile)
        gval = take_at_tile_argmax(torch.stack([gx, gy], dim=1),
                                   torch.stack([idx_x, idx_y], dim=1), s.tile)
        k = img.shape[0]
        n = s.ht * s.wt
        cx_l, cy_l = s.width * 0.5, s.height * 0.5
        scale = 1.0 / s.width
        gx_f = 2.0 * gval[:, 0].reshape(k, n)
        gy_f = 2.0 * gval[:, 1].reshape(k, n)
        ux = coords_x[..., 0].reshape(k, n).to(torch.float32) - cx_l
        vx = coords_x[..., 1].reshape(k, n).to(torch.float32) - cy_l
        uy = coords_y[..., 0].reshape(k, n).to(torch.float32) - cx_l
        vy = coords_y[..., 1].reshape(k, n).to(torch.float32) - cy_l
        zero = torch.zeros_like(gx_f)
        jac = torch.stack([
            torch.stack([gx_f * ux * scale, gy_f * vy * scale], dim=1),
            torch.stack([gx_f * (-vx) * scale, gy_f * uy * scale], dim=1),
            torch.stack([gx_f, zero], dim=1),
            torch.stack([zero, gy_f], dim=1),
        ], dim=1)                                             # (K, 4, 2, N)
        coords = torch.stack([
            torch.stack([ux + cx_l, uy + cx_l], dim=1),
            torch.stack([vx + cy_l, vy + cy_l], dim=1),
        ], dim=1)                                             # (K, 2, 2, N)
        windows = extract_tile_windows_flat(img, s.tile, s.margin)
        out.append(LevelKeyData(idx_x, idx_y, coords, jac, windows))
    return tuple(out)


def template_intensities(spec: LevelSpec, key: LevelKeyData, key_index,
                         templates, template_index):
    """(B, 2, N) f32 template intensities at each item's keyframe argmax
    pixels; ``templates`` (M, h, w) u8, picked by ``template_index``."""
    w, h = spec.width, spec.height
    n = spec.ht * spec.wt
    bsz = key_index.shape[0]
    idx = torch.stack([key.idx_x, key.idx_y], dim=1)[key_index]
    pos = tile_argmax_flat_index(idx, w, spec.tile).reshape(bsz, 2 * n)
    flat_tmpl = templates.reshape(templates.shape[0], h * w)
    tmpl = flat_tmpl[template_index[:, None], pos].reshape(bsz, 2, n)
    return tmpl.to(torch.float32)


def _level_prelude(spec: LevelSpec, key: LevelKeyData, key_index, templates,
                   template_index, transform, params: AlignerParams):
    """Everything of one level before the GN loop, at the incoming transform:
    template intensities, warp-diff selection (alignment.cpp:409-431, centre
    convention W*0.5), the Hessian over both selected sets and its
    regularized inverse (aligner.py:326-345). Returns (tmpl (B, 2, N),
    jac_masked (B, 4, 2, N) with the ICA X/Y-set average folded in,
    hinv (B, 4, 4), ox, oy)."""
    w, h = spec.width, spec.height
    p = key.windows.shape[1]
    tmpl = template_intensities(spec, key, key_index, templates,
                                template_index)
    jac = key.jac[key_index]                                  # (B, 4, 2, N)
    ox, oy = window_origins_flat(spec.ht, spec.wt, spec.tile, spec.margin,
                                 device=transform.device)

    t_ul0 = T.center_to_ul(transform, w, h)[:, None, None, :]
    rel_x0, rel_y0 = warp_rel_positions_flat(
        key.coords[key_index, 0], key.coords[key_index, 1], t_ul0, ox, oy, p)
    wd = torch.abs(sample_windows_flat(key.windows, rel_x0, rel_y0,
                                       key_index=key_index) - tmpl)
    mask = histogram_mask(wd, params.smallest_fraction)      # (B, 2, N)

    jm = jac * mask[:, None]
    hess = (jm[:, :, None] * jac[:, None, :]).sum(dim=(3, 4))   # (B, 4, 4)
    hinv = regularized_pinv_sym4(hess)
    jac_masked = jac * (mask * 0.5)[:, None]
    return tmpl, jac_masked.contiguous(), hinv.contiguous(), ox, oy


def _align_level(spec: LevelSpec, key: LevelKeyData, key_index, templates,
                 template_index, transform, params: AlignerParams):
    """One pyramid level for B items: the prelude at the incoming transform,
    then the GN loop in kernel B.

    Args:
      key: keyframe data of K keyframes; ``key_index`` (B,) picks each
        item's.
      templates: (M, h, w) u8 template images; ``template_index`` (B,).
      transform: (B, 4) incoming centre-pivot transforms.
    Returns (t_raw, t_up, level_failed, iters), as aligner.py:443-452.
    """
    w, h = spec.width, spec.height
    with span(f"select {w}x{h}"):
        tmpl, jac_masked, hinv, ox, oy = _level_prelude(
            spec, key, key_index, templates, template_index, transform,
            params)
    with span(f"gn {w}x{h}"):
        t_final, converged, disp01, iters = gn_solve(
            key.windows, key_index, tmpl, jac_masked, hinv,
            key.coords[:, 0].contiguous(), key.coords[:, 1].contiguous(),
            ox, oy, transform.contiguous(), threshold=params.threshold,
            width=w, height=h, max_iters=params.max_iters)

    # Failure 1: max_iters without convergence (alignment.cpp:661-667).
    # Failure 2: level displacement > max_displacement (670-677).
    level_failed = (~converged) | (disp01 > params.max_displacement)
    # TX/TY double moving up a level (alignment.cpp:683-687).
    t_up = torch.cat([t_final[:, :2], t_final[:, 2:] * 2.0], dim=1)
    return t_final, t_up, level_failed, iters


def align_all_levels(templates, template_index, key, key_index, specs,
                     params: AlignerParams, t_init):
    """The coarse-to-fine level loop (alignment.cpp:390-688) for B items.

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
    for lvl in range(len(specs) - 1, -1, -1):
        t_raw, t_up, level_failed, _ = _align_level(
            specs[lvl], key[lvl], key_index, templates[lvl], template_index,
            transform, params)
        t_next = torch.where(level_failed[:, None], t_raw, t_up) \
            if lvl > 0 else t_raw
        transform = torch.where(failed[:, None], transform, t_next)
        failed = failed | level_failed
    return transform, failed
