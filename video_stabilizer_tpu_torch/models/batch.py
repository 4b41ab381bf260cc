"""Batched stabilization of whole clips and batches of streams.

Port of ``video_stabilizer_tpu.models.batch``. The JAX package scans
``_align_pair_step`` over the frame pairs; with ``phase_correlate=False`` no
value flows from one pair step to the next except the keyframe data (``t0``
is the identity and the pair index only masks), so here every alignment of
a clip or chunk runs as ONE batch: per
level, kernel B is launched once for all streams x frames. Frame ``2k`` (the
non-keyframe) aligns against the previous pair's keyframe and reports the
inverse; frame ``2k+1`` becomes the keyframe and aligns against frame
``2k`` directly (alignment.cpp:690-693). ``pair_vmap=True``, which in the
JAX package runs a pair's two aligns as one 2-lane program
(batch.py:109-122) and gives the sequential result
(tests/test_pair_vmap.py), is therefore what the port does anyway.

Streams ride a leading axis S everywhere. Both motion models share this
machinery (``model="similarity"`` or ``"homography"``); ``model_ops`` gives
the pieces that differ, as ``video_stabilizer_tpu.models.chunked._model_ops``
does. With ``phase_correlate=True`` each alignment starts from the phase
correlation of its frame against the previous frame at the phase level;
the previous frame is known before any alignment runs, so the aligns of a
chunk stay one batch.

A parameter sweep (``align_clip_impl`` with (C,) fields of
``DynAlignParams``, the port of the JAX package's ``jax.lax.map`` over
combos, apps/grid_search_align.py:103-121) puts its C combos on the same
item axis: one kernel B launch per level for C x aligns items, which share
the keyframe windows through ``key_index`` rather than copying them. The
smoother and the accumulator take a per-combo ``lam`` and ``decay`` for the
smoother sweep (apps/grid_search_smoother.py).

On the card the clip entry points replay the JAX package's three clip
programs (batch.py:232, 383, 395), captured once per static configuration
as CUDA graphs (utils/graphs.py): ``_align_clip_jit`` (``align_clip_impl``,
with ``dyn`` a tensor input whose shapes are part of the key) and
``_stabilize_streams_jit``; ``_stabilize_clip_jit`` is the streams program
on a batch of one. The model is one of their static arguments, so the
homography family's three jits (homography_aligner.py:326, 436, 449) are
these programs keyed on ``model="homography"``. Each keeps one key per
card (``max_keys=1``): a call with another clip length, stream count or
combo count drops the last key's graph and memory pool and captures anew.
``stabilize_clip_core`` stays un-captured for the stage tables, as
``chunked.stabilize_chunk_core`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from video_stabilizer_tpu_torch import transforms as T
from video_stabilizer_tpu_torch.config import (
    StabilizerParams, resolve_residual_bound)
from video_stabilizer_tpu_torch.device import resolve_device
from video_stabilizer_tpu_torch.models.aligner import (
    PHASE_LEVEL, DynAlignParams, LevelKeyData, _compute_keyframe,
    align_all_levels, level_specs, phase_shift)
from video_stabilizer_tpu_torch.models.smoother import tvl1_smooth
from video_stabilizer_tpu_torch.models.stabilizer import bgr_to_gray_batched
from video_stabilizer_tpu_torch.ops.fast_warp import (
    warp_homography_fast, warp_image_fast)
from video_stabilizer_tpu_torch.ops.pyr_down import build_pyramid
from video_stabilizer_tpu_torch.ops.warp_kernel import warp_frames
from video_stabilizer_tpu_torch.utils.graphs import Program
from video_stabilizer_tpu_torch.utils.spans import span


def model_ops(model: str) -> dict:
    """The pieces of the pipeline that differ between the motion models:
    parameter count, group algebra, keyframe precompute and level loop, and
    where a translation sits: TX, TY in pixels for the similarity; p2, p5
    normalized by the frame width for the homography."""
    if model == "similarity":
        return dict(nparams=4, compose=T.compose, inverse=T.inverse,
                    mcd=T.max_corner_displacement,
                    compute_keyframe=_compute_keyframe,
                    align_all_levels=align_all_levels,
                    translation=(2, 3), normalized=False)
    if model == "homography":
        from video_stabilizer_tpu_torch import homography as Hm
        from video_stabilizer_tpu_torch.models import homography_aligner as ha
        return dict(nparams=8, compose=Hm.compose, inverse=Hm.inverse,
                    mcd=Hm.max_corner_displacement,
                    compute_keyframe=ha._compute_keyframe_h,
                    align_all_levels=ha.align_all_levels_h,
                    translation=(2, 5), normalized=True)
    raise ValueError(f"unknown motion model {model!r}")


class PairCarry(NamedTuple):
    """Aligner carry of S streams: the last keyframe's pyramid and its
    precompute (K = S on every LevelKeyData field)."""
    key_pyr: tuple   # per level (S, h, w) u8
    key: tuple       # per level LevelKeyData


def init_pair_carry(specs, streams: int, device,
                    model: str = "similarity") -> PairCarry:
    """The zero pre-stream aligner carry (no keyframe seen yet)."""
    zero_pyr = tuple(torch.zeros((streams, s.height, s.width),
                                 dtype=torch.uint8, device=device)
                     for s in specs)
    return PairCarry(key_pyr=zero_pyr,
                     key=model_ops(model)["compute_keyframe"](zero_pyr, specs))


def _phase_inits(levels, carry: PairCarry, specs, params, ops):
    """(S, T, P) initial transform of every frame: the phase correlation of
    frame i against frame i - 1 (the carried keyframe for i = 0) at the
    phase level, as ``_align_pair_step`` and ``_pair_step_h`` form it
    (batch.py:146-153, aligner.py:455-474, homography_aligner.py:245-258):
    ``aligner.phase_shift`` with flip -1 on keyframes (odd i), divided by
    the frame width for the normalized homography; the identity where the
    response is at or below the threshold."""
    lvl = min(PHASE_LEVEL, len(specs) - 1)
    cur = levels[lvl]                                        # (S, T, h, w)
    prev = torch.cat([carry.key_pyr[lvl][:, None], cur[:, :-1]], dim=1)
    flip = torch.ones((cur.shape[1], 1), device=cur.device)
    flip[1::2] = -1.0
    shift, ok = phase_shift(prev, cur, len(specs), params, flip)
    norm = float(specs[0].width) if ops["normalized"] else 1.0
    t = torch.zeros(shift.shape[:-1] + (ops["nparams"],), device=cur.device)
    for k, slot in enumerate(ops["translation"]):
        t[..., slot] = shift[..., k] / norm
    return torch.where(ok[..., None], t, torch.zeros_like(t))


def _combos(dyn) -> int:
    """The number of combos C of a ``DynAlignParams`` whose fields are 0-d
    or (C,); 0 when every field is 0-d (or ``dyn`` is None)."""
    if dyn is None:
        return 0
    sizes = {v.shape[0] for v in dyn if v.dim() == 1}
    if len(sizes) > 1 or any(v.dim() > 1 for v in dyn):
        raise ValueError("DynAlignParams fields must be 0-d or all of one "
                         f"length (C,), got {[tuple(v.shape) for v in dyn]}")
    return sizes.pop() if sizes else 0


def align_pairs(gray, specs, params, carry: PairCarry, pairs_seen,
                model: str = "similarity", dyn=None):
    """Align every frame of an even-length (S, T, H, W) u8 gray batch.

    ``pairs_seen`` (S,) is the global index of each stream's first pair
    (0 only at stream start: it masks the first frame's alignment).
    ``dyn``: ``aligner.DynAlignParams`` with 0-d fields, or (C,) fields for
    C combos, which then ride the item axis (combo-major) and give meas and
    success a leading C axis.
    Returns (new carry, meas ([C,] S, T, P), success ([C,] S, T)), P = 4
    or 8.
    """
    ops = model_ops(model)
    npar = ops["nparams"]
    s_n, t_n, h, w = gray.shape
    if t_n % 2:
        raise ValueError(f"frame count {t_n} must be even")
    p_n = t_n // 2
    dev = gray.device
    with span("pyramid"):
        levels = build_pyramid(gray.reshape(s_n * t_n, h, w), len(specs))
    levels = [lv.reshape((s_n, t_n) + lv.shape[1:]) for lv in levels]
    templates = [lv[:, 0::2].reshape((s_n * p_n,) + lv.shape[2:])
                 for lv in levels]
    pyr_b = [lv[:, 1::2] for lv in levels]
    with span("keyframe"):
        key_b = ops["compute_keyframe"](
            [lv.reshape((s_n * p_n,) + lv.shape[2:]) for lv in pyr_b], specs)
        # Keyframes: the S carried ones, then the S*P new ones
        # (stream-major).
        key_all = tuple(
            LevelKeyData(*(torch.cat([c, n], dim=0) for c, n in zip(ck, nk)))
            for ck, nk in zip(carry.key, key_b))

    s_idx = torch.arange(s_n, device=dev)[:, None]
    p_idx = torch.arange(p_n, device=dev)[None, :]
    key_new = s_n + s_idx * p_n + p_idx                       # (S, P)
    key_prev = torch.where(p_idx == 0, s_idx, key_new - 1)
    key_index = torch.stack([key_prev, key_new], dim=-1).reshape(-1)
    template_index = (s_idx * p_n + p_idx)[..., None].expand(
        s_n, p_n, 2).reshape(-1)
    if params.phase_correlate:
        with span("phase"):
            t0 = _phase_inits(levels, carry, specs, params, ops)
        t0 = t0.reshape(s_n * t_n, npar)
    else:
        t0 = torch.zeros((s_n * t_n, npar), device=dev)
    combos = _combos(dyn)
    lead = (combos,) if combos else ()
    if combos:
        # Combo-major items; the keyframes and templates are shared.
        key_index = key_index.repeat(combos)
        template_index = template_index.repeat(combos)
        t0 = t0.repeat(combos, 1)
        dyn = DynAlignParams(*(v.repeat_interleave(s_n * t_n) if v.dim()
                               else v for v in dyn))
    t, failed = ops["align_all_levels"](templates, template_index, key_all,
                                        key_index, specs, params, t0, dyn)
    t = t.reshape(lead + (s_n, p_n, 2, npar))
    failed = failed.reshape(lead + (s_n, p_n, 2))
    t_a, t_b = t[..., 0, :], t[..., 1, :]
    failed_a, failed_b = failed[..., 0], failed[..., 1]
    t_a = torch.where(failed_a[..., None], t_a, ops["inverse"](t_a))
    pair_idx = pairs_seen.to(dev)[:, None] + p_idx
    ok_a = (pair_idx > 0) & ~failed_a
    t_a = torch.where((pair_idx > 0)[..., None], t_a, torch.zeros_like(t_a))
    ok_b = ~failed_b
    meas = torch.stack([t_a, t_b], dim=-2).reshape(lead + (s_n, t_n, npar))
    ok = torch.stack([ok_a, ok_b], dim=-1).reshape(lead + (s_n, t_n))

    last = tuple(
        LevelKeyData(*(f.reshape((s_n, p_n) + f.shape[1:])[:, -1].contiguous()
                       for f in kd))
        for kd in key_b)
    new_carry = PairCarry(
        key_pyr=tuple(lv[:, -1].contiguous() for lv in pyr_b), key=last)
    return new_carry, meas, ok


def fold_jitter(accum, meas, smoothed, params: StabilizerParams, width: int,
                height: int, model: str = "similarity", decay=None):
    """One accumulator fold (stabilizer.cpp:48-87): jitter = meas o
    smoothed^-1 folded into ``accum`` with displacement-based decay, which
    multiplies every parameter of either model. ``decay``: None for
    ``params``' (min_disp, max_disp, min_decay, max_decay), or a (..., 4)
    float32 tensor of them that broadcasts against ``accum``'s batch axes
    (one per combo of the smoother sweep)."""
    ops = model_ops(model)
    if params.enable_smoother:
        jitter = ops["compose"](meas, ops["inverse"](smoothed))
    else:
        jitter = meas
    new = ops["compose"](accum, jitter)
    disp = ops["mcd"](new, width, height)[..., None]
    if decay is None:
        lo_d, hi_d, lo_k, hi_k = (params.min_disp, params.max_disp,
                                  params.min_decay, params.max_decay)
    else:
        lo_d, hi_d, lo_k, hi_k = (
            x[..., None] for x in decay.to(disp).unbind(-1))

    def like(x):
        return (x.expand_as(disp) if isinstance(x, torch.Tensor)
                else torch.full_like(disp, x))

    f = torch.clamp((disp - lo_d) / (hi_d - lo_d), 0.0, 1.0)
    factor = torch.where(
        disp > hi_d, like(hi_k),
        torch.where(disp > lo_d, lo_k * (1.0 - f) + hi_k * f, like(lo_k)))
    return new * factor


def smooth_trajectory(meas, params: StabilizerParams, lam=None):
    """Sliding-window TV-L1 smooth of (..., T, P) measurements
    (smoother.cpp:91-113, batch.py:233-269): output k smooths
    [max(0, k - lag), k + memory] and takes element k. ``lam``: None for
    ``params.lambda_``, or a tensor that broadcasts against the batch axes
    (one per combo of the smoother sweep). Returns (..., T - memory, P)."""
    lead, (t_total, npar) = meas.shape[:-2], meas.shape[-2:]
    lag, memory = params.lag, params.smoother_memory
    window = lag + memory + 1
    n_out = t_total - memory
    if n_out <= 0:
        return meas.new_zeros(lead + (0, npar))
    dev = meas.device
    ks = torch.arange(n_out, device=dev)
    starts = torch.clamp(ks - lag, min=0)
    valid = ks + memory - starts + 1
    gather = torch.clamp(starts[:, None] + torch.arange(window, device=dev),
                         max=t_total - 1)
    wins = meas[..., gather, :].transpose(-1, -2)      # (..., n_out, P, win)
    lam = params.lambda_ if lam is None else lam[..., None, None]
    sm = tvl1_smooth(wins, lam, valid_len=valid[:, None])
    middle = (ks - starts)[:, None, None].expand(lead + (n_out, npar, 1))
    return torch.gather(sm, -1, middle)[..., 0]


def accumulate_corrections(meas, success, smoothed, params: StabilizerParams,
                           width: int, height: int,
                           model: str = "similarity", decay=None):
    """The accumulator scan (stabilizer.cpp:32-88, batch.py:284-330) in the
    streaming event order over (..., T, P) measurements and (..., T)
    success: a failure at step i resets the accumulator; from i >= lag,
    measurement i - lag folds with smoothed[i - memory], decaying as
    ``fold_jitter`` does with ``decay``. Returns the (..., T - lag, P)
    correction of each output frame."""
    lead, (t_total, npar) = meas.shape[:-2], meas.shape[-2:]
    lag = params.lag
    offset = lag - params.smoother_memory
    accum = meas.new_zeros(lead + (npar,))
    accums = [meas.new_zeros(lead + (0, npar))]
    for i in range(t_total):
        accum = torch.where(success[..., i, None], accum,
                            torch.zeros_like(accum))
        m = i - lag
        if m >= 0:
            sm = smoothed[..., min(m + offset, smoothed.shape[-2] - 1), :] \
                if params.enable_smoother else None
            accum = fold_jitter(accum, meas[..., m, :], sm, params, width,
                                height, model, decay)
            accums.append(accum[..., None, :])
    return torch.cat(accums, dim=-2)


# Frames per FIR call in ``warp_delayed``: each frame's float32
# intermediates take some 30 MB at 1080p (the JAX package maps frame by
# frame for the same reason, batch.py:86-97).
FIR_GROUP = 8


def _warp_frames(frames, ts, params: StabilizerParams, width: int,
                 height: int, model: str):
    """(B, H, W, C) u8 frames warped by their (B, P) sampling transforms
    and cropped by ``params.crop_pixels``: kernel A with the crop fused
    ("auto", "pallas"), or the global-base FIR warp (ops/fast_warp.py),
    FIR_GROUP frames at a time, cropped after it ("fir", as the JAX package
    crops, batch.py:98-100)."""
    c = params.crop_pixels
    if params.output_warp != "fir":
        return warp_frames(frames.contiguous(), ts.contiguous(), c,
                           interp=params.output_interp, model=model)
    fir = warp_image_fast if model == "similarity" else warp_homography_fast
    rb = resolve_residual_bound(params, width, height)
    out = torch.cat([
        fir(frames[i:i + FIR_GROUP], ts[i:i + FIR_GROUP],
            interp=params.output_interp, residual_bound=rb)
        for i in range(0, frames.shape[0], FIR_GROUP)])
    return out[:, c:out.shape[1] - c, c:out.shape[2] - c]


def output_warp(frame, t_sample_ul, params: StabilizerParams):
    """The streaming output warp of ONE (H, W, C) u8 frame by its (4,)
    origin-based sampling similarity (batch.py:52-65), in
    ``params.output_interp``, cropped by ``params.crop_pixels``: one launch
    of kernel A at B = 1 with the crop fused, or the FIR warp. The kernel's
    216x512 tile grid is anchored at the uncropped frame, so the pixels are
    those of warping the whole frame and slicing [c:-c, c:-c]
    (stabilizer.py:193-195)."""
    ts = t_sample_ul.to(torch.float32).reshape(1, 4)
    return _warp_frames(frame[None], ts, params, frame.shape[1],
                        frame.shape[0], "similarity")[0]


def warp_delayed(delayed, accums, params: StabilizerParams, width: int,
                 height: int, model: str = "similarity"):
    """Warp + crop a batch of delayed frames by their accumulated
    corrections, in ``params.output_interp``: in ONE launch of kernel A, or
    through the FIR warp (``params.output_warp == "fir"``).
    ``delayed``: (..., H, W[, C]) u8, ``accums``: (..., P). A similarity
    correction samples through its origin-based form; a homography
    correction is the sampling homography itself
    (homography_aligner.py:392-394)."""
    accums = accums.to(torch.float32)
    if model == "similarity":
        t_s = T.center_to_ul(accums, width, height, minus_one=True)
    else:
        t_s = accums
    squeeze = delayed.shape[-1] != 3 and delayed.dim() == accums.dim() + 1
    if squeeze:
        delayed = delayed[..., None]
    batch_shape = delayed.shape[:-3]
    out = _warp_frames(delayed.reshape((-1,) + delayed.shape[-3:]),
                       t_s.reshape(-1, t_s.shape[-1]), params, width, height,
                       model)
    out = out.reshape(batch_shape + out.shape[1:])
    return out[..., 0] if squeeze else out


def stabilize_clip_core(frames, params: StabilizerParams, width: int,
                        height: int, model: str = "similarity"):
    """Align, smooth and accumulate an (S, T, H, W[, 3]) u8 batch: returns
    (delayed (S, T - lag, ...), accums (S, T - lag, P), meas (S, T, P),
    success (S, T))."""
    t_in = frames.shape[1]
    if t_in <= params.lag:
        raise ValueError(
            f"clip length {t_in} must exceed lag={params.lag} to produce "
            "any output (the stabilizer delays by `lag` frames)")
    gray = bgr_to_gray_batched(frames)
    if t_in % 2:
        gray = torch.cat([gray, gray[:, -1:]], dim=1)
    specs = level_specs(width, height, params.aligner)
    carry = init_pair_carry(specs, frames.shape[0], frames.device, model)
    pairs_seen = torch.zeros(frames.shape[0], dtype=torch.int32,
                             device=frames.device)
    _, meas, ok = align_pairs(gray, specs, params.aligner, carry, pairs_seen,
                              model)
    meas, ok = meas[:, :t_in], ok[:, :t_in]
    smoothed = smooth_trajectory(meas, params) if params.enable_smoother \
        else meas
    accums = accumulate_corrections(meas, ok, smoothed, params, width, height,
                                    model)
    return frames[:, :t_in - params.lag], accums, meas, ok


def align_clip_impl(frames, params, width: int, height: int, dyn=None,
                    model: str = "similarity"):
    """Align a whole (T, H, W) gray or (T, H, W, 3) BGR u8 clip tensor on
    its device (batch.py:214-230): (meas (T, P), success (T,)), per-frame
    motion from the previous frame, the first frame reported unsuccessful
    like the streaming path. With (C,) fields of ``dyn``
    (``aligner.DynAlignParams``) all C combos align in one level loop and
    the results are (C, T, P) and (C, T), as the JAX package's
    ``jax.lax.map`` over combos gives them."""
    gray = bgr_to_gray_batched(frames)[None]
    t_in = gray.shape[1]
    if t_in % 2:
        gray = torch.cat([gray, gray[:, -1:]], dim=1)
    specs = level_specs(width, height, params)
    carry = init_pair_carry(specs, 1, gray.device, model)
    pairs_seen = torch.zeros(1, dtype=torch.int32, device=gray.device)
    _, meas, ok = align_pairs(gray, specs, params, carry, pairs_seen, model,
                              dyn)
    return meas[..., 0, :t_in, :], ok[..., 0, :t_in]


def _stabilize_streams_body(frames, params: StabilizerParams, width: int,
                            height: int, model: str = "similarity"):
    """``stabilize_clip_core`` and the one warp of the whole (S, T - lag)
    batch (batch.py:395-402)."""
    delayed, accums, meas, ok = stabilize_clip_core(frames, params, width,
                                                    height, model)
    out = warp_delayed(delayed, accums, params, width, height, model)
    return out, meas, ok


# The JAX package's clip programs, one key per card; the chunk programs
# (models/chunked.py) take the same static arguments.
STATICS = ("params", "width", "height", "model")
_align_clip_jit = Program(align_clip_impl, static_argnames=STATICS,
                          name="_align_clip_jit", max_keys=1)
_stabilize_streams_jit = Program(_stabilize_streams_body,
                                 static_argnames=STATICS,
                                 name="_stabilize_streams_jit", max_keys=1)


def _stabilize_clip_jit(frames, params: StabilizerParams, width: int,
                        height: int, model: str = "similarity"):
    """One (T, H, W[, 3]) clip (batch.py:383): ``_stabilize_streams_jit``
    on a batch of one, its graph shared with one-stream calls."""
    out, meas, ok = _stabilize_streams_jit(frames[None], params, width,
                                           height, model)
    return out[0], meas[0], ok[0]


def align_clip(frames, params=None, device=None, model: str = "similarity"):
    """(T, H, W) or (T, H, W, 3) u8 clip -> (meas (T, P), success (T,)),
    per-frame motion from the previous frame; the first frame is reported
    unsuccessful like the streaming path. On the card a replay of
    ``_align_clip_jit``."""
    from video_stabilizer_tpu_torch.config import AlignerParams
    params = AlignerParams() if params is None else params
    frames = torch.as_tensor(frames).to(resolve_device(device))
    h, w = frames.shape[1], frames.shape[2]
    return _align_clip_jit(frames, params, w, h, model=model)


def stabilize_streams(frames, params: StabilizerParams = StabilizerParams(),
                      device=None, model: str = "similarity"):
    """(S, T, H, W[, 3]) u8 -> (stabilized (S, T - lag, H - 2c, W - 2c[, 3])
    u8, meas (S, T, P), success (S, T)); the warp runs once over the whole
    (S, T - lag) batch. On the card a replay of ``_stabilize_streams_jit``;
    the clip crosses to the card before the call."""
    frames = torch.as_tensor(frames).to(resolve_device(device))
    h, w = frames.shape[2], frames.shape[3]
    return _stabilize_streams_jit(frames, params, w, h, model)


def stabilize_clip(frames, params: StabilizerParams = StabilizerParams(),
                   device=None, model: str = "similarity"):
    """(T, H, W[, 3]) u8 clip -> (stabilized (T - lag, ...), meas, success);
    on the card a replay of ``_stabilize_streams_jit`` on one stream."""
    frames = torch.as_tensor(frames).to(resolve_device(device))
    h, w = frames.shape[1], frames.shape[2]
    return _stabilize_clip_jit(frames, params, w, h, model)
