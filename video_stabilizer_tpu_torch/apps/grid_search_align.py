"""Aligner hyperparameter sweep mirroring the reference's grid_search_align
(grid_search_align.cpp:135-210): phase_correlate x threshold x
smallest_fraction x max_displacement combos, smoother disabled
(grid_search_align.cpp:167), scored by output/input jitter ratio. Port of
the JAX package's apps/grid_search_align.py.

threshold, smallest_fraction and max_displacement are per-item aligner
parameters (models.aligner.DynAlignParams), so all combos of one
phase-correlate setting align as one batch: one launch of kernel B per
pyramid level for every combo and frame, with each item's own threshold.
On the card ``run_combos`` (align, accumulate and FIR warp of every combo)
is a program, as it is a jit in the JAX app (grid_search_align.py:103):
captured once per (params, crop) and input shapes as a CUDA graph, then
replayed, one key per card (utils/graphs.py); with ``--device-metric`` the
dense-LK metric is its own program (utils/flow.py).

Usage:
    python -m video_stabilizer_tpu_torch.apps.grid_search_align
        [--video PATH | --synthetic] [--frames N] [--size HxW]
        [--with-phase] [--device-metric] [--device cuda|cpu]
"""

import argparse
import dataclasses
import itertools
import time

import numpy as np

from video_stabilizer_tpu_torch.utils.graphs import Program

# The reference's grid (grid_search_align.cpp:135-146).
THRESHOLDS = (0.01, 0.02, 0.04)
FRACTIONS = (0.7, 0.8, 0.9)
MAX_DISPS = (5.0, 10.0, 20.0)
CROP = 16


def combo_grid():
    """The (threshold, smallest_fraction, max_displacement) combos."""
    return list(itertools.product(THRESHOLDS, FRACTIONS, MAX_DISPS))


def widened_aligner(max_disps=MAX_DISPS):
    """The aligner params of the sweep: the sampling windows support
    per-level displacements up to margin - 2 px (ops/patches.py), so the
    coarse-level margin widens to cover the largest max_displacement swept
    (grid_search_align.py:79-89). Returns (params, the printed line or
    None)."""
    from video_stabilizer_tpu_torch.config import AlignerParams

    need_margin = int(np.ceil(max(max_disps))) + 2
    base = AlignerParams()
    if need_margin > base.window_margin:
        line = (f"widening window_margin {base.window_margin} -> "
                f"{need_margin} to cover max_displacement={max(max_disps)}")
        return AlignerParams(window_margin=need_margin), line
    return base, None


def dyn_params(combos, device):
    """(C,) DynAlignParams of the combos on ``device``."""
    import torch

    from video_stabilizer_tpu_torch.models.aligner import DynAlignParams

    arr = np.asarray(combos, np.float32)
    return DynAlignParams(*(torch.as_tensor(arr[:, i]).to(device)
                            for i in range(3)))


def host_gray(frames):
    """(T, H, W) u8 gray of (T, H, W, 3) BGR frames as the JAX app forms
    it on the host (float64 round of 0.114 B + 0.587 G + 0.299 R)."""
    if frames.ndim != 4:
        return frames
    return np.asarray(np.round(0.114 * frames[..., 0] + 0.587 * frames[..., 1]
                               + 0.299 * frames[..., 2]), np.uint8)


def warp_combos(frames, meas, ok, params, crop=CROP):
    """Accumulate each combo's corrections from its (C, T, 4) measurements
    with the smoother off and FIR-warp the (T, H, W, 3) u8 clip tensor's
    delayed frames by them (as the JAX app warps them,
    grid_search_align.py:103-121), cropped by ``crop``: (C, T - lag,
    H - 2 crop, W - 2 crop, 3) u8."""
    import torch

    from video_stabilizer_tpu_torch import transforms as T
    from video_stabilizer_tpu_torch.models.batch import (
        FIR_GROUP, accumulate_corrections)
    from video_stabilizer_tpu_torch.ops.fast_warp import warp_image_fast

    t_n, height, width = frames.shape[:3]
    accums = accumulate_corrections(meas, ok, meas, params, width, height)
    delayed = frames[: t_n - params.lag]
    t_ul = T.center_to_ul(accums, width, height, minus_one=True)
    outs = []
    for c in range(t_ul.shape[0]):
        out = torch.cat([
            warp_image_fast(delayed[i:i + FIR_GROUP],
                            t_ul[c, i:i + FIR_GROUP].contiguous())
            for i in range(0, delayed.shape[0], FIR_GROUP)])
        outs.append(out[:, crop:-crop, crop:-crop])
    return torch.stack(outs)


def _run_combos(gray, frames, dyn, params, crop=CROP):
    """Align a (T, H, W) u8 gray clip tensor under every combo of ``dyn``
    at once (``batch._align_clip_jit``, inline here), then
    ``warp_combos``. Returns (outs, meas (C, T, 4), ok (C, T))."""
    from video_stabilizer_tpu_torch.models.batch import _align_clip_jit

    height, width = gray.shape[1:3]
    meas, ok = _align_clip_jit(gray, params.aligner, width, height, dyn=dyn)
    return warp_combos(frames, meas, ok, params, crop), meas, ok


run_combos = Program(_run_combos, static_argnames=("params", "crop"),
                     name="run_combos", max_keys=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--video", help="input clip (default: synthetic)")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--size", default="360x640")
    ap.add_argument("--with-phase", action="store_true",
                    help="also sweep phase_correlate=True")
    ap.add_argument("--device-metric", action="store_true",
                    help="score with the on-device dense-LK jitter metric "
                         "(utils/flow.py) instead of host cv2 Farneback")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    import torch

    from video_stabilizer_tpu_torch.config import StabilizerParams
    from video_stabilizer_tpu_torch.device import resolve_device
    from video_stabilizer_tpu_torch.utils.flow import (
        gray_f32, median_jitter_px_device, median_jitter_px_device_impl)
    from video_stabilizer_tpu_torch.utils.io import (
        read_video, synth_shaky_clip)
    from video_stabilizer_tpu_torch.utils.jitter import median_jitter_px

    device = resolve_device(args.device)
    if args.video:
        frames = np.stack(list(read_video(args.video, args.frames)))
    else:
        h, w = (int(v) for v in args.size.split("x"))
        frames = synth_shaky_clip(args.frames, h, w, seed=3, jitter_px=1.0,
                                  pan_px_per_frame=0.3)
    t_n, height, width = frames.shape[:3]

    if args.device_metric:
        in_jitter = median_jitter_px_device(frames, device=device)
    else:
        in_jitter = median_jitter_px(frames)
    print(f"input: {t_n} frames {width}x{height}, jitter {in_jitter:.3f}px")

    combos = combo_grid()
    phase_opts = [False, True] if args.with_phase else [False]
    base_aligner, line = widened_aligner()
    if line:
        print(line)
    dyn = dyn_params(combos, device)
    clip = torch.as_tensor(frames).to(device)
    gray = torch.as_tensor(host_gray(frames)).to(device)

    results = {}
    for phase in phase_opts:
        aligner = dataclasses.replace(base_aligner, phase_correlate=phase)
        params = StabilizerParams(aligner=aligner, enable_smoother=False,
                                  crop_pixels=CROP)
        t0 = time.time()
        outs, meas, ok = run_combos(gray, clip, dyn, params)
        if args.device_metric:
            out_j = median_jitter_px_device_impl(gray_f32(outs)).cpu()
        else:
            host = outs.cpu().numpy()
            out_j = [median_jitter_px(list(o)) for o in host]
        ok = ok.cpu().numpy()
        print(f"phase_correlate={phase}: {len(combos)} combos in "
              f"{time.time()-t0:.1f}s")
        for ci, (thr, frac, md) in enumerate(combos):
            ratio = float(out_j[ci]) / max(in_jitter, 1e-9)
            fail = int(np.sum(~ok[ci])) - 1
            results[(phase, thr, frac, md)] = (ratio, fail)

    best = sorted(results.items(), key=lambda kv: kv[1][0])
    print("\n top 10 combos (out/in jitter ratio, align failures):")
    for (phase, thr, frac, md), (ratio, fail) in best[:10]:
        print(f"  ratio={ratio:.4f} fail={fail:2d}  phase={phase} "
              f"threshold={thr} fraction={frac} max_disp={md}")
    (phase, thr, frac, md), (ratio, fail) = best[0]
    print(f"\nbest: phase_correlate={phase} threshold={thr} "
          f"smallest_fraction={frac} max_displacement={md} "
          f"-> ratio {ratio:.4f}")


if __name__ == "__main__":
    main()
