"""Smoother + decay hyperparameter sweep mirroring the reference's
grid_search_smoother (grid_search_smoother.cpp:164-187): lag x memory x
lambda x displacement-decay grids with validity filters, scored by
output/input jitter ratio. Port of the JAX package's
apps/grid_search_smoother.py.

The aligner runs once; only the smoother, the accumulator and the FIR warp
re-run per combo. lambda and the decay parameters are per-combo tensors, so
the combos of one (lag, memory) pair smooth and accumulate as one batch;
lag and memory change the window geometry and run one pair at a time. On
the card the one align is ``batch._align_clip_jit`` and each (lag, memory)
pair ``eval_combos``, as the JAX app jits both (grid_search_smoother.py:61,
75): programs of utils/graphs.py. Each pair is a new key of
``eval_combos``, run once and captured once as a CUDA graph (as the JAX
app compiles each pair), and the program keeps only the last key's graph
and memory pool.

Usage:
    python -m video_stabilizer_tpu_torch.apps.grid_search_smoother
        [--video PATH] [--frames N] [--size HxW] [--device cuda|cpu]
"""

import argparse
import itertools
import time

import numpy as np

from video_stabilizer_tpu_torch.utils.graphs import Program

# Grids in the spirit of grid_search_smoother.cpp:164-187 (lag x memory
# with validity filter lag >= memory; lambda; decay windows).
LAGS = (6, 10, 14)
MEMORIES = (3, 5, 8)
LAMBDAS = (1.0, 2.0, 4.0, 8.0)
DECAYS = ((48.0, 64.0, 0.9, 0.7), (32.0, 48.0, 0.95, 0.8),
          (64.0, 96.0, 0.85, 0.6))
CROP = 16


def _eval_combos(frames, meas, ok, params, lams, decays, crop=CROP):
    """Smooth (with one ``lams`` entry per combo), accumulate (with one
    (min_disp, max_disp, min_decay, max_decay) row of ``decays`` per combo)
    and FIR-warp a (T, H, W, 3) u8 clip tensor's delayed frames for C
    combos at once, from its one alignment ``meas`` (T, 4), ``ok`` (T,).
    Returns (C, T - lag, H - 2 crop, W - 2 crop, 3) u8."""
    import torch

    from video_stabilizer_tpu_torch import transforms as T
    from video_stabilizer_tpu_torch.models.batch import (
        FIR_GROUP, accumulate_corrections, smooth_trajectory)
    from video_stabilizer_tpu_torch.ops.fast_warp import warp_image_fast

    t_n, height, width = frames.shape[:3]
    c_n = lams.shape[0]
    meas_c = meas.expand((c_n,) + meas.shape)
    ok_c = ok.expand((c_n,) + ok.shape)
    smoothed = smooth_trajectory(meas_c, params, lam=lams)
    accums = accumulate_corrections(meas_c, ok_c, smoothed, params, width,
                                    height, decay=decays)
    delayed = frames[: t_n - params.lag]
    t_ul = T.center_to_ul(accums, width, height, minus_one=True)
    outs = []
    for c in range(c_n):
        out = torch.cat([
            warp_image_fast(delayed[i:i + FIR_GROUP],
                            t_ul[c, i:i + FIR_GROUP].contiguous())
            for i in range(0, delayed.shape[0], FIR_GROUP)])
        outs.append(out[:, crop:-crop, crop:-crop])
    return torch.stack(outs)


eval_combos = Program(_eval_combos, static_argnames=("params", "crop"),
                      name="eval_combos", max_keys=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--video")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--size", default="360x640")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    import torch

    from video_stabilizer_tpu_torch.config import StabilizerParams
    from video_stabilizer_tpu_torch.device import resolve_device
    from video_stabilizer_tpu_torch.models.batch import _align_clip_jit
    from video_stabilizer_tpu_torch.utils.io import (
        read_video, synth_shaky_clip)
    from video_stabilizer_tpu_torch.utils.jitter import median_jitter_px

    device = resolve_device(args.device)
    if args.video:
        frames = np.stack(list(read_video(args.video, args.frames)))
    else:
        h, w = (int(v) for v in args.size.split("x"))
        frames = synth_shaky_clip(args.frames, h, w, seed=4, jitter_px=1.0,
                                  pan_px_per_frame=0.3)
    t_n, height, width = frames.shape[:3]
    gray = np.asarray(
        np.round(0.114 * frames[..., 0] + 0.587 * frames[..., 1]
                 + 0.299 * frames[..., 2]), np.uint8)
    in_jitter = median_jitter_px(frames)
    print(f"input: {t_n} frames {width}x{height}, jitter {in_jitter:.3f}px")

    # Align once.
    base = StabilizerParams()
    meas, ok = _align_clip_jit(torch.as_tensor(gray).to(device), base.aligner,
                               width, height)
    print(f"aligned once: {int((~ok).sum()) - 1} failures")

    combos = list(itertools.product(LAMBDAS, DECAYS))
    lams = torch.tensor([c[0] for c in combos], device=device)
    decays = torch.tensor([c[1] for c in combos], device=device)
    clip = torch.as_tensor(frames).to(device)
    results = {}
    t0 = time.time()
    for lag, memory in itertools.product(LAGS, MEMORIES):
        if lag < memory:  # validity filter like the reference
            continue
        params = StabilizerParams(lag=lag, smoother_memory=memory)
        outs = eval_combos(clip, meas, ok, params, lams, decays).cpu()
        for (lam, dv), out in zip(combos, outs.numpy()):
            out_j = median_jitter_px(list(out))
            results[(lag, memory, lam, dv)] = out_j / max(in_jitter, 1e-9)
    print(f"swept {len(results)} combos in {time.time()-t0:.1f}s")

    best = sorted(results.items(), key=lambda kv: kv[1])
    print("\n top 10 combos:")
    for (lag, memory, lam, dv), ratio in best[:10]:
        print(f"  ratio={ratio:.4f}  lag={lag} memory={memory} lambda={lam} "
              f"decay={dv}")


if __name__ == "__main__":
    main()
