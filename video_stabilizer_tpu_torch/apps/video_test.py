"""End-to-end stabilization app mirroring the reference's video_test
(video_test.cpp:10-128): stabilize every video in a recordings directory to
output/processed_*.mp4 with crop disabled (video_test.cpp:54). Port of the
JAX package's apps/video_test.py.

Usage:
    python -m video_stabilizer_tpu_torch.apps.video_test [--recordings DIR]
        [--out DIR] [--mode streaming|batch|chunked] [--synthetic N]
        [--device cuda|cpu]

With --synthetic (or when the recordings dir is empty), N synthetic shaky
clips are generated and stabilized. --mode batch uses the whole-clip
pipeline (models/batch.py); --mode chunked feeds the state-carrying serving
mode (models/chunked.py, the unbounded-stream path); streaming mirrors the
reference's frame-at-a-time loop. Writing the mp4 and scoring it need cv2
(or imageio for the writer), as in the JAX package.
"""

import argparse
import glob
import os
import time

import numpy as np


def stabilize_streaming(frames, params, device=None):
    from video_stabilizer_tpu_torch.models import VideoStabilizer

    stab = VideoStabilizer(params, device=device)
    outs = []
    for f in frames:
        out = stab.process_frame(f)
        if out is not None:
            outs.append(out.cpu().numpy())
    return outs, stab.align_failures


def stabilize_chunked(frames, params, chunk_size=16, device=None):
    from video_stabilizer_tpu_torch.models import ChunkedStabilizer

    stab = ChunkedStabilizer(params, device=device)
    outs, failures = [], 0
    n = len(frames) - len(frames) % 2      # aligner consumes keyframe pairs
    for start in range(0, n, chunk_size):
        chunk = np.stack(frames[start:start + chunk_size])
        if chunk.shape[0] % 2:
            chunk = chunk[:-1]
        out, meas, ok = stab.process_chunk(chunk)
        outs.extend(out.cpu().numpy())
        failures += int((~ok).sum())
    return outs, max(failures - 1, 0)      # first frame is warm-up


def stabilize_batch(frames, params, device=None):
    from video_stabilizer_tpu_torch.models.batch import stabilize_clip

    out, meas, ok = stabilize_clip(np.stack(frames), params, device=device)
    failures = int((~ok).sum()) - 1        # first frame is warm-up
    return list(out.cpu().numpy()), max(failures, 0)


def process_video(path_or_clip, name, out_dir, mode, params, device=None):
    from video_stabilizer_tpu_torch.utils import io
    from video_stabilizer_tpu_torch.utils.jitter import median_jitter_px

    if isinstance(path_or_clip, str):
        frames = list(io.read_video(path_or_clip))
    else:
        frames = list(path_or_clip)
    if len(frames) <= params.lag:
        print(f"{name}: too short ({len(frames)} frames <= lag)")
        return

    t0 = time.time()
    fn = {"batch": stabilize_batch, "chunked": stabilize_chunked,
          "streaming": stabilize_streaming}[mode]
    outs, failures = fn(frames, params, device=device)
    dt = time.time() - t0

    out_path = os.path.join(out_dir, f"processed_{name}.mp4")
    with io.VideoWriter(out_path) as w:
        for f in outs:
            w.write(np.asarray(f))

    in_j = median_jitter_px(frames)
    out_j = median_jitter_px(outs)
    print(f"{name}: {len(frames)} frames in {dt:.1f}s "
          f"({len(frames)/dt:.1f} fps), align failures {failures}, "
          f"jitter {in_j:.2f} -> {out_j:.2f} px "
          f"(ratio {out_j/max(in_j,1e-9):.3f}) -> {out_path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--recordings", default="recordings")
    ap.add_argument("--out", default="output")
    ap.add_argument("--mode", choices=["streaming", "batch", "chunked"],
                    default="batch")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="generate N synthetic shaky clips instead")
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--size", default="360x640", help="synthetic HxW")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    from video_stabilizer_tpu_torch.config import StabilizerParams
    from video_stabilizer_tpu_torch.device import resolve_device
    from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    params = StabilizerParams(crop_pixels=0)  # video_test.cpp:54

    videos = sorted(glob.glob(os.path.join(args.recordings, "*.mp4")))
    if args.synthetic or not videos:
        n = args.synthetic or 2
        h, w = (int(v) for v in args.size.split("x"))
        print(f"no recordings found — synthesizing {n} clips")
        for i in range(n):
            clip = synth_shaky_clip(args.frames, h, w, seed=100 + i,
                                    jitter_px=1.0, pan_px_per_frame=0.4)
            process_video(clip, f"synthetic_{i}", args.out, args.mode,
                          params, device)
    else:
        for v in videos:
            name = os.path.splitext(os.path.basename(v))[0]
            process_video(v, name, args.out, args.mode, params, device)


if __name__ == "__main__":
    main()
