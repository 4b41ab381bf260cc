"""Residual-jitter metric tool mirroring the reference's eval_jitter
(eval_jitter.cpp:21-75): per video, dense Farneback optical flow between
consecutive frames, per-frame median flow magnitude, and the median of those
medians as ``median_jitter_px``. Port of the JAX package's
apps/eval_jitter.py; ``--device`` serves only the opt-in cv2-free fallback
(VIDSTAB_ALLOW_JITTER_FALLBACK=1, utils/jitter.py).

Usage:
    python -m video_stabilizer_tpu_torch.apps.eval_jitter VIDEO [VIDEO...]
    python -m video_stabilizer_tpu_torch.apps.eval_jitter --dir output
"""

import argparse
import glob
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("videos", nargs="*")
    ap.add_argument("--dir",
                    help="evaluate every *.mp4 / *.y4m in a directory")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu, for the cv2-free fallback")
    args = ap.parse_args(argv)

    from video_stabilizer_tpu_torch.utils.io import read_video
    from video_stabilizer_tpu_torch.utils.jitter import median_jitter_px

    videos = list(args.videos)
    if args.dir:
        for pat in ("*.mp4", "*.y4m"):
            videos += sorted(glob.glob(os.path.join(args.dir, pat)))
    if not videos:
        ap.error("no videos given")

    for v in videos:
        j = median_jitter_px(read_video(v, max_frames=args.max_frames),
                             device=args.device)
        print(f"{v}: median_jitter_px = {j:.4f}")


if __name__ == "__main__":
    main()
