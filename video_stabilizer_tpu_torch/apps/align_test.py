"""Test suite + demo app mirroring the reference's align_test
(align_test.cpp:43-702): pyramid/gradient/warp image dumps, transform
property tests (deterministic + randomized, seeds 12345/6789/9999), warp
correctness via phase correlation, and a two-image end-to-end alignment.
Port of the JAX package's apps/align_test.py; the image dumps and image
inputs need cv2, as there.

Usage:
    python -m video_stabilizer_tpu_torch.apps.align_test [--input PATH]
        [--template PATH] [--out DIR] [--device cuda|cpu]

Without --input, a synthetic natural-spectrum test image is used.
"""

import argparse
import os
import sys

import numpy as np

PASS = "[PASS]"
FAIL = "[FAIL]"
EPSILON = 1e-5  # align_test.cpp:249


def check(name, ok, failures):
    print(f"{PASS if ok else FAIL} {name}")
    if not ok:
        failures.append(name)


def test_pyr_down(img, out_dir, failures, device):
    """Pyramid build + per-level warp-shift verification via phase
    correlation (align_test.cpp:43-247)."""
    import cv2
    import torch

    from video_stabilizer_tpu_torch import transforms as T
    from video_stabilizer_tpu_torch.config import (
        AlignerParams, pyramid_shapes)
    from video_stabilizer_tpu_torch.ops import (
        build_pyramid, grad_xy, image_warp)
    from video_stabilizer_tpu_torch.ops.phase_corr import phase_correlate

    params = AlignerParams()
    shapes = pyramid_shapes(img.shape[1], img.shape[0], params)
    pyr = build_pyramid(torch.as_tensor(img).to(device), len(shapes))
    check(f"pyramid has {len(shapes)} levels", len(pyr) == len(shapes),
          failures)

    for i, lvl in enumerate(pyr):
        cv2.imwrite(os.path.join(out_dir, f"pyramid_{i}.png"),
                    lvl.cpu().numpy())
    gx, gy = grad_xy(pyr[0][None])
    cv2.imwrite(os.path.join(out_dir, "grad_x.png"),
                np.clip(np.abs(gx[0].cpu().numpy()) * 2, 0, 255)
                .astype(np.uint8))
    cv2.imwrite(os.path.join(out_dir, "grad_y.png"),
                np.clip(np.abs(gy[0].cpu().numpy()) * 2, 0, 255)
                .astype(np.uint8))

    # Warp by a known shift, recover with phase correlation within 0.5 px
    # (align_test.cpp:358-400) — per pyramid level (163-209).
    for i, lvl in enumerate(pyr):
        if lvl.shape[0] < 32 or lvl.shape[1] < 32:
            continue
        shift = (3.0, -2.0)
        t = T.make(0.0, 0.0, *shift, device=device)
        warped = image_warp(lvl, T.inverse(t)).to(torch.float32)
        det, resp = phase_correlate(lvl.to(torch.float32), warped)
        # phase_correlate returns the align-back shift (= -content motion).
        err = np.hypot(float(det[0]) + shift[0], float(det[1]) + shift[1])
        # 0.5px tolerance like the reference; small levels get a little
        # slack (border effects dominate there).
        tol = 0.5 if lvl.shape[1] >= 128 else 0.75
        check(f"level {i} phase-correlate shift recovery ({err:.3f}px)",
              err < tol, failures)


def test_transforms(failures, device):
    """Property tests (align_test.cpp:261-601); the full set runs under
    pytest (tests/test_transforms.py)."""
    import torch

    from video_stabilizer_tpu_torch import transforms as T

    r = np.random.default_rng(12345)
    ts = np.zeros((50, 4), np.float32)
    ts[:, 0] = r.uniform(-0.1, 0.1, 50)
    ts[:, 1] = r.uniform(-0.1, 0.1, 50)
    ts[:, 2:] = r.uniform(-2, 2, (50, 2))
    ts = torch.as_tensor(ts).to(device)
    pts = torch.as_tensor(r.uniform(-100, 100, (16, 2)),
                          dtype=torch.float32).to(device)

    ok = True
    for i in range(50):
        rt = T.warp_points(T.inverse(ts[i]), T.warp_points(ts[i], pts))
        ok &= bool(torch.allclose(rt, pts, atol=1e-3, rtol=1e-5))
    check("randomized inverse round-trip (seed 12345)", ok, failures)

    r = np.random.default_rng(6789)
    a = torch.as_tensor(r.uniform(-0.05, 0.05, (20, 4)),
                        dtype=torch.float32).to(device)
    b = torch.as_tensor(r.uniform(-0.05, 0.05, (20, 4)),
                        dtype=torch.float32).to(device)
    ok = True
    for i in range(20):
        seq = T.warp_points(b[i], T.warp_points(a[i], pts))
        direct = T.warp_points(T.compose(a[i], b[i]), pts)
        ok &= bool(torch.allclose(seq, direct, atol=1e-3, rtol=1e-5))
    check("compose == sequential application (seed 6789)", ok, failures)

    r = np.random.default_rng(9999)
    c = torch.as_tensor(r.uniform(-0.05, 0.05, (50, 4)),
                        dtype=torch.float32).to(device)
    ident = T.compose(c, T.inverse(c))
    check("inverse(compose) ~= identity (seed 9999)",
          bool(torch.allclose(ident, torch.zeros_like(ident), atol=1e-3)),
          failures)


def align_image_pair(template, inp, out_dir, failures, device):
    """Two-call AlignNextFrame E2E (align_test.cpp:625-691)."""
    import cv2
    import torch

    from video_stabilizer_tpu_torch.models import VideoAligner
    from video_stabilizer_tpu_torch.ops import warp_by_similarity_transform

    aligner = VideoAligner(device=device)
    aligner.align_next_frame(template)
    t, ok = aligner.align_next_frame(inp)
    check(f"pair alignment converged (t={t.cpu().numpy().round(4)})",
          bool(ok), failures)
    if ok:
        aligned = warp_by_similarity_transform(
            torch.as_tensor(np.repeat(inp[..., None], 3, -1)).to(device), t)
        cv2.imwrite(os.path.join(out_dir, "aligned.png"),
                    aligned.cpu().numpy())
        print(f"  wrote {out_dir}/aligned.png")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input", help="input image (grayscale or color)")
    ap.add_argument("--template", help="template image for pair alignment")
    ap.add_argument("--out", default="output", help="artifact directory")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    import cv2
    import torch

    from video_stabilizer_tpu_torch import transforms as T
    from video_stabilizer_tpu_torch.device import resolve_device
    from video_stabilizer_tpu_torch.ops import warp_image_bgr
    from video_stabilizer_tpu_torch.utils.io import natural_texture

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    failures = []

    if args.input:
        img = cv2.imread(args.input, cv2.IMREAD_GRAYSCALE)
    else:
        img = natural_texture(360, 480, seed=12345)

    if args.template:
        template = cv2.imread(args.template, cv2.IMREAD_GRAYSCALE)
        inp = img
    else:
        # Synthesize the pair: template = img, input = img moved by a known
        # similarity transform.
        t_true = torch.tensor([0.002, -0.003, 2.5, -1.5], device=device)
        t_ul = T.center_to_ul(t_true, img.shape[1], img.shape[0],
                              minus_one=True)
        inp = warp_image_bgr(torch.as_tensor(img).to(device),
                             T.inverse(t_ul), interp="lanczos2",
                             border="edge").cpu().numpy()
        template = img
        print(f"synthetic pair with true motion {t_true.cpu().numpy()}")

    test_pyr_down(img, args.out, failures, device)
    test_transforms(failures, device)
    align_image_pair(template, inp, args.out, failures, device)

    print(f"\n{len(failures)} failure(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
