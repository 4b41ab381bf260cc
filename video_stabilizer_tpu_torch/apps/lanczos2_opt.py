"""Offline Lanczos2 polynomial fitting study, mirroring the reference's
lanczos2_opt tool (lanczos2_opt.cpp:1-388): fit an even polynomial to
sinc(x)*sinc(x/2) on [-2, 2] by least squares, report accuracy, and
micro-benchmark polynomial-vs-exact evaluation. Port of the JAX package's
apps/lanczos2_opt.py: the fit and its host benchmark are numpy as there,
checked against the port's coefficients (ops/lanczos.py), and the port's
two window functions are timed on ``--device`` as well.

Usage: python -m video_stabilizer_tpu_torch.apps.lanczos2_opt
           [--degree 12] [--samples 4001] [--sweep] [--device cuda|cpu]
"""

import argparse
import time

import numpy as np


def lanczos2_exact(x):
    return np.where(np.abs(x) >= 2.0, 0.0, np.sinc(x) * np.sinc(x / 2.0))


def fit_even_poly(degree, samples):
    """Least-squares fit of sum a_k x^(2k) on [-2, 2]. Returns (coeffs,
    max_err, avg_err) with errors measured on a dense grid."""
    if degree % 2:
        raise ValueError(f"degree must be even, got {degree}")
    xs = np.linspace(0.0, 2.0, samples)  # even function: fit half-range
    y = lanczos2_exact(xs)
    powers = np.stack([xs ** (2 * k) for k in range(degree // 2 + 1)], axis=1)
    coeffs, *_ = np.linalg.lstsq(powers, y, rcond=None)

    dense = np.linspace(-2.0, 2.0, 200001)
    approx = np.zeros_like(dense)
    x2 = dense * dense
    for a in coeffs[::-1]:
        approx = approx * x2 + a
    approx = np.where(np.abs(dense) >= 2.0, 0.0, approx)
    err = np.abs(approx - lanczos2_exact(dense))
    return coeffs, float(err.max()), float(err.mean())


def bench(fn, xs, reps=200, sync=None):
    """Median runtime in us per batch of evaluations
    (lanczos2_opt.cpp:33-68 measured medians of 100-call blocks); ``sync``
    waits for a device before each clock read."""
    times = []
    for _ in range(reps):
        if sync:
            sync()
        t0 = time.perf_counter()
        fn(xs)
        if sync:
            sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--degree", type=int, default=12)
    ap.add_argument("--samples", type=int, default=4001)
    ap.add_argument("--sweep", action="store_true",
                    help="sweep degrees 6..16 and report accuracy")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu, for the port's windows")
    args = ap.parse_args(argv)

    if args.sweep:
        print(f"{'degree':>7} {'max err':>12} {'avg err':>12}")
        for d in range(6, 18, 2):
            _, mx, av = fit_even_poly(d, args.samples)
            print(f"{d:>7} {mx:>12.3e} {av:>12.3e}")
        return

    import torch

    from video_stabilizer_tpu_torch.device import resolve_device
    from video_stabilizer_tpu_torch.ops import lanczos

    device = resolve_device(args.device)
    coeffs, mx, av = fit_even_poly(args.degree, args.samples)
    print(f"degree-{args.degree} even polynomial fit of lanczos2 on [-2, 2]")
    print(f"max abs error: {mx:.3e}  (reference fit: 3.84e-4, "
          "lanczos2_opt.cpp:379)")
    print(f"avg abs error: {av:.3e}  (reference fit: 1.01e-4)")
    print("coefficients (a0 + a1 x^2 + a2 x^4 + ...):")
    for i, a in enumerate(coeffs):
        print(f"  a{i} = {a:+.9g}")

    # Cross-check against the shipped coefficients.
    shipped = np.asarray(lanczos.POLY_COEFFS)
    if args.degree == 12:
        drift = np.max(np.abs(shipped - coeffs[: len(shipped)]))
        print(f"max drift vs shipped ops/lanczos.py coefficients: {drift:.2e}")

    # Micro-benchmark (numpy vectorized analog of lanczos2_opt.cpp timing).
    xs = np.random.default_rng(0).uniform(-2.2, 2.2, 100000)

    def poly(v):
        x2 = v * v
        val = np.full_like(v, coeffs[-1])
        for a in coeffs[-2::-1]:
            val = val * x2 + a
        return np.where(np.abs(v) >= 2.0, 0.0, val)

    t_poly = bench(poly, xs)
    t_exact = bench(lanczos2_exact, xs)
    print(f"poly eval:  {t_poly:9.1f} us / 100k values")
    print(f"exact eval: {t_exact:9.1f} us / 100k values "
          f"({t_exact / max(t_poly, 1e-9):.2f}x slower; the reference "
          "measured 2.74x on scalar CPU code)")

    xt = torch.as_tensor(xs, dtype=torch.float32).to(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else None
    t_poly = bench(lanczos.lanczos2, xt, sync=sync)
    t_exact = bench(lanczos.lanczos2_exact, xt, sync=sync)
    print(f"port on {device}: poly {t_poly:.1f} us, exact {t_exact:.1f} us "
          "/ 100k values")


if __name__ == "__main__":
    main()
