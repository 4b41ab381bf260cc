#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Run from the root of the repository. Phases:

  1. Build the port's CUDA kernels from ``video_stabilizer_tpu_torch/csrc``
     (one nvcc per source, all at once) and print what ptxas reports for
     each kernel; all 16 instances of kernel A (2 models x 2 interps x 1-4
     channels) and every block-size instance of kernels B and C must
     report a 0-byte stack frame and no spills.
  2. Check that ``utils.io.synth_shaky_clip`` gives the same small clip on
     the card as on the CPU (the tests hold the CPU's to the JAX package's).
  3. Drive the 1080p similarity path over two chunks to capture real
     kernel inputs: 1080p BGR, 8 streams, 16-frame chunks, state carried
     from chunk to chunk, on content with rotation and zoom jitter as well
     as 1 px shake.
  4. Kernel A (output warp), similarity + bilinear, against its plain
     PyTorch version on the card: at the main path's batch (128 frames,
     crop 32) and at 16 frames with random similarity transforms; 4
     frames of its similarity + Lanczos2 form; and both similarity forms
     on 3 ragged 437x1033 frames (partial tiles both ways, crop 5) at 1, 3
     and 4 channels with bulk shifts near the +-192 clip. Bar: max 1 LSB,
     >= 99.9 % of pixels equal; the share printed is bit-equal pixels.
  5. Kernel B (per-level 4-DOF GN solve) against its plain version on the
     card, at each of the six 1080p level shapes, with the items of that
     chunk. Bar, over every item: converged equal, A/B within 1e-5, TX/TY
     within 1e-3 px; and the items' A/B at least 10x the A/B bar. Two
     launches must give bit-identical outputs. Reported per level: the
     launch plan (cluster size, block size, shared memory), mean and max
     iterations, the wrapper's time between CUDA events (host launch
     overhead included, as earlier runs took it: the ``ms`` of the
     kernels line) beside the kernel's device time (20 launches replayed
     from a CUDA graph: its ``device_ms``), the time per iteration and the
     fixed cost (a line through the device times at max_iters 1, 4 and 16
     with threshold 0), and the device time under every cluster size
     (1-8) and block size the kernel is built for.
  6. Drive the 4K homography path (config 4 of apps/bench_configs.py:
     3840x2160 BGR, 2 streams x 16-frame chunks, phase-correlation init,
     8-DOF model, Lanczos2 output, crop 32) over two chunks to capture
     kernel C's inputs at its 7 levels and kernel A's frames and
     corrections; and align 16 pairs whose template is a 4K frame warped
     by a known homography with perspective (by kernel A's homography
     form), capturing kernel C's inputs there too.
  7. Kernel A, homography + Lanczos2, against its plain version: the 32
     captured 4K frames with their real corrections and 8 frames with
     random homographies (|p0,p1,p3,p4|, |p6,p7| <= 4e-3, translation
     <= 40 px); 4 frames of the homography + bilinear form; and both
     homography forms on the ragged case of phase 4. Bar: max 1 LSB,
     >= 99.9 % of pixels equal.
  8. Kernel C (per-level 8-DOF GN solve) against its plain version at all
     7 level shapes, on the captured and the perspective items. Bar, over
     every item: converged equal, corner error between the two <= 0.02 px
     (the GN threshold) at the level's size; and the perspective items'
     median max(|p6|,|p7|) at least 10x the largest p6/p7 gap. Two
     launches must give bit-identical outputs. Reported per level as in
     phase 5.
  9. The 1080p similarity path, timed, on bench.py's content (translation
     only, 1 px jitter): 4 chunks with carried state from a fresh start,
     with every launch count set to 0 before and read after. Checks the
     output shape, the align success rate (>= 0.9) and the measured motion
     against the clip's known motion. One more chunk runs under
     torch.profiler.
 10. The 4K homography path, timed, the same way: 4 chunks on
     bench_configs' content (seeds 5 and 6), kernel C's and kernel A's
     homography + Lanczos2 counts > 0 and kernel B's 0, success >= 0.9,
     p2*W, p5*W against the known motion; one more chunk under the
     profiler.
 11. Reported, no bar: one chunk of 4 px jitter content through kernel B
     and through its plain version, with convergence and known-motion
     error for each.
 12. The port on the card against the port on the CPU (the plain versions)
     on a small clip: ok equal, >= 99 % of output pixels within 1 LSB.
 S1. The streaming path, timed: ``VideoStabilizer`` (crop 32, defaults
     otherwise: lag 10, smoother memory 5, bilinear) over 48 frames of one
     1080p stream of bench.py's content (seed 100) from a fresh state,
     with every launch count set to 0 before and read after. Checks 38
     outputs of (1016, 1856, 3) u8, align success >= 0.9 of the 47
     alignable frames, TX/TY against the known motion (phase 9's bars),
     and the launches: kernel A once per output, kernel B once per level
     of every frame (the first frame runs the level loop, as in the JAX
     package), kernel C never. Prints the per-frame latency (host clock up
     to each frame's sync; median and p90 of frames 12-47) and the
     per-frame stage table from the spans; then 8 more frames run under
     torch.profiler (device busy share) and 4 more with kernel A's and B's
     inputs captured.
 S2. Streaming vs chunked on the card: S1's first 32 frames against
     ``stabilize_stream_chunked`` (16-frame chunks): ok equal,
     measurements within 1e-5, >= 99.5 % of output pixels within 1 LSB
     (the JAX package's bars, test_batch.py:28-83).
 S3. Kernel B at one item per launch on the captured frames' six levels
     (phase 5's bars; two launches bit-identical; wrapper and device time
     per level) and kernel A at one frame per launch on the 4 captured
     frames (max 1 LSB, >= 99.9 % equal), with ``grid_sample`` on one frame
     as the yardstick.
 S4. The streaming path on the card against the CPU on a small clip
     (96x128, 20 frames): ok equal, >= 99 % of pixels within 1 LSB.

Every phase runs; the script exits 1 if any failed, 2 without a card. On
success it prints the per-stage times, one ``{"kernels": [...]}`` line (six
entries: kernel A's two chunked forms and its one-frame form, B per chunk
and at one item, C), the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
from unittest import mock

import numpy as np
import torch

HEIGHT, WIDTH, STREAMS, CHUNK, CHUNKS = 1080, 1920, 8, 16, 4
SEED = 100
# The 4K homography path: apps/bench_configs.py:34-53, BASELINE.json
# config 4. Its content is bench_configs', one seed per stream.
H4K, W4K, CHUNKS_4K = 2160, 3840, 4
SEEDS_4K = (5, 6)                 # one stream each
HOMOGRAPHY = "homography"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside the tensor cores
WARP_REPLACES = "video_stabilizer_tpu/ops/pallas_warp.py:117"
GN_REPLACES = "video_stabilizer_tpu/ops/pallas_gn.py:133"
GN8_REPLACES = "video_stabilizer_tpu/ops/pallas_gn.py:383"

failures: list[str] = []


def log(msg: str):
    print(msg, flush=True)


def check(cond: bool, what: str):
    log(("  ok    " if cond else "  FAIL  ") + what)
    if not cond:
        failures.append(what)


def phase(name: str):
    """Run a phase, record a failure and carry on to the next."""
    def deco(fn):
        def run(*args, **kw):
            log(f"== {name}")
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            except Exception:
                traceback.print_exc(file=sys.stdout)
                failures.append(f"{name}: raised")
                return None
            finally:
                log(f"   ({time.perf_counter() - t0:.1f} s)")
        return run
    return deco


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up, between CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of one ``fn()`` with the host's launch
    overhead out of the way: ``reps`` calls captured once in a CUDA graph
    (after one warm-up call outside it), one replay timed between CUDA
    events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# Synthetic streams
# --------------------------------------------------------------------------

# bench.py's content for the main path: translation only, 1 px jitter.
MAIN_CONTENT = dict(jitter_px=1.0, pan_px_per_frame=0.3)
# Kernel B's items come from content with rotation and zoom as well, so
# that A and B are far above the bar they are held to.
GN_CONTENT = dict(jitter_px=1.0, pan_px_per_frame=0.3, rot_jitter=0.002,
                  zoom_jitter=0.001)
# The generator's default jitter, where the GN loop's capture range ends.
WIDE_CONTENT = dict(jitter_px=4.0, pan_px_per_frame=0.5)


def synth_streams(dev, num_frames, content, height=None, width=None,
                  seeds=None):
    """(S, T, H, W, 3) u8 host frames and (S, T, 4) window poses from
    ``utils.io.synth_shaky_clip`` (1080p unless given), one seed per stream
    (SEED + s for the 1080p streams unless given), with its crops computed
    on the card."""
    from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

    height, width = height or HEIGHT, width or WIDTH
    seeds = seeds or [SEED + s for s in range(STREAMS)]
    frames = np.empty((len(seeds), num_frames, height, width, 3), np.uint8)
    poses = np.empty((len(seeds), num_frames, 4))
    for s, seed in enumerate(seeds):
        frames[s], poses[s] = synth_shaky_clip(
            num_frames, height, width, seed=seed, device=dev, poses=True,
            **content)
    return frames, poses


def known_motion_error(shift, ok, poses):
    """RMS and max px of the measured (S, T, 2) translation of a
    translation-only clip against its known motion: from frame t-1 to t,
    minus the window offset step."""
    truth = -np.diff(poses[..., 2:], axis=1)
    err = (shift[:, 1:] - truth)[ok[:, 1:]]
    return float(np.sqrt(np.mean(err ** 2))), float(np.abs(err).max())


def reset_launch_counts():
    from video_stabilizer_tpu_torch.ops import warp_kernel
    from video_stabilizer_tpu_torch.ops.gn8_solve import gn8_solve
    from video_stabilizer_tpu_torch.ops.gn_solve import gn_solve
    warp_kernel.reset_launches()
    gn_solve.launches = 0
    gn8_solve.launches = 0


def launch_counts() -> dict:
    """Launches since the last reset, per kernel and form."""
    from video_stabilizer_tpu_torch.ops.gn8_solve import gn8_solve
    from video_stabilizer_tpu_torch.ops.gn_solve import gn_solve
    from video_stabilizer_tpu_torch.ops.warp_kernel import warp_frames
    counts = {f"warp_frames[{m},{i}]": n
              for (m, i), n in warp_frames.form_launches.items()}
    counts.update(gn_solve=gn_solve.launches, gn8_solve=gn8_solve.launches)
    return counts


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

@phase("build")
def build_kernels():
    from video_stabilizer_tpu_torch.ops import cuda_build, gn8_solve, gn_solve
    # Kernel A: 2 models x 2 interps x 1-4 channels; B and C: one instance
    # per block size.
    instances = dict(warp=16, gn_solve=len(gn_solve.THREADS),
                     gn8_solve=len(gn8_solve.THREADS))
    reports = cuda_build.build()
    for name, text in reports.items():
        for line in text.splitlines():
            if any(k in line for k in ("Function properties", "registers",
                                       "spill", "error")):
                log(f"  {name}: {line.strip()}")
        # Every kernel instance's arrays must live in registers.
        want = instances.get(name)
        if want is not None:
            stacks = [ln.strip() for ln in text.splitlines()
                      if "bytes stack frame" in ln]
            clean = [ln for ln in stacks if ln == "0 bytes stack frame, 0 "
                     "bytes spill stores, 0 bytes spill loads"]
            check(len(stacks) == want and len(clean) == want,
                  f"{name}.cu: {len(clean)} of {len(stacks)} kernel "
                  f"instances (of {want}) with a 0-byte stack frame and no "
                  "spills")
    for name in cuda_build.SOURCES:
        check(cuda_build.library_path(name).exists(), f"built {name}.cu")
    return True


@phase("synthetic clips: generated on the card as on the CPU")
def synth_on_card(dev):
    from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

    for content in (MAIN_CONTENT, GN_CONTENT):
        clips = [synth_shaky_clip(6, 96, 128, seed=SEED, device=d,
                                  poses=True, **content)
                 for d in (dev, "cpu")]
        check(all(np.array_equal(a, b) for a, b in zip(*clips)),
              f"{content}: frames and poses equal")


@phase("capture a real chunk's kernel inputs (content with rotation and "
       "zoom)")
def capture(params, dev):
    from video_stabilizer_tpu_torch import transforms as T
    from video_stabilizer_tpu_torch.models import aligner, chunked
    from video_stabilizer_tpu_torch.ops.gn_solve import gn_solve

    frames, _ = synth_streams(dev, 2 * CHUNK, GN_CONTENT)
    states = chunked.init_stream_state(WIDTH, HEIGHT, params, 3, STREAMS, dev)
    states = chunked.stabilize_chunk_streams(states, frames[:, :CHUNK],
                                             params)[0]
    chunk1 = torch.as_tensor(frames[:, CHUNK:2 * CHUNK]).to(dev)
    with mock.patch.object(aligner, "gn_solve", wraps=gn_solve) as spy:
        _, delayed, accums, *_ = chunked.stabilize_chunk_core(
            states, chunk1, params, WIDTH, HEIGHT)
    t_ul = T.center_to_ul(accums, WIDTH, HEIGHT, minus_one=True)
    torch.cuda.synchronize()
    return dict(warp_frames=delayed.reshape(-1, HEIGHT, WIDTH, 3),
                warp_ts=t_ul.reshape(-1, 4).contiguous(),
                gn_calls=[(c.args, c.kwargs) for c in spy.call_args_list],
                levels=len(aligner.level_specs(WIDTH, HEIGHT,
                                               params.aligner)))


def warp_compare(frames, ts, crop, interp="bilinear", model="similarity",
                 group=16):
    """(max |diff| LSB, share of pixels equal) between kernel A and its
    plain version on the card, the plain version ``group`` frames at a
    time."""
    from video_stabilizer_tpu_torch.ops.warp_kernel import (
        warp_frames, warp_frames_plain)
    form = dict(interp=interp, model=model)
    got = warp_frames(frames, ts, crop, **form)
    max_err, n_equal = 0, 0
    for i in range(0, frames.shape[0], group):
        want = warp_frames_plain(frames[i:i + group], ts[i:i + group], crop,
                                 **form)
        diff = (got[i:i + group].to(torch.int16) - want.to(torch.int16)).abs()
        max_err = max(max_err, int(diff.max()))
        n_equal += int((diff == 0).sum())
    return max_err, n_equal / got.numel()


RAGGED = (3, 437, 1033)   # frames, rows, columns: partial tiles both ways
RAGGED_CROP = 5


def warp_ragged(dev, model):
    """Kernel A's two forms of ``model`` against the plain version on 3
    frames of 437x1033 (partial 216x512 tiles in both axes, crop 5) at 1, 3
    and 4 channels, with bulk shifts near the +-192 clip of the tile base
    and |A|,|B| (p0, p1, p3, p4) up to 0.008, p6, p7 up to 4e-3. Bar: max
    1 LSB, >= 99.9 % equal. Returns the largest |diff|."""
    n, h, w = RAGGED
    g = torch.Generator().manual_seed(SEED + 3)
    lin = (torch.rand((n, 4), generator=g) * 2 - 1) * 0.008
    sign = torch.where(torch.rand((n, 2), generator=g) < 0.5, -1.0, 1.0)
    shift = sign * (185 + torch.rand((n, 2), generator=g) * 10)
    if model == "similarity":
        ts = torch.cat([lin[:, :2], shift], 1)
    else:
        persp = (torch.rand((n, 2), generator=g) * 2 - 1) * 4e-3
        ts = torch.stack([lin[:, 0], lin[:, 1], shift[:, 0] / w, lin[:, 2],
                          lin[:, 3], shift[:, 1] / w, persp[:, 0],
                          persp[:, 1]], 1)
    ts = ts.to(dev)
    worst = 0
    for c in (1, 3, 4):
        frames = torch.randint(0, 256, (n, h, w, c), generator=g,
                               dtype=torch.uint8).to(dev)
        for interp in ("bilinear", "lanczos2"):
            max_err, equal = warp_compare(frames, ts, RAGGED_CROP,
                                          interp=interp, model=model)
            check(max_err <= 1 and equal >= 0.999,
                  f"ragged {n}x{h}x{w}x{c}, {model} + {interp}, crop "
                  f"{RAGGED_CROP}, shifts near +-192: max |diff| {max_err} "
                  f"LSB, {equal * 100:.4f} % equal")
            worst = max(worst, max_err)
    return worst


def warp_bound(frames, ts, crop, interp, model):
    """(bound ms, what bounds it, GB, GFLOP) of one warp launch: each frame
    read once, each output written once, against OPS_PER_PIXEL."""
    from video_stabilizer_tpu_torch.ops.warp_kernel import OPS_PER_PIXEL
    bsz, h, w, c = frames.shape
    n_out = bsz * (h - 2 * crop) * (w - 2 * crop)
    bytes_moved = frames.numel() + n_out * c + ts.numel() * 4
    ops = n_out * OPS_PER_PIXEL(c, interp, model)
    bound_ms, bound_by = roofline(bytes_moved, ops)
    return bound_ms, bound_by, bytes_moved / 1e9, ops / 1e9


def grid_sample_ms(frames, ts, crop, reps):
    """Yardstick of kernel A's similarity + bilinear form: one library call
    computing the same bilinear, zero-border warp on the same (B, H, W, C)
    frames, float NCHW in and out, timed between CUDA events."""
    _, height, width, _ = frames.shape
    dev = frames.device
    ho, wo = height - 2 * crop, width - 2 * crop
    src = frames.permute(0, 3, 1, 2).float()
    ys, xs = torch.meshgrid(
        torch.arange(crop, crop + ho, device=dev, dtype=torch.float32),
        torch.arange(crop, crop + wo, device=dev, dtype=torch.float32),
        indexing="ij")
    a, b, tx, ty = (ts[:, k, None, None] for k in range(4))
    sx = (1.0 + a) * xs - b * ys + tx
    sy = b * xs + (1.0 + a) * ys + ty
    grid = torch.stack([sx / (width - 1) * 2 - 1, sy / (height - 1) * 2 - 1],
                       dim=-1)
    return cuda_ms(lambda: torch.nn.functional.grid_sample(
        src, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True), reps)


@phase("kernel A: output warp vs its plain version (1080p, similarity)")
def check_warp(cap, crop, dev):
    from video_stabilizer_tpu_torch.ops.warp_kernel import (
        warp_frames, warp_frames_plain)

    frames, ts = cap["warp_frames"], cap["warp_ts"]
    bsz = frames.shape[0]
    max_err, equal = warp_compare(frames, ts, crop)
    check(max_err <= 1 and equal >= 0.999,
          f"main-path inputs ({bsz} frames, crop {crop}): max |diff| "
          f"{max_err} LSB, {equal * 100:.4f} % equal")
    g = torch.Generator().manual_seed(SEED)
    rnd = torch.cat([(torch.rand((16, 2), generator=g) * 2 - 1) * 0.008,
                     (torch.rand((16, 2), generator=g) * 2 - 1) * 40], 1)
    rnd = rnd.to(dev)
    max_rnd, equal_rnd = warp_compare(frames[:16].contiguous(), rnd, 0)
    check(max_rnd <= 1 and equal_rnd >= 0.999,
          f"random similarity (16 frames, |A|,|B| <= 0.008, |t| <= 40 px): "
          f"max |diff| {max_rnd} LSB, {equal_rnd * 100:.4f} % equal")
    max_l, equal_l = warp_compare(frames[:4].contiguous(), rnd[:4], crop,
                                  interp="lanczos2")
    check(max_l <= 1 and equal_l >= 0.999,
          f"similarity + Lanczos2 (4 frames, random similarity): max |diff| "
          f"{max_l} LSB, {equal_l * 100:.4f} % equal")
    max_ragged = warp_ragged(dev, "similarity")

    ms = cuda_ms(lambda: warp_frames(frames, ts, crop), 10)

    def plain():
        for i in range(0, bsz, 16):
            warp_frames_plain(frames[i:i + 16], ts[i:i + 16], crop)
    plain_ms = cuda_ms(plain, 2)

    library_ms = grid_sample_ms(frames, ts, crop, 5)
    bound_ms, bound_by, gb, gflop = warp_bound(frames, ts, crop, "bilinear",
                                               "similarity")
    log(f"  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, grid_sample "
        f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}: "
        f"{gb:.3f} GB, {gflop:.2f} GFLOP); kernel / grid_sample "
        f"{ms / library_ms:.2f}, kernel / bound {ms / bound_ms:.1f}")
    return dict(name="warp_frames[similarity,bilinear]", route="cuda",
                source="video_stabilizer_tpu_torch/csrc/warp.cu",
                replaces=WARP_REPLACES,
                max_abs_err=max(max_err, max_rnd, max_ragged), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def roofline(bytes_moved, ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Kernel B against its plain version, on every item: converged equal, and
# the transforms within these bars. Both loops run the same f32 arithmetic
# and differ only in the order of the sum over keypoints; on the first runs
# (H100, PR 1) the gap was at most 7.7e-7 in A/B and 1.0e-4 px in TX/TY.
GN_AB_BAR, GN_T_BAR = 1e-5, 1e-3


def gn_bytes(args, t_out, iters):
    """Bytes kernel B or C must move for this run's data: the 4x4 window
    taps of both keypoint sets of every item at each of its iterations (at
    most a keyframe's whole windows), each other input of the items and of
    the keyframes in use read once, each output written once. Both kernels
    take (windows, key_index, tmpl, jac_masked, hinv, two (K, 2, N)
    keypoint coordinates, ox, oy, initial transform)."""
    windows, key_index, *per_item = args[:5]
    fx, fy, ox, oy, t_init = args[5:10]
    k, p, _, n = windows.shape
    iters_per_key = torch.zeros(k, dtype=torch.float64,
                                device=iters.device).index_add_(
        0, key_index.long(), iters.double())
    taps = float(torch.clamp(iters_per_key * 2 * n * 16, max=p * p * n).sum())
    keys = int(torch.unique(key_index).numel())
    item_bytes = sum(a.numel() * a.element_size()
                     for a in (key_index, *per_item, t_init))
    key_bytes = keys * (fx[0].numel() + fy[0].numel()) * 4
    out_bytes = t_out.shape[0] * (t_out.shape[1] + 3) * 4
    return taps + item_bytes + key_bytes + (ox.numel() + oy.numel()) * 4 \
        + out_bytes


def deterministic(fn) -> bool:
    """Whether two launches on the same inputs give bit-identical
    outputs."""
    first, second = fn(), fn()
    return all(torch.equal(a, b) for a, b in zip(first, second))


# max_iters of the fit of a GN kernel's time against its iterations.
FIT_ITERS = (1, 4, 16)


def iteration_fit(solve, args, kw):
    """(ms per iteration, fixed ms) of a GN kernel on these items: the
    least-squares line through its device times (``graph_ms``) at
    max_iters = 1, 4 and 16 with threshold 0, where no item converges and
    each runs max_iters iterations."""
    times = [graph_ms(lambda m=m: solve(*args, **dict(
        kw, threshold=0.0, max_iters=m)), 10) for m in FIT_ITERS]
    slope, fixed = np.polyfit(FIT_ITERS, times, 1)
    return float(slope), float(fixed)


def plan_sweep(module, solve_with_plan, args, kw) -> str:
    """The kernel's device time (``graph_ms``) at this level under every
    cluster size and block size it is built for: the measurement behind
    ``launch_plan``. Every plan must launch: a refused one raises."""
    from video_stabilizer_tpu_torch.ops.gn_solve import (
        CLUSTER_SIZES, make_plan)
    items, n = args[-1].shape[0], args[0].shape[3]
    out = []
    for cs in CLUSTER_SIZES:
        for threads in module.THREADS:
            plan = make_plan(items, n, cs, threads, module.CACHE_FLOATS)
            ms = graph_ms(lambda: solve_with_plan(plan, *args, **kw), 5)
            out.append(f"{cs}x{threads} {ms:.3f}")
    return ", ".join(out)


def describe_plan(plan) -> str:
    return (f"{plan.cluster} CTA{'s' if plan.cluster > 1 else ''} x "
            f"{plan.threads} threads per item, grid {plan.grid}, "
            f"{plan.cached} of {plan.slice} keypoints per CTA cached in "
            f"{plan.smem} B of shared memory")


def level_table(rows):
    """Print the per-level table of a GN kernel."""
    log("  level      P  N      items mean-it max-it ms/iter fixed ms "
        "kernel ms device ms bound ms plain ms plan (CTAs x threads, smem "
        "B)")
    for r in rows:
        log(f"  {r['level']:<10} {r['p']:<2} {r['n']:<6} {r['items']:<5} "
            f"{r['mean_it']:<7.2f} {r['max_it']:<6d} {r['per_it']:<7.4f} "
            f"{r['fixed']:<8.4f} {r['ms']:<9.4f} {r['device']:<9.4f} "
            f"{r['bound']:<8.4f} {r['plain']:<8.3f} {r['plan'].cluster} x "
            f"{r['plan'].threads}, {r['plan'].smem}")


@phase("kernel B: per-level GN solve vs its plain version")
def check_gn(cap):
    from video_stabilizer_tpu_torch.ops import gn_solve as module
    from video_stabilizer_tpu_torch.ops.gn_solve import (
        OPS_PER_SAMPLE, gn_solve, gn_solve_plain, gn_solve_with_plan,
        launch_plan)

    calls = cap["gn_calls"]
    check(len(calls) == cap["levels"],
          f"{len(calls)} GN launches per chunk ({cap['levels']} levels)")
    totals = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0)
    bound_share = dict(bytes=0.0, operations=0.0)
    worst = 0.0
    rows = []
    for args, kw in calls:
        p, n = args[0].shape[1], args[0].shape[3]
        t_g, c_g, d_g, i_g = gn_solve(*args, **kw)
        t_w, c_w, d_w, i_w = gn_solve_plain(*args, **kw)
        level = f"{kw['width']}x{kw['height']} (P={p}, N={n}, " \
                f"{t_g.shape[0]} items)"
        d_ab = float((t_g[:, :2] - t_w[:, :2]).abs().max())
        d_t = float((t_g[:, 2:] - t_w[:, 2:]).abs().max())
        d_it = int((i_g - i_w).abs().max())
        same_conv = bool((c_g == c_w).all())
        worst = max(worst, d_ab, d_t)
        for i in torch.nonzero(c_g != c_w).flatten().tolist():
            log(f"    item {i}: converged {bool(c_g[i])} (kernel) vs "
                f"{bool(c_w[i])} (plain), iters {int(i_g[i])} vs "
                f"{int(i_w[i])}, disp01 {float(d_g[i]):.4f} vs "
                f"{float(d_w[i]):.4f} px")
        check(same_conv and d_ab <= GN_AB_BAR and d_t <= GN_T_BAR,
              f"{level}: converged equal on all items {same_conv}; over all "
              f"items |dA,dB| {d_ab:.2e} (bar {GN_AB_BAR:.0e}), |dTX,dTY| "
              f"{d_t:.2e} px (bar {GN_T_BAR:.0e}), |d iters| {d_it}; mean "
              f"iters {float(i_g.float().mean()):.2f}, converged "
              f"{float(c_g.float().mean()) * 100:.1f} %")
        # The bar must be small against what it compares.
        ab = t_w[:, :2].abs().amax(dim=1)
        check(float(ab.median()) >= 10 * GN_AB_BAR,
              f"{level}: the items' max(|A|,|B|) has median "
              f"{float(ab.median()):.2e} and max {float(ab.max()):.2e}, "
              f">= 10x the A/B bar")
        plan = launch_plan(t_g.shape[0], n)
        log(f"    plan: {describe_plan(plan)}")
        check(deterministic(lambda: gn_solve(*args, **kw)),
              f"{level}: two launches give bit-identical outputs")
        # The wrapper's time between CUDA events, host launch overhead
        # included, as earlier runs took it; and the kernel's device time.
        ms = cuda_ms(lambda: gn_solve(*args, **kw), 20)
        device_ms = graph_ms(lambda: gn_solve(*args, **kw), 20)
        plain_ms = cuda_ms(lambda: gn_solve_plain(*args, **kw), 2)
        per_it, fixed = iteration_fit(gn_solve, args, kw)
        bytes_moved = gn_bytes(args, t_g, i_g)
        # Operations: every item's own iteration count, both sets.
        ops = int(i_g.sum()) * 2 * n * OPS_PER_SAMPLE
        bound_ms, bound_by = roofline(bytes_moved, ops)
        bound_share[bound_by] += bound_ms
        log(f"    kernel {ms:.4f} ms (device {device_ms:.4f} ms), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
            f"{bytes_moved / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP), kernel / "
            f"bound {ms / bound_ms:.1f}; threshold 0: {per_it:.4f} ms per "
            f"iteration + {fixed:.4f} ms")
        log("    plans (CTAs x threads ms): "
            + plan_sweep(module, gn_solve_with_plan, args, kw))
        rows.append(dict(level=f"{kw['width']}x{kw['height']}", p=p, n=n,
                         items=t_g.shape[0],
                         mean_it=float(i_g.float().mean()),
                         max_it=int(i_g.max()), per_it=per_it, fixed=fixed,
                         ms=ms, device=device_ms, bound=bound_ms,
                         plain=plain_ms, plan=plan))
        for k, v in (("ms", ms), ("device_ms", device_ms),
                     ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
            totals[k] += v
    level_table(rows)
    log(f"  per chunk (sum of {len(calls)} levels): kernel "
        f"{totals['ms']:.4f} ms (device {totals['device_ms']:.4f} ms), "
        f"plain {totals['plain_ms']:.3f} ms, bound "
        f"{totals['bound_ms']:.4f} ms")
    return dict(name="gn_solve", route="cuda",
                source="video_stabilizer_tpu_torch/csrc/gn_solve.cu",
                replaces=GN_REPLACES, max_abs_err=worst, ms=totals["ms"],
                device_ms=totals["device_ms"], plain_ms=totals["plain_ms"],
                bound_ms=totals["bound_ms"],
                bound_by=max(bound_share, key=bound_share.get),
                library_ms=None)


@phase("4K homography path: capture two chunks' kernel inputs, and align "
       "16 pairs with known perspective")
def capture_4k(params, dev):
    from video_stabilizer_tpu_torch.models import chunked
    from video_stabilizer_tpu_torch.models import homography_aligner as ha
    from video_stabilizer_tpu_torch.models.aligner import level_specs
    from video_stabilizer_tpu_torch.models.stabilizer import bgr_to_gray
    from video_stabilizer_tpu_torch.ops.gn8_solve import gn8_solve
    from video_stabilizer_tpu_torch.ops.pyr_down import build_pyramid
    from video_stabilizer_tpu_torch.ops.warp_kernel import warp_frames

    frames, _ = synth_streams(dev, 2 * CHUNK, GN_CONTENT, H4K, W4K,
                              SEEDS_4K)
    states = chunked.init_stream_state(W4K, H4K, params, 3, len(SEEDS_4K),
                                       dev, model=HOMOGRAPHY)
    states = chunked.stabilize_chunk_streams(states, frames[:, :CHUNK],
                                             params, HOMOGRAPHY)[0]
    chunk1 = torch.as_tensor(frames[:, CHUNK:]).to(dev)
    with mock.patch.object(ha, "gn8_solve", wraps=gn8_solve) as spy:
        _, delayed, accums, *_ = chunked.stabilize_chunk_core(
            states, chunk1, params, W4K, H4K, HOMOGRAPHY)
    calls = [(c.args, c.kwargs) for c in spy.call_args_list]

    # Pairs with perspective: each template is a frame of the clip warped
    # by a known homography through kernel A, so the aligner must find
    # p6, p7 far from 0 at every level.
    g = torch.Generator().manual_seed(SEED + 1)
    n = 16
    p_true = (torch.rand((n, 8), generator=g) * 2 - 1) * torch.tensor(
        [2e-3, 2e-3, 3.0 / W4K, 2e-3, 2e-3, 3.0 / W4K, 4e-3, 4e-3])
    key = bgr_to_gray(chunk1.reshape((-1, H4K, W4K, 3))[:n])
    tmpl = warp_frames(key[..., None].contiguous(), p_true.to(dev), 0,
                       interp="lanczos2", model=HOMOGRAPHY)[..., 0]
    specs = level_specs(W4K, H4K, params.aligner)
    key_pyr = build_pyramid(key, len(specs))
    tmpl_pyr = build_pyramid(tmpl, len(specs))
    idx = torch.arange(n, device=dev)
    with mock.patch.object(ha, "gn8_solve", wraps=gn8_solve) as spy:
        p_found, failed = ha.align_all_levels_h(
            tmpl_pyr, idx, ha._compute_keyframe_h(key_pyr, specs), idx, specs,
            params.aligner, torch.zeros((n, 8), device=dev))
    persp = [(c.args, c.kwargs) for c in spy.call_args_list]
    err = (p_found.cpu() - p_true).abs().amax(dim=0)
    log(f"  perspective pairs: {int(failed.sum())} of {n} failed; found p "
        f"within {[float(f'{e:.1e}') for e in err]} of the true p")
    torch.cuda.synchronize()
    return dict(warp_frames=delayed.reshape(-1, H4K, W4K, 3),
                warp_ts=accums.reshape(-1, 8).contiguous(), gn8_calls=calls,
                persp_calls=persp, levels=len(specs))


@phase("kernel A: output warp vs its plain version (4K, homography)")
def check_warp_4k(cap, crop, dev):
    from video_stabilizer_tpu_torch.ops.warp_kernel import (
        warp_frames, warp_frames_plain)

    form = dict(interp="lanczos2", model=HOMOGRAPHY)
    frames, ts = cap["warp_frames"], cap["warp_ts"]
    bsz = frames.shape[0]
    max_err, equal = warp_compare(frames, ts, crop, group=4, **form)
    check(max_err <= 1 and equal >= 0.999,
          f"4K path's inputs ({bsz} frames, real corrections, crop {crop}): "
          f"max |diff| {max_err} LSB, {equal * 100:.4f} % equal")
    g = torch.Generator().manual_seed(SEED + 2)
    rnd = (torch.rand((8, 8), generator=g) * 2 - 1) * 4e-3
    rnd[:, [2, 5]] = (torch.rand((8, 2), generator=g) * 2 - 1) * 40 / W4K
    rnd = rnd.to(dev)
    sub = frames[:8].contiguous()
    max_rnd, equal_rnd = warp_compare(sub, rnd, 0, group=4, **form)
    check(max_rnd <= 1 and equal_rnd >= 0.999,
          f"random homographies (8 frames, |p0,p1,p3,p4|, |p6,p7| <= 4e-3, "
          f"|t| <= 40 px): max |diff| {max_rnd} LSB, "
          f"{equal_rnd * 100:.4f} % equal")
    max_b, equal_b = warp_compare(sub[:4], rnd[:4], crop, group=4,
                                  interp="bilinear", model=HOMOGRAPHY)
    check(max_b <= 1 and equal_b >= 0.999,
          f"homography + bilinear (4 frames): max |diff| {max_b} LSB, "
          f"{equal_b * 100:.4f} % equal")
    del sub
    max_ragged = warp_ragged(dev, HOMOGRAPHY)

    ms = cuda_ms(lambda: warp_frames(frames, ts, crop, **form), 10)

    def plain():
        for i in range(0, bsz, 4):
            warp_frames_plain(frames[i:i + 4], ts[i:i + 4], crop, **form)
    plain_ms = cuda_ms(plain, 1)
    bound_ms, bound_by, gb, gflop = warp_bound(frames, ts, crop, **form)
    log(f"  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms ({bound_by}: {gb:.3f} GB, {gflop:.1f} GFLOP), "
        f"kernel / bound {ms / bound_ms:.1f}; no library call: grid_sample "
        "has no Lanczos2")
    return dict(name="warp_frames[homography,lanczos2]", route="cuda",
                source="video_stabilizer_tpu_torch/csrc/warp.cu",
                replaces=WARP_REPLACES,
                max_abs_err=max(max_err, max_rnd, max_ragged), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def corner_gap(p_a, p_b, width, height):
    """(B,) max distance between the level's GN corners ((w-1, h-1)
    extent) warped by two (B, 8) homographies, in px at that level."""
    from video_stabilizer_tpu_torch import homography as Hm
    from video_stabilizer_tpu_torch.ops.gn_solve import gn_corners
    corners = gn_corners(width, height, p_a.device)
    a = Hm.warp_points(p_a[:, None, :].double(), corners.double(), width,
                       height)
    b = Hm.warp_points(p_b[:, None, :].double(), corners.double(), width,
                       height)
    return torch.linalg.vector_norm(a - b, dim=-1).amax(dim=-1)


# Kernel C against its plain version, on every item: converged equal and
# the level's GN corners within this bar (px at the level's size). Both
# loops run the same f32 arithmetic and differ only in the order of the
# sums over keypoints and in the compose (1/M22 times each entry in the
# kernel, as _compose_h; a division in the plain version, as the XLA loop).
# The 8x8 Hessian of a small level is ill-conditioned along p6/p7, and its
# inverse carries those rounding differences into p: on an H100 (700 W)
# the gap reached 3.5e-3 px at 60x33 with equal iteration counts,
# and 1.8e-2 px on an L0 item whose loop stopped one iteration later. A
# loop stops when a step moves no corner by the 0.02 px threshold, so the
# two loops are held to that threshold; the share of items within 1e-3 px
# is reported beside it. The perspective items' p6/p7, at least 10x the
# largest p6/p7 gap, make sure the kernel updates p6 and p7 at all.
GN8_CORNER_BAR = 0.02


@phase("kernel C: per-level 8-DOF GN solve vs its plain version")
def check_gn8(cap):
    from video_stabilizer_tpu_torch.ops import gn8_solve as module
    from video_stabilizer_tpu_torch.ops.gn8_solve import (
        OPS_PER_SAMPLE, gn8_solve, gn8_solve_plain, gn8_solve_with_plan,
        launch_plan)

    calls, persp = cap["gn8_calls"], cap["persp_calls"]
    check(len(calls) == cap["levels"] == len(persp),
          f"{len(calls)} kernel C launches per chunk and {len(persp)} for "
          f"the perspective pairs ({cap['levels']} levels)")
    totals = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0)
    bound_share = dict(bytes=0.0, operations=0.0)
    worst = 0.0
    rows = []
    for (args, kw), (pargs, pkw) in zip(calls, persp):
        w, h = kw["width"], kw["height"]
        p_size, n = args[0].shape[1], args[0].shape[3]
        level = f"{w}x{h} (P={p_size}, N={n})"
        gaps, conv_equal, p67_gap, medians = [], True, 0.0, None
        n_items, n_fine, same_iter_gap = 0, 0, 0.0
        for name, (a, k) in (("captured", (args, kw)),
                             ("perspective", (pargs, pkw))):
            p_g, c_g, d_g, i_g = gn8_solve(*a, **k)
            p_w, c_w, d_w, i_w = gn8_solve_plain(*a, **k)
            check(deterministic(lambda: gn8_solve(*a, **k)),
                  f"{level} {name}: two launches give bit-identical outputs")
            same = bool((c_g == c_w).all())
            conv_equal &= same
            item_gap = corner_gap(p_g, p_w, w, h)
            gap = float(item_gap.max())
            gaps.append(gap)
            n_items += item_gap.numel()
            n_fine += int((item_gap <= 1e-3).sum())
            same = i_g == i_w
            if bool(same.any()):
                same_iter_gap = max(same_iter_gap,
                                    float(item_gap[same].max()))
            p67_gap = max(p67_gap, float((p_g[:, 6:] - p_w[:, 6:]).abs().max()))
            for i in torch.nonzero(c_g != c_w).flatten().tolist():
                log(f"    {name} item {i}: converged {bool(c_g[i])} "
                    f"(kernel) vs {bool(c_w[i])} (plain), iters "
                    f"{int(i_g[i])} vs {int(i_w[i])}")
            log(f"    {level} {name}, {p_g.shape[0]} items: converged "
                f"{float(c_g.float().mean()) * 100:.1f} %, mean iters "
                f"{float(i_g.float().mean()):.2f}, corner gap {gap:.2e} px, "
                f"|d iters| {int((i_g - i_w).abs().max())}")
            if name == "perspective":
                medians = float(p_w[:, 6:].abs().amax(dim=1).median())
        worst = max(worst, *gaps)
        check(conv_equal and max(gaps) <= GN8_CORNER_BAR,
              f"{level}: converged equal on all items {conv_equal}; corner "
              f"gap {max(gaps):.2e} px (bar {GN8_CORNER_BAR:.0e}; "
              f"{same_iter_gap:.2e} px where the iterations are equal; "
              f"{n_fine} of {n_items} items within 1e-3 px); p6/p7 gap "
              f"{p67_gap:.2e}")
        check(medians >= 10 * p67_gap,
              f"{level}: the perspective items' max(|p6|,|p7|) has median "
              f"{medians:.2e}, >= 10x the largest p6/p7 gap {p67_gap:.2e}")
        p_out, _, _, iters = gn8_solve(*args, **kw)
        plan = launch_plan(p_out.shape[0], n)
        log(f"    plan: {describe_plan(plan)}")
        ms = cuda_ms(lambda: gn8_solve(*args, **kw), 10)
        device_ms = graph_ms(lambda: gn8_solve(*args, **kw), 20)
        plain_ms = cuda_ms(lambda: gn8_solve_plain(*args, **kw), 1)
        per_it, fixed = iteration_fit(gn8_solve, args, kw)
        bytes_moved = gn_bytes(args, p_out, iters)
        ops = int(iters.sum()) * 2 * n * OPS_PER_SAMPLE
        bound_ms, bound_by = roofline(bytes_moved, ops)
        bound_share[bound_by] += bound_ms
        log(f"    kernel {ms:.4f} ms (device {device_ms:.4f} ms), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
            f"{bytes_moved / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP), kernel / "
            f"bound {ms / bound_ms:.1f}; mean iters "
            f"{float(iters.float().mean()):.2f}; threshold 0: {per_it:.4f} "
            f"ms per iteration + {fixed:.4f} ms")
        log("    plans (CTAs x threads ms): "
            + plan_sweep(module, gn8_solve_with_plan, args, kw))
        rows.append(dict(level=f"{w}x{h}", p=p_size, n=n,
                         items=p_out.shape[0],
                         mean_it=float(iters.float().mean()),
                         max_it=int(iters.max()), per_it=per_it, fixed=fixed,
                         ms=ms, device=device_ms, bound=bound_ms,
                         plain=plain_ms, plan=plan))
        for key, val in (("ms", ms), ("device_ms", device_ms),
                         ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
            totals[key] += val
    level_table(rows)
    log(f"  per chunk (sum of {len(calls)} levels): kernel "
        f"{totals['ms']:.4f} ms (device {totals['device_ms']:.4f} ms), "
        f"plain {totals['plain_ms']:.3f} ms, bound "
        f"{totals['bound_ms']:.4f} ms")
    return dict(name="gn8_solve", route="cuda",
                source="video_stabilizer_tpu_torch/csrc/gn8_solve.cu",
                replaces=GN8_REPLACES, max_abs_err=worst, ms=totals["ms"],
                device_ms=totals["device_ms"], plain_ms=totals["plain_ms"],
                bound_ms=totals["bound_ms"],
                bound_by=max(bound_share, key=bound_share.get),
                library_ms=None)


def drive_path(frames, params, dev, model="similarity"):
    """Drive a chunked path over every chunk of ``frames`` (S, T, H, W, 3)
    from a fresh state, with every launch count set to 0 just before and
    read just after. Checks each chunk's output; prints the chunk times,
    frames/s, peak memory and the per-stage device times. Returns (launch
    counts, meas (S, T, P), ok (S, T), states, last chunk)."""
    from video_stabilizer_tpu_torch.models import chunked
    from video_stabilizer_tpu_torch.utils.spans import Recorder

    streams, total, height, width = frames.shape[:4]
    # Each chunk arrives in its own pinned host buffer, as a server's
    # decoder would leave it; filling the buffers is set-up, not timed.
    chunks = [torch.from_numpy(np.ascontiguousarray(
        frames[:, c:c + CHUNK])).pin_memory()
        for c in range(0, total, CHUNK)]
    states = chunked.init_stream_state(width, height, params, 3, streams,
                                       dev, model=model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    walls, device_ms, stage_runs, metas, succs = [], [], [], [], []
    for c, chunk in enumerate(chunks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        with Recorder() as rec:
            states, out, meas, succ, valid = chunked.stabilize_chunk_streams(
                states, chunk, params, model)
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))
        stage_runs.append(rec.totals())
        crop = 2 * params.crop_pixels
        check(tuple(out.shape) == (streams, CHUNK, height - crop,
                                   width - crop, 3)
              and out.dtype == torch.uint8,
              f"chunk {c}: output {tuple(out.shape)} {out.dtype}")
        expect_valid = np.arange(c * CHUNK, (c + 1) * CHUNK) >= params.lag
        check(bool((valid.cpu().numpy() == expect_valid[None]).all()),
              f"chunk {c}: the first {params.lag} outputs of the stream "
              "are marked invalid, the rest valid")
        check(bool(out.any()), f"chunk {c}: output not blank")
        metas.append(meas.cpu().numpy())
        succs.append(succ.cpu().numpy())
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    log(f"  chunk wall (host clock, synchronized): "
        + ", ".join(f"{w:.1f}" for w in walls) + " ms")
    log(f"  chunk on the device timeline (CUDA events): "
        + ", ".join(f"{w:.1f}" for w in device_ms) + " ms")
    steady = walls[1:]
    fps = streams * CHUNK / (np.mean(steady) / 1e3)
    log(f"  steady chunk {np.mean(steady):.1f} ms = {fps:.1f} frames/s "
        f"(mean of chunks 1-{len(chunks) - 1}); peak device memory "
        f"{peak_gb:.2f} GB")
    names = list(stage_runs[0])
    mean = {k: float(np.mean([r.get(k, 0.0) for r in stage_runs[1:]]))
            for k in names}
    log(f"  stage device times, mean of chunks 1-{len(chunks) - 1} (CUDA "
        "events):")
    for k in names:
        log(f"    {k:<22} {mean[k]:9.3f} ms")
    log(f"    {'sum of stages':<22} {sum(mean.values()):9.3f} ms")
    log(f"  launches: {launches}")
    ok = np.concatenate(succs, axis=1)
    rate = float(ok.mean())
    check(rate >= 0.9, f"align success rate {rate:.4f} "
          f"({int(ok.sum())} of {ok.size}; each stream's first frame has "
          "nothing to align to)")
    return (launches, np.concatenate(metas, axis=1), ok, states, chunks[-1])


@phase("main path: 1080p similarity, 8 streams x 16-frame chunks, carried "
       "state")
def main_path(frames, poses, params, dev):
    launches, meas, ok, states, last = drive_path(frames, params, dev)
    check(launches.get("warp_frames[similarity,bilinear]", 0) > 0
          and launches["gn_solve"] > 0,
          "kernel A (similarity, bilinear) and kernel B launched")
    # Motion from frame t-1 to t of a translation-only clip is minus the
    # window offset step. The bars allow for the clip's own bias: each
    # bilinear crop blurs its frame by its own sub-pixel phase. On such a
    # clip (270x480, jitter 1 px, 11 frames, on the CPU) the JAX package's
    # aligner is off by RMS 0.10 px and at most 0.19 px, the port's by
    # 0.11 and 0.19.
    rms, max_err = known_motion_error(meas[..., 2:], ok, poses)
    check(max_err < 0.5 and rms < 0.2,
          f"measured TX/TY against the clip's known motion: RMS {rms:.4f} "
          f"px, max {max_err:.4f} px")
    ab = float(np.abs(meas[..., :2][ok]).max())
    check(ab < 2e-3, f"measured |A|,|B| on a translation-only clip: {ab:.2e}")
    return launches, states, last


@phase("4K homography path: 2 streams x 16-frame chunks, carried state")
def main_path_4k(frames, poses, params, dev):
    launches, meas, ok, states, last = drive_path(frames, params, dev,
                                                  HOMOGRAPHY)
    check(launches["gn8_solve"] > 0
          and launches.get("warp_frames[homography,lanczos2]", 0) > 0
          and launches["gn_solve"] == 0,
          "kernel C and kernel A (homography, Lanczos2) launched, kernel B "
          "not")
    # The normalized translation (p2, p5) times W is the motion in px at
    # the frame centre. On such a clip (270x480, jitter 1 px, pan 0.3,
    # seeds 5 and 6, 12 frames, on the CPU) the JAX package's 8-DOF aligner
    # is off by RMS 0.033 px and at most 0.080 px, the port's by 0.036 and
    # 0.107; its |p0,p1,p3,p4| reach 8.3e-4 and |p6,p7| 1.4e-3.
    rms, max_err = known_motion_error(meas[..., [2, 5]] * W4K, ok, poses)
    check(max_err < 0.3 and rms < 0.1,
          f"measured p2*W, p5*W against the clip's known motion: RMS "
          f"{rms:.4f} px, max {max_err:.4f} px")
    lin = float(np.abs(meas[..., [0, 1, 3, 4]][ok]).max())
    persp = float(np.abs(meas[..., 6:][ok]).max())
    check(lin < 2e-3 and persp < 3e-3,
          f"measured |p0,p1,p3,p4| {lin:.2e}, |p6,p7| {persp:.2e} on a "
          "translation-only clip")
    return launches, states, last


@phase("device busy share of one more chunk (torch.profiler)")
def profile_chunk(states, chunk, params, model="similarity"):
    from torch.profiler import ProfilerActivity, profile

    from video_stabilizer_tpu_torch.models import chunked

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        chunked.stabilize_chunk_streams(states, chunk, params, model)
        end.record()
        torch.cuda.synchronize()
    span_ms = start.elapsed_time(end)
    rows = [(getattr(e, "self_device_time_total", 0.0) / 1e3, e.count,
             e.key) for e in prof.key_averages()]
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        log("  the profiler recorded no device time: busy share not "
            "measured")
        return
    log(f"  chunk {span_ms:.1f} ms on the device timeline, kernels and "
        f"copies {busy:.1f} ms: busy {busy / span_ms * 100:.1f} %, idle "
        f"{(1 - busy / span_ms) * 100:.1f} %")
    log("  top device time by kernel:")
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        log(f"    {ms:9.3f} ms  {count:6d}x  {key[:70]}")


@phase("1080p at 4 px jitter: one chunk with kernel B, one with its plain "
       "version")
def wide_jitter(params, dev):
    """Reported, with no bar: how the GN loop fares past bench.py's 1 px
    jitter, with the kernel and with its plain version (the reference's
    loop in PyTorch) on the same chunk."""
    from video_stabilizer_tpu_torch.models import aligner, chunked
    from video_stabilizer_tpu_torch.ops.gn_solve import (
        gn_solve, gn_solve_plain)

    frames, poses = synth_streams(dev, CHUNK, WIDE_CONTENT)
    runs = {}
    for name, engine in (("kernel", gn_solve), ("plain", gn_solve_plain)):
        levels = []

        def recorded(*args, engine=engine, levels=levels, **kw):
            out = engine(*args, **kw)
            levels.append((kw["width"], kw["height"], kw["max_iters"], out))
            return out
        states = chunked.init_stream_state(WIDTH, HEIGHT, params, 3, STREAMS,
                                           dev)
        with mock.patch.object(aligner, "gn_solve", recorded):
            _, _, meas, ok, _ = chunked.stabilize_chunk_streams(
                states, frames, params)
        meas, ok = meas.cpu().numpy(), ok.cpu().numpy()
        rms, max_err = known_motion_error(meas[..., 2:], ok, poses)
        runs[name] = levels
        log(f"  {name}: {int(ok.sum())} of {ok.size} frames aligned; "
            f"TX/TY against the known motion RMS {rms:.4f} px, max "
            f"{max_err:.4f} px")
        for w, h, max_iters, (_, conv, _, iters) in levels:
            log(f"    {w}x{h}: {float(conv.float().mean()) * 100:.1f} % "
                f"converged, {int((iters >= max_iters).sum())} of "
                f"{iters.numel()} items at max_iters, mean iters "
                f"{float(iters.float().mean()):.2f}")
    for (w, h, _, got), (_, _, _, want) in zip(runs["kernel"],
                                               runs["plain"]):
        differ = int((got[1] != want[1]).sum())
        log(f"  {w}x{h}: converged differs on {differ} items; "
            f"|dTX,dTY| over all items "
            f"{float((got[0][:, 2:] - want[0][:, 2:]).abs().max()):.2e} px")


@phase("small clip: the port on the card vs the port on the CPU")
def small_reference(dev):
    from video_stabilizer_tpu_torch.config import StabilizerParams
    from video_stabilizer_tpu_torch.models import chunked
    from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

    params = StabilizerParams(lag=4, smoother_memory=2, crop_pixels=8)
    frames = np.stack([synth_shaky_clip(16, 96, 128, seed=51 + s,
                                        jitter_px=0.8, pan_px_per_frame=0.3,
                                        rot_jitter=0.002) for s in range(2)])
    outs = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        st = chunked.init_stream_state(128, 96, params, 3, 2, d)
        res = []
        for c in range(2):
            st, out, meas, ok, _ = chunked.stabilize_chunk_streams(
                st, frames[:, 8 * c:8 * (c + 1)], params)
            res.append((out.cpu().numpy(), meas.cpu().numpy(),
                        ok.cpu().numpy()))
        outs[name] = [np.concatenate(x, axis=1) for x in zip(*res)]
    (o_g, m_g, k_g), (o_c, m_c, k_c) = outs["card"], outs["cpu"]
    d_ab = float(np.abs(m_g[..., :2] - m_c[..., :2]).max())
    d_t = float(np.abs(m_g[..., 2:] - m_c[..., 2:]).max())
    within = float((np.abs(o_g.astype(np.int32) - o_c) <= 1).mean())
    check(bool((k_g == k_c).all()) and d_ab <= 6e-4 and d_t <= 0.1
          and within >= 0.99,
          f"ok equal {bool((k_g == k_c).all())}, |dA,dB| {d_ab:.2e}, "
          f"|dTX,dTY| {d_t:.2e}, {within * 100:.3f} % of pixels within "
          "1 LSB")


# --------------------------------------------------------------------------
# The streaming path: one stream, one frame in and one out (VideoStabilizer)
# --------------------------------------------------------------------------

STREAM_FRAMES = 48        # S1's timed frames from a fresh state
STREAM_PROFILED = 8       # then these under torch.profiler
STREAM_CAPTURED = 4       # then these with the kernels' inputs captured
STREAM_STEADY = 12        # latency over frames STREAM_STEADY .. 47
STREAM_VS_CHUNKED = 32    # S2: frames through both paths
# The entries of S3 in the kernels line, each with the launch count of S1
# that it reports.
STREAM_KERNELS = (("warp_frames[similarity,bilinear,1 frame]",
                   "warp_frames[similarity,bilinear]"),
                  ("gn_solve[1 item]", "gn_solve"))
STREAM_TOP = ("ConvertToGray", "AlignNextFrame", "SmootherUpdate",
              "WarpBySimilarityTransform")


def recording(stab):
    """Wrap ``stab``'s aligner so that every frame's (transform, ok) device
    tensors are kept (read after the run, so no extra host sync)."""
    record = []
    align = stab.aligner.align_next_frame

    def recorded(gray):
        t, ok = align(gray)
        record.append((t, ok))
        return t, ok
    stab.aligner.align_next_frame = recorded
    return record


def read_record(record):
    """(meas (T, 4), ok (T,)) numpy of a ``recording``."""
    meas = torch.stack([t for t, _ in record]).cpu().numpy()
    ok = torch.stack([k for _, k in record]).cpu().numpy()
    return meas, ok


@phase("S1. streaming path: 1080p, one stream, VideoStabilizer, timed")
def streaming_path(frames, poses, params, dev):
    """``STREAM_FRAMES`` frames through ``VideoStabilizer`` from a fresh
    state with every launch count set to 0 before and read after, each
    frame timed on the host clock up to its sync; then
    ``STREAM_PROFILED`` more under torch.profiler and ``STREAM_CAPTURED``
    more with kernel A's and B's inputs captured. Returns the first
    ``STREAM_VS_CHUNKED`` frames' results for S2, the launches and the
    captured inputs for S3."""
    from torch.profiler import ProfilerActivity, profile

    from video_stabilizer_tpu_torch.models import aligner, batch
    from video_stabilizer_tpu_torch.models.stabilizer import VideoStabilizer
    from video_stabilizer_tpu_torch.ops.gn_solve import gn_solve
    from video_stabilizer_tpu_torch.ops.warp_kernel import warp_frames
    from video_stabilizer_tpu_torch.utils.spans import Recorder

    lag, crop = params.lag, params.crop_pixels
    # Each frame arrives in its own pinned host buffer, as a camera's
    # decoder would leave it; filling the buffers is set-up, not timed.
    host = [torch.from_numpy(np.ascontiguousarray(f)).pin_memory()
            for f in frames]
    stab = VideoStabilizer(params, dev)
    record = recording(stab)
    torch.cuda.synchronize()
    reset_launch_counts()
    walls, device_ms, stage_runs, outs = [], [], [], []
    for i in range(STREAM_FRAMES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        with Recorder() as rec:
            out = stab.process_frame(host[i])
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))
        stage_runs.append(rec.totals())
        if out is not None:
            outs.append(out)
    launches = launch_counts()

    want_shape = (HEIGHT - 2 * crop, WIDTH - 2 * crop, 3)
    check(len(outs) == STREAM_FRAMES - lag
          and all(tuple(o.shape) == want_shape and o.dtype == torch.uint8
                  for o in outs),
          f"{len(outs)} outputs (want {STREAM_FRAMES - lag}), each "
          f"{want_shape} u8: {sorted({tuple(o.shape) for o in outs})}")
    check(all(bool(o.any()) for o in outs), "no output blank")
    meas, ok = read_record(record)
    rate = float(ok[1:].mean())
    check(rate >= 0.9, f"align success {rate:.4f} ({int(ok[1:].sum())} of "
          f"{STREAM_FRAMES - 1} alignable frames)")
    rms, max_err = known_motion_error(meas[None, :, 2:], ok[None],
                                      poses[None, :STREAM_FRAMES])
    check(max_err < 0.5 and rms < 0.2,
          f"measured TX/TY against the clip's known motion: RMS {rms:.4f} "
          f"px, max {max_err:.4f} px")
    levels = len(aligner.level_specs(WIDTH, HEIGHT, params.aligner))
    want_b = levels * STREAM_FRAMES
    n_a = launches.get("warp_frames[similarity,bilinear]", 0)
    check(n_a == STREAM_FRAMES - lag and launches["gn_solve"] == want_b
          and launches["gn8_solve"] == 0
          and sum(launches.values()) == n_a + want_b,
          f"launches {launches}: kernel A {STREAM_FRAMES - lag} (one per "
          f"output), kernel B {want_b} (one per level of every frame, the "
          "first included), kernel C 0")

    steady = np.asarray(walls[STREAM_STEADY:])
    log(f"  per-frame latency, host clock up to the frame's sync, frames "
        f"{STREAM_STEADY}-{STREAM_FRAMES - 1}: median "
        f"{np.median(steady):.1f} ms, p90 {np.percentile(steady, 90):.1f} "
        f"ms, min {steady.min():.1f}, max {steady.max():.1f}; on the "
        f"device timeline median "
        f"{np.median(device_ms[STREAM_STEADY:]):.1f} ms")
    log(f"  frames 0-{STREAM_STEADY - 1} (host clock): "
        + ", ".join(f"{w:.0f}" for w in walls[:STREAM_STEADY]) + " ms")
    runs = stage_runs[STREAM_STEADY:]
    names = sorted({k for r in runs for k in r},
                   key=lambda k: (k not in STREAM_TOP,
                                  STREAM_TOP.index(k) if k in STREAM_TOP
                                  else 0, k))
    log(f"  per-frame stage device times, mean of frames {STREAM_STEADY}-"
        f"{STREAM_FRAMES - 1} (CUDA events; the aligner's stages nest in "
        "AlignNextFrame, keyframe runs every other frame):")
    for k in names:
        pad = "" if k in STREAM_TOP else "  "
        log(f"    {pad}{k:<26} {np.mean([r.get(k, 0.0) for r in runs]):9.3f}"
            " ms")
    log(f"    sum of the top stages      "
        f"{sum(np.mean([r.get(k, 0.0) for r in runs]) for k in STREAM_TOP):9.3f}"
        " ms")

    # Device busy share over more frames. A frame issues some 40k device
    # operations, too many to build the profiler's event tree
    # (key_averages) in time: the device events' durations are summed
    # straight from its raw results.
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for f in host[STREAM_FRAMES:STREAM_FRAMES + STREAM_PROFILED]:
            stab.process_frame(f)
        end.record()
        torch.cuda.synchronize()
    span_ms = start.elapsed_time(end)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    busy = sum(e.duration_ns() for e in events) / 1e6
    if busy > 0:
        log(f"  {STREAM_PROFILED} frames under torch.profiler: "
            f"{span_ms:.1f} ms on the device timeline, {len(events)} "
            f"kernels and copies {busy:.1f} ms: busy "
            f"{busy / span_ms * 100:.1f} %, idle "
            f"{(1 - busy / span_ms) * 100:.1f} %")
    else:
        log("  the profiler recorded no device time: busy share not "
            "measured")

    # Kernel inputs of a few more frames, for S3.
    with mock.patch.object(aligner, "gn_solve", wraps=gn_solve) as gn_spy, \
            mock.patch.object(batch, "warp_frames",
                              wraps=warp_frames) as warp_spy:
        first = STREAM_FRAMES + STREAM_PROFILED
        for f in host[first:first + STREAM_CAPTURED]:
            stab.process_frame(f)
    torch.cuda.synchronize()
    n_vs = STREAM_VS_CHUNKED - lag
    return dict(launches=launches, levels=levels,
                meas=meas[:STREAM_VS_CHUNKED],
                ok=ok[:STREAM_VS_CHUNKED],
                outs=torch.stack(outs[:n_vs]).cpu().numpy(),
                gn_calls=[(c.args, c.kwargs) for c in gn_spy.call_args_list],
                warp_calls=[(c.args, c.kwargs)
                            for c in warp_spy.call_args_list])


@phase("S2. streaming vs chunked on the card (first 32 frames of S1's clip)")
def streaming_vs_chunked(frames, params, dev, s1):
    """The JAX package's own bars for streaming vs clip (test_batch.py:
    28-83): ok equal, measurements within 1e-5, >= 99.5 % of output pixels
    within 1 LSB (the chunked path accumulates in float32 on the card, the
    streaming one in float64 on the host)."""
    from video_stabilizer_tpu_torch.models import chunked

    out, meas, ok = chunked.stabilize_stream_chunked(
        frames[:STREAM_VS_CHUNKED], params, CHUNK, device=dev)
    same_ok = bool((ok == s1["ok"]).all())
    d_meas = float(np.abs(meas - s1["meas"]).max())
    check(out.shape == s1["outs"].shape,
          f"output {out.shape} (streaming {s1['outs'].shape})")
    within = float((np.abs(out.astype(np.int32) - s1["outs"]) <= 1).mean())
    equal = float((out == s1["outs"]).mean())
    check(same_ok and d_meas <= 1e-5 and within >= 0.995,
          f"ok equal {same_ok}; |d meas| {d_meas:.2e} (bar 1e-5); "
          f"{within * 100:.3f} % of pixels within 1 LSB (bar 99.5 %), "
          f"{equal * 100:.3f} % equal")


@phase("S3. kernels B and A at one item / one frame vs their plain "
       "versions (captured from S1)")
def check_one_item(s1, crop):
    from video_stabilizer_tpu_torch.ops.gn_solve import (
        OPS_PER_SAMPLE, gn_solve, gn_solve_plain, launch_plan)
    from video_stabilizer_tpu_torch.ops.warp_kernel import (
        warp_frames, warp_frames_plain)

    calls, levels = s1["gn_calls"], s1["levels"]
    check(len(calls) == levels * STREAM_CAPTURED,
          f"{len(calls)} kernel B calls over {STREAM_CAPTURED} frames "
          f"({levels} levels)")
    totals = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0)
    bound_share = dict(bytes=0.0, operations=0.0)
    worst = 0.0
    for lvl in range(levels):
        items = calls[lvl::levels]           # this level of every frame
        kw = items[0][1]
        p, n = items[0][0][0].shape[1], items[0][0][0].shape[3]
        level = f"{kw['width']}x{kw['height']} (P={p}, N={n})"
        same, d_ab, d_t, iters = True, 0.0, 0.0, []
        one_item = all(args[-1].shape[0] == 1 for args, _ in items)
        for args, k in items:
            t_g, c_g, _, i_g = gn_solve(*args, **k)
            t_w, c_w, _, i_w = gn_solve_plain(*args, **k)
            same &= bool((c_g == c_w).all())
            d_ab = max(d_ab, float((t_g[:, :2] - t_w[:, :2]).abs().max()))
            d_t = max(d_t, float((t_g[:, 2:] - t_w[:, 2:]).abs().max()))
            iters.append(int(i_g[0]))
        worst = max(worst, d_ab, d_t)
        check(one_item and same and d_ab <= GN_AB_BAR and d_t <= GN_T_BAR,
              f"{level}, {len(items)} frames, one item per launch "
              f"{one_item}: converged equal {same}; "
              f"|dA,dB| {d_ab:.2e} (bar {GN_AB_BAR:.0e}), |dTX,dTY| "
              f"{d_t:.2e} px (bar {GN_T_BAR:.0e}); iterations {iters}")
        args, kw = items[0]
        check(deterministic(lambda: gn_solve(*args, **kw)),
              f"{level}: two launches give bit-identical outputs")
        t_g, _, _, i_g = gn_solve(*args, **kw)
        ms = cuda_ms(lambda: gn_solve(*args, **kw), 20)
        device_ms = graph_ms(lambda: gn_solve(*args, **kw), 20)
        plain_ms = cuda_ms(lambda: gn_solve_plain(*args, **kw), 2)
        bytes_moved = gn_bytes(args, t_g, i_g)
        ops = int(i_g.sum()) * 2 * n * OPS_PER_SAMPLE
        bound_ms, bound_by = roofline(bytes_moved, ops)
        bound_share[bound_by] += bound_ms
        log(f"    plan: {describe_plan(launch_plan(1, n))}; kernel "
            f"{ms:.4f} ms (device {device_ms:.4f} ms), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"{int(i_g[0])} iterations")
        for key, val in (("ms", ms), ("device_ms", device_ms),
                         ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
            totals[key] += val
    log(f"  per frame (sum of {levels} levels, one item each): kernel "
        f"{totals['ms']:.4f} ms (device {totals['device_ms']:.4f} ms), "
        f"plain {totals['plain_ms']:.3f} ms, bound "
        f"{totals['bound_ms']:.4f} ms")
    gn_entry = dict(name="gn_solve[1 item]", route="cuda",
                    source="video_stabilizer_tpu_torch/csrc/gn_solve.cu",
                    replaces=GN_REPLACES, max_abs_err=worst,
                    ms=totals["ms"], device_ms=totals["device_ms"],
                    plain_ms=totals["plain_ms"], bound_ms=totals["bound_ms"],
                    bound_by=max(bound_share, key=bound_share.get),
                    library_ms=None)

    warps = s1["warp_calls"]
    check(len(warps) == STREAM_CAPTURED,
          f"{len(warps)} kernel A calls over {STREAM_CAPTURED} frames")
    max_err, equal = 0, 1.0
    forms = {(tuple(a[0].shape), a[2], tuple(sorted(k.items())))
             for a, k in warps}
    for (frame, ts, c), _ in warps:
        e, q = warp_compare(frame, ts, c)
        max_err, equal = max(max_err, e), min(equal, q)
    check(forms == {((1, HEIGHT, WIDTH, 3), crop, (("interp", "bilinear"),))}
          and max_err <= 1 and equal >= 0.999,
          f"{len(warps)} streaming frames, calls {forms}: max |diff| "
          f"{max_err} LSB, at least {equal * 100:.4f} % equal per frame")
    (frame, ts, c), _ = warps[0]
    ms = cuda_ms(lambda: warp_frames(frame, ts, c), 20)
    device_ms = graph_ms(lambda: warp_frames(frame, ts, c), 20)
    plain_ms = cuda_ms(lambda: warp_frames_plain(frame, ts, c), 2)
    library_ms = grid_sample_ms(frame, ts, c, 20)
    bound_ms, bound_by, gb, gflop = warp_bound(frame, ts, c, "bilinear",
                                               "similarity")
    log(f"  one frame: kernel {ms:.4f} ms (device {device_ms:.4f} ms), "
        f"plain {plain_ms:.3f} ms, grid_sample {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {gb * 1e3:.2f} MB, {gflop:.3f} "
        f"GFLOP); device / bound {device_ms / bound_ms:.1f}")
    warp_entry = dict(name="warp_frames[similarity,bilinear,1 frame]",
                      route="cuda",
                      source="video_stabilizer_tpu_torch/csrc/warp.cu",
                      replaces=WARP_REPLACES, max_abs_err=max_err, ms=ms,
                      device_ms=device_ms, plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by=bound_by,
                      library_ms=library_ms)
    return warp_entry, gn_entry


@phase("S4. small clip: the streaming path on the card vs on the CPU")
def streaming_small_reference(dev):
    from video_stabilizer_tpu_torch.config import StabilizerParams
    from video_stabilizer_tpu_torch.models.stabilizer import VideoStabilizer
    from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

    params = StabilizerParams(lag=4, smoother_memory=2, crop_pixels=8)
    frames = synth_shaky_clip(20, 96, 128, seed=52, jitter_px=0.8,
                              pan_px_per_frame=0.3, rot_jitter=0.002)
    runs = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        stab = VideoStabilizer(params, d)
        record = recording(stab)
        outs = [stab.process_frame(f) for f in frames]
        runs[name] = (np.stack([o.cpu().numpy() for o in outs
                                if o is not None]),) + read_record(record)
    (o_g, m_g, k_g), (o_c, m_c, k_c) = runs["card"], runs["cpu"]
    same_ok = bool((k_g == k_c).all())
    within = float((np.abs(o_g.astype(np.int32) - o_c) <= 1).mean())
    check(same_ok and o_g.shape == o_c.shape and within >= 0.99,
          f"ok equal {same_ok} ({int(k_g.sum())} of {k_g.size} aligned); "
          f"outputs {o_g.shape}; |d meas| {np.abs(m_g - m_c).max():.2e}; "
          f"{within * 100:.3f} % of pixels within 1 LSB")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from video_stabilizer_tpu_torch.config import (
        AlignerParams, StabilizerParams)

    dev = torch.device("cuda")
    smi = nvidia_smi()
    log(f"card: {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    if not build_kernels():
        log("chip_smoke: FAILED (the kernels did not build)")
        return 1

    params = StabilizerParams(crop_pixels=32)
    # Config 4 (apps/bench_configs.py:34-53).
    params_4k = StabilizerParams(
        aligner=AlignerParams(phase_correlate=True),
        output_interp="lanczos2", crop_pixels=32)
    crop = params.crop_pixels
    synth_on_card(dev)
    kernels = {}
    cap = capture(params, dev)
    if cap is not None:
        kernels["warp_frames[similarity,bilinear]"] = check_warp(cap, crop,
                                                                 dev)
        kernels["gn_solve"] = check_gn(cap)
        del cap
    cap = capture_4k(params_4k, dev)
    if cap is not None:
        kernels["warp_frames[homography,lanczos2]"] = check_warp_4k(
            cap, crop, dev)
        kernels["gn8_solve"] = check_gn8(cap)
        del cap
    torch.cuda.empty_cache()

    # Each path runs with every launch count set to 0 just before it and
    # read just after; each kernel's launches come from the path it serves.
    path_launches = {}
    for name, run, model, prm, shape, chunks, seeds in (
            ("1080p", main_path, "similarity", params, (HEIGHT, WIDTH),
             CHUNKS, None),
            ("4K", main_path_4k, HOMOGRAPHY, params_4k, (H4K, W4K),
             CHUNKS_4K, list(SEEDS_4K))):
        t0 = time.perf_counter()
        frames, poses = synth_streams(dev, CHUNK * chunks, MAIN_CONTENT,
                                      *shape, seeds=seeds)
        log(f"== {name} path's clip {frames.shape} in "
            f"{time.perf_counter() - t0:.1f} s")
        result = run(frames, poses, prm, dev)
        del frames
        if result is None:
            continue
        launches, states, last_chunk = result
        for kname in kernels:
            if launches.get(kname, 0) > 0:
                path_launches[kname] = launches[kname]
        profile_chunk(states, last_chunk, prm, model)
        del states, last_chunk
        torch.cuda.empty_cache()
    wide_jitter(params, dev)
    small_reference(dev)

    # The streaming path: its own clip, its own launch counts (S1), read
    # into the two one-frame / one-item entries of kernels A and B (S3).
    t0 = time.perf_counter()
    frames, poses = synth_streams(
        dev, STREAM_FRAMES + STREAM_PROFILED + STREAM_CAPTURED, MAIN_CONTENT,
        seeds=[SEED])
    frames, poses = frames[0], poses[0]
    log(f"== streaming path's clip {frames.shape} in "
        f"{time.perf_counter() - t0:.1f} s")
    s1 = streaming_path(frames, poses, params, dev)
    one = (None, None)
    if s1 is not None:
        streaming_vs_chunked(frames, params, dev, s1)
        one = check_one_item(s1, crop) or one
        for name, counted in STREAM_KERNELS:
            if s1["launches"].get(counted, 0) > 0:
                path_launches[name] = s1["launches"][counted]
    del frames, s1
    torch.cuda.empty_cache()
    for (name, _), entry in zip(STREAM_KERNELS, one):
        kernels[name] = entry
    streaming_small_reference(dev)

    missing = [k for k, v in kernels.items()
               if v is None or k not in path_launches]
    if failures or missing or len(kernels) != 6:
        log("chip_smoke: FAILED:\n  " + "\n  ".join(
            failures + [f"{k}: not checked or not launched on its path"
                        for k in missing]))
        return 1
    for name, k in kernels.items():
        k["launches"] = path_launches[name]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # Kernels B and C also give their device time beside the wrapper's ms.
    print(json.dumps({"kernels": [
        {k: kern[k] for k in keys + ("device_ms",) if k in keys or k in kern}
        for kern in kernels.values()]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
