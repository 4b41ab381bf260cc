#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Run from the root of the repository. Phases:

  1. Build the port's CUDA kernels from ``video_stabilizer_tpu_torch/csrc``
     (one nvcc per source, all at once) and print what ptxas reports.
  2. Check that ``utils.io.synth_shaky_clip`` gives the same small clip on
     the card as on the CPU (the tests hold the CPU's to the JAX package's).
  3. Drive the main path over two chunks to capture real kernel inputs:
     1080p BGR, 8 streams, 16-frame chunks, state carried from chunk to
     chunk, on content with rotation and zoom jitter as well as 1 px shake.
  4. Kernel A (output warp) against its plain PyTorch version on the card:
     at the main path's batch (128 frames, crop 32) and at 16 frames with
     random similarity transforms. Bar: max 1 LSB, >= 99.9 % of pixels equal.
  5. Kernel B (per-level GN solve) against its plain version on the card,
     at each of the six 1080p level shapes, with the items of that chunk.
     Bar, over every item: converged equal, A/B within 1e-5, TX/TY within
     1e-3 px; and the items' A/B at least 10x the A/B bar.
  6. The main path, timed, on bench.py's content (translation only, 1 px
     jitter): 4 chunks with carried state from a fresh start, with both
     launch counters set to 0 before and read after. Checks the output
     shape, the align success rate (>= 0.9) and the measured motion against
     the clip's known motion. One more chunk runs under torch.profiler.
  7. Reported, no bar: one chunk of 4 px jitter content through kernel B
     and through its plain version, with convergence and known-motion
     error for each.
  8. The port on the card against the port on the CPU (the plain versions)
     on a small clip: ok equal, >= 99 % of output pixels within 1 LSB.

Every phase runs; the script exits 1 if any failed, 2 without a card. On
success it prints the per-stage times, one ``{"kernels": [...]}`` line, the
card's name and power limit, and as its last line
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
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside the tensor cores
WARP_REPLACES = "video_stabilizer_tpu/ops/pallas_warp.py:117"
GN_REPLACES = "video_stabilizer_tpu/ops/pallas_gn.py:133"

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


def synth_streams(dev, num_frames, content):
    """(S, T, H, W, 3) u8 host frames and (S, T, 4) window poses from
    ``utils.io.synth_shaky_clip``, seed SEED + s for stream s, with its
    crops computed on the card."""
    from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

    frames = np.empty((STREAMS, num_frames, HEIGHT, WIDTH, 3), np.uint8)
    poses = np.empty((STREAMS, num_frames, 4))
    for s in range(STREAMS):
        frames[s], poses[s] = synth_shaky_clip(
            num_frames, HEIGHT, WIDTH, seed=SEED + s, device=dev, poses=True,
            **content)
    return frames, poses


def known_motion_error(meas, ok, poses):
    """RMS and max px of the measured TX/TY of a translation-only clip
    against its known motion: from frame t-1 to t, minus the window offset
    step."""
    truth = -np.diff(poses[..., 2:], axis=1)
    err = (meas[:, 1:, 2:] - truth)[ok[:, 1:]]
    return float(np.sqrt(np.mean(err ** 2))), float(np.abs(err).max())


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

@phase("build")
def build_kernels():
    from video_stabilizer_tpu_torch.ops import cuda_build
    reports = cuda_build.build()
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")
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


def warp_compare(frames, ts, crop):
    from video_stabilizer_tpu_torch.ops.warp_kernel import (
        warp_frames, warp_frames_plain)
    got = warp_frames(frames, ts, crop)
    diffs = []
    for i in range(0, frames.shape[0], 16):
        want = warp_frames_plain(frames[i:i + 16], ts[i:i + 16], crop)
        diffs.append((got[i:i + 16].to(torch.int16)
                      - want.to(torch.int16)).abs())
    diff = torch.cat(diffs)
    return int(diff.max()), float((diff == 0).float().mean())


@phase("kernel A: output warp vs its plain version")
def check_warp(cap, crop, dev):
    from video_stabilizer_tpu_torch.ops.warp_kernel import (
        OPS_PER_PIXEL, warp_frames, warp_frames_plain)

    frames, ts = cap["warp_frames"], cap["warp_ts"]
    bsz = frames.shape[0]
    max_err, equal = warp_compare(frames, ts, crop)
    check(max_err <= 1 and equal >= 0.999,
          f"main-path inputs ({bsz} frames, crop {crop}): max |diff| "
          f"{max_err} LSB, {equal * 100:.4f} % equal")
    g = torch.Generator().manual_seed(SEED)
    rnd = torch.cat([(torch.rand((16, 2), generator=g) * 2 - 1) * 0.008,
                     (torch.rand((16, 2), generator=g) * 2 - 1) * 40], 1)
    max_rnd, equal_rnd = warp_compare(frames[:16].contiguous(),
                                      rnd.to(dev), 0)
    check(max_rnd <= 1 and equal_rnd >= 0.999,
          f"random similarity (16 frames, |A|,|B| <= 0.008, |t| <= 40 px): "
          f"max |diff| {max_rnd} LSB, {equal_rnd * 100:.4f} % equal")

    ms = cuda_ms(lambda: warp_frames(frames, ts, crop), 10)

    def plain():
        for i in range(0, bsz, 16):
            warp_frames_plain(frames[i:i + 16], ts[i:i + 16], crop)
    plain_ms = cuda_ms(plain, 2)

    # Yardstick: one library call computing the same bilinear, zero-border
    # warp on the same frames, float NCHW in and out.
    ho, wo = HEIGHT - 2 * crop, WIDTH - 2 * crop
    src = frames.permute(0, 3, 1, 2).float()
    ys, xs = torch.meshgrid(
        torch.arange(crop, crop + ho, device=dev, dtype=torch.float32),
        torch.arange(crop, crop + wo, device=dev, dtype=torch.float32),
        indexing="ij")
    a, b, tx, ty = (ts[:, k, None, None] for k in range(4))
    sx = (1.0 + a) * xs - b * ys + tx
    sy = b * xs + (1.0 + a) * ys + ty
    grid = torch.stack([sx / (WIDTH - 1) * 2 - 1, sy / (HEIGHT - 1) * 2 - 1],
                       dim=-1)
    library_ms = cuda_ms(lambda: torch.nn.functional.grid_sample(
        src, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True), 5)
    del src, grid, sx, sy

    c = frames.shape[-1]
    n_out = bsz * ho * wo
    bytes_moved = frames.numel() + n_out * c + ts.numel() * 4
    ops = n_out * OPS_PER_PIXEL(c)
    bound_ms, bound_by = roofline(bytes_moved, ops)
    log(f"  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, grid_sample "
        f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}: "
        f"{bytes_moved / 1e9:.3f} GB, {ops / 1e9:.2f} GFLOP)")
    return dict(name="warp_frames", route="cuda",
                source="video_stabilizer_tpu_torch/csrc/warp.cu",
                replaces=WARP_REPLACES, max_abs_err=max(max_err, max_rnd),
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


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
    """Bytes kernel B must move for this run's data: the 4x4 window taps
    of both keypoint sets of every item at each of its iterations (at most
    a keyframe's whole windows), each other input of the items and of the
    keyframes in use read once, each output written once."""
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
    out_bytes = t_out.shape[0] * (4 + 3) * 4
    return taps + item_bytes + key_bytes + (ox.numel() + oy.numel()) * 4 \
        + out_bytes


@phase("kernel B: per-level GN solve vs its plain version")
def check_gn(cap):
    from video_stabilizer_tpu_torch.ops.gn_solve import (
        OPS_PER_SAMPLE, gn_solve, gn_solve_plain)

    calls = cap["gn_calls"]
    check(len(calls) == cap["levels"],
          f"{len(calls)} GN launches per chunk ({cap['levels']} levels)")
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    bound_share = dict(bytes=0.0, operations=0.0)
    worst = 0.0
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
        ms = cuda_ms(lambda: gn_solve(*args, **kw), 20)
        plain_ms = cuda_ms(lambda: gn_solve_plain(*args, **kw), 2)
        bytes_moved = gn_bytes(args, t_g, i_g)
        # Operations: every item's own iteration count, both sets.
        ops = int(i_g.sum()) * 2 * n * OPS_PER_SAMPLE
        bound_ms, bound_by = roofline(bytes_moved, ops)
        bound_share[bound_by] += bound_ms
        log(f"    kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}: {bytes_moved / 1e6:.1f} MB, "
            f"{ops / 1e9:.3f} GFLOP), kernel / bound {ms / bound_ms:.1f}")
        for k, v in (("ms", ms), ("plain_ms", plain_ms),
                     ("bound_ms", bound_ms)):
            totals[k] += v
    log(f"  per chunk (sum of {len(calls)} levels): kernel "
        f"{totals['ms']:.3f} ms, plain {totals['plain_ms']:.3f} ms, bound "
        f"{totals['bound_ms']:.4f} ms")
    return dict(name="gn_solve", route="cuda",
                source="video_stabilizer_tpu_torch/csrc/gn_solve.cu",
                replaces=GN_REPLACES, max_abs_err=worst, ms=totals["ms"],
                plain_ms=totals["plain_ms"], bound_ms=totals["bound_ms"],
                bound_by=max(bound_share, key=bound_share.get),
                library_ms=None)


@phase("main path: 1080p, 8 streams x 16-frame chunks, carried state")
def main_path(frames, poses, params, dev):
    from video_stabilizer_tpu_torch.models import chunked
    from video_stabilizer_tpu_torch.ops.gn_solve import gn_solve
    from video_stabilizer_tpu_torch.ops.warp_kernel import warp_frames
    from video_stabilizer_tpu_torch.utils.spans import Recorder

    # Each chunk arrives in its own pinned host buffer, as a server's
    # decoder would leave it; filling the buffers is set-up, not timed.
    chunks = [torch.from_numpy(np.ascontiguousarray(
        frames[:, c * CHUNK:(c + 1) * CHUNK])).pin_memory()
        for c in range(CHUNKS)]
    states = chunked.init_stream_state(WIDTH, HEIGHT, params, 3, STREAMS, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warp_frames.launches = 0
    gn_solve.launches = 0
    walls, device_ms, stage_runs, metas, succs = [], [], [], [], []
    for c in range(CHUNKS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        with Recorder() as rec:
            states, out, meas, succ, valid = chunked.stabilize_chunk_streams(
                states, chunks[c], params)
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))
        stage_runs.append(rec.totals())
        crop = 2 * params.crop_pixels
        check(tuple(out.shape) == (STREAMS, CHUNK, HEIGHT - crop,
                                   WIDTH - crop, 3)
              and out.dtype == torch.uint8,
              f"chunk {c}: output {tuple(out.shape)} {out.dtype}")
        expect_valid = np.arange(c * CHUNK, (c + 1) * CHUNK) >= params.lag
        check(bool((valid.cpu().numpy() == expect_valid[None]).all()),
              f"chunk {c}: the first {params.lag} outputs of the stream "
              "are marked invalid, the rest valid")
        check(bool(out.any()), f"chunk {c}: output not blank")
        metas.append(meas.cpu().numpy())
        succs.append(succ.cpu().numpy())
    launches = dict(warp_frames=warp_frames.launches,
                    gn_solve=gn_solve.launches)
    check(launches["warp_frames"] > 0 and launches["gn_solve"] > 0,
          f"launches in the main path: {launches}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    meas = np.concatenate(metas, axis=1)          # (S, T, 4)
    ok = np.concatenate(succs, axis=1)
    rate = float(ok.mean())
    check(rate >= 0.9, f"align success rate {rate:.4f} "
          f"({int(ok.sum())} of {ok.size}; each stream's first frame has "
          "nothing to align to)")
    # Motion from frame t-1 to t of a translation-only clip is minus the
    # window offset step. The bars allow for the clip's own bias: each
    # bilinear crop blurs its frame by its own sub-pixel phase. On such a
    # clip (270x480, jitter 1 px, 11 frames, on the CPU) the JAX package's
    # aligner is off by RMS 0.10 px and at most 0.19 px, the port's by
    # 0.11 and 0.19.
    rms, max_err = known_motion_error(meas, ok, poses)
    check(max_err < 0.5 and rms < 0.2,
          f"measured TX/TY against the clip's known motion: RMS {rms:.4f} "
          f"px, max {max_err:.4f} px")
    ab = float(np.abs(meas[..., :2][ok]).max())
    check(ab < 2e-3, f"measured |A|,|B| on a translation-only clip: {ab:.2e}")

    log(f"  chunk wall (host clock, synchronized): "
        + ", ".join(f"{w:.1f}" for w in walls) + " ms")
    log(f"  chunk on the device timeline (CUDA events): "
        + ", ".join(f"{w:.1f}" for w in device_ms) + " ms")
    steady = walls[1:]
    fps = STREAMS * CHUNK / (np.mean(steady) / 1e3)
    log(f"  steady chunk {np.mean(steady):.1f} ms = {fps:.1f} frames/s "
        f"(mean of chunks 1-3); peak device memory {peak_gb:.2f} GB")
    names = list(stage_runs[0])
    mean = {k: float(np.mean([r.get(k, 0.0) for r in stage_runs[1:]]))
            for k in names}
    log("  stage device times, mean of chunks 1-3 (CUDA events):")
    for k in names:
        log(f"    {k:<22} {mean[k]:9.3f} ms")
    log(f"    {'sum of stages':<22} {sum(mean.values()):9.3f} ms")
    return launches, states, chunks[-1]


@phase("device busy share of one more chunk (torch.profiler)")
def profile_chunk(states, chunk, params):
    from torch.profiler import ProfilerActivity, profile

    from video_stabilizer_tpu_torch.models import chunked

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        chunked.stabilize_chunk_streams(states, chunk, params)
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
        rms, max_err = known_motion_error(meas, ok, poses)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from video_stabilizer_tpu_torch.config import StabilizerParams

    dev = torch.device("cuda")
    smi = nvidia_smi()
    log(f"card: {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    if not build_kernels():
        log("chip_smoke: FAILED (the kernels did not build)")
        return 1

    params = StabilizerParams(crop_pixels=32)
    synth_on_card(dev)
    cap = capture(params, dev)
    kernels = []
    if cap is not None:
        kernels = [check_warp(cap, params.crop_pixels, dev), check_gn(cap)]
        del cap
    t0 = time.perf_counter()
    frames, poses = synth_streams(dev, CHUNK * CHUNKS, MAIN_CONTENT)
    log(f"== main path's clip {frames.shape} in "
        f"{time.perf_counter() - t0:.1f} s")
    main = main_path(frames, poses, params, dev)
    del frames
    launches = None
    if main is not None:
        launches, states, last_chunk = main
        profile_chunk(states, last_chunk, params)
        del states, last_chunk
    wide_jitter(params, dev)
    small_reference(dev)

    if failures or launches is None or None in kernels:
        log("chip_smoke: FAILED:\n  " + "\n  ".join(failures))
        return 1
    for k in kernels:
        k["launches"] = launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in kernels]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
