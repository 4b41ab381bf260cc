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
 5F. Kernel B in its fixed-iteration mode (``fixed_iters`` = K: exactly K
     iterations, converged = the last step moved no corner by the
     threshold) against its plain version on phase 5's items at K = 1 and
     4: converged equal, iters == K on every item, A/B 1e-5, TX/TY 1e-3
     px, two launches bit-identical; wrapper and device time per level.
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
 8C. 4K content: a chunk of 2 streams x 16 frames through the 4K path from
     a fresh state, stream 0 a moving perspective sequence (each frame the
     previous one warped by a known homography with p6/p7 != 0, through
     kernel A's homography form): kernel C against its plain version at
     all 7 levels to phase 8's bars, the perspective check on stream 0's
     items. The same content through the 4K similarity path: kernel B at
     its 7 levels to phase 5's bars.
  9. The 1080p similarity path, timed, on bench.py's content (translation
     only, 1 px jitter): 4 chunks with carried state from a fresh start,
     first un-captured (``utils.graphs.eager()``) under the span recorder
     for the stage table, then through ``stabilize_chunk_streams``, which
     replays the captured chunk (its first call captures), with every
     launch count set to 0 before and read after. Checks the output
     shape, the replays, the align success rate (>= 0.9) and the measured
     motion against the clip's known motion. One more chunk, replayed,
     runs under torch.profiler.
 9T. Phase 9's run with ``selection="topk"`` (the exact-count keypoint
     selection): the same checks, its stage table beside phase 9's.
 9F. The FIR output warp (``output_warp="fir"``, ops/fast_warp.py)
     against the gather oracle (ops/warp.py) on phase 9's 128 delayed
     frames and corrections and on 8 of them at integer translations
     (bit-exact), subpixel translations (<= 1 LSB) and rotation / zoom
     within the envelope (<= 2 LSB on > 99.9 %); timed beside kernel A and
     grid_sample on the 128 frames.
 J1. The 1080p chunk of phase 9's clip through the captured entry point
     against the un-captured composition, on the same pinned inputs from
     the same fresh state: the un-captured path runs twice (any output in
     which it differs from itself is held to phase 9's bars instead);
     outputs, meas, succ, valid and the carried state byte-equal; the
     first chunk's returned values unchanged after the later chunks ran.
     Prints the capture and instantiate time, the graph pool's bytes, the
     peak memory, the replayed chunk's host-clock time over 20 chunks
     (median, min, max, spread) beside the un-captured chunks' of the
     phase, the device-busy share and the copies of 3 replays under
     torch.profiler, and the launches per replay.
 10. The 4K homography path, timed, the same way: 4 chunks on
     bench_configs' content (seeds 5 and 6), kernel C's and kernel A's
     homography + Lanczos2 counts > 0 and kernel B's 0, success >= 0.9,
     p2*W, p5*W against the known motion; one more chunk under the
     profiler.
10F. The FIR warp's homography + Lanczos2 form against the gather oracle
     on phase 10's 32 delayed frames and corrections and on 4 frames with
     random homographies within the envelope (<= 2 LSB on > 99.9 %); timed
     beside kernel A.
 J2. J1 for the 4K config 4 chunk (cuFFT, kernel C, kernel A's
     homography + Lanczos2 form), the replay timed over 8 chunks.
 J5. The clip path: ``stabilize_streams`` (``_stabilize_streams_jit``) on
     the first 32 frames of phase 9's 8 streams, the clip on the card
     before the call (the upload timed apart). The un-captured call twice
     (an output in which it differs from itself is held to phase 9's bars
     instead), then the first call (eager run and capture) and 5 replays:
     outputs, meas and success byte-equal to the un-captured call, the
     first call's values unchanged after the replays; kernels A and B
     launched in every replay. Prints the first call's, the capture's and
     the instantiation's time, the graph pool, the peak memory, the
     launches per replay and the replays' median and spread beside the
     un-captured time.
 J6. J5 for ``stabilize_streams_homography`` on the first 32 frames of
     phase 10's 2 4K streams (config 4: cuFFT, kernel C, kernel A's
     homography + Lanczos2 form).
 J9. The clip programs' memory, and the programs J5-J8 do not run on the
     card. (a) ``stabilize_streams`` on the first 32, 24 and 16 frames of
     phase 9's 8 streams in a row, then the 16 once more: the program
     keeps one key after each call (a new length drops the last one's
     graph and pool), the card holds no more than that key's pool and
     static input (+ 0.25 GB) after each call once its cache is emptied,
     and the last call replays. (b) ``stabilize_streams`` with
     ``output_warp="fir"`` (the FIR warp inside the clip program) on 2
     streams x 32 frames, (c) the smoother sweep's ``eval_combos`` on its
     app's default clip (60 frames of 360x640, seed 4; lag 10, memory 5,
     its 12 combos), after the app's one align, (d) ``median_flow_px``
     called alone on 8 1080p pairs: each as J5, with 2 or 3 replays.
 11. Reported, no bar: one chunk of 4 px jitter content through kernel B
     and through its plain version (un-captured, so the patched engine
     runs), with convergence and known-motion
     error for each. Each item whose converged flag differs between the
     two runs is named (stream, frame, level), and on each run's inputs of
     that level both engines' own loops and their per-iteration max corner
     moves (fixed mode, K = 1 .. max_iters) are printed side by side.
 G2. Kernel C with one threshold per item, drawn from 0.01 / 0.02 /
     0.04 px, against its plain version on phase 8's captured and
     perspective items at all 7 levels: phase 8's bars (the p6/p7 check on
     the items whose engines ran the same iterations), two launches
     bit-identical, times and bound of the captured items.
 G1. The aligner sweep at 1080p: apps/grid_search_align's 27 combos
     (threshold 0.01 / 0.02 / 0.04 x fraction 0.7 / 0.8 / 0.9 x
     max_displacement 5 / 10 / 20, window margin widened to 22) on 32
     frames of bench.py's content (seed 100) through ``align_clip_impl``
     with (27,) DynAlignParams, launch counts set to 0 before and read
     after (kernel B once per level for all 27 x 32 items). (a) Kernel B
     with per-item thresholds against its plain version at every level:
     converged equal; phase 5's bars on the items whose engines ran the
     same iterations (not the A/B >= 10x check: translation-only content);
     the items that stopped one iteration apart (at most 1 % of a level)
     straddle their threshold, the plain engine's move at the deciding
     step within 10 % of it; fewer iterations at 0.04 px than at 0.01 px.
     (b) Each combo run alone with those values in its AlignerParams: ok
     equal on every frame, measurements within phase 5's bars, the
     bit-equal combos counted.
     (c) The sweep's align time beside the 27 runs alone, and
     ``_align_clip_jit`` with the (27,) dyn as an input: its first call
     and 5 replays byte-equal to the un-captured sweep, timed; the
     smoother sweep's one align (no dyn, default parameters), a one-shot
     call: its first call beside the un-captured time, byte-equal. (d)
     The FIR warp and ``median_jitter_px_device_impl`` over all combos'
     outputs, un-captured and timed; the best combo's out/in jitter ratio
     below 0.6.
 J7. ``run_combos`` (align, accumulate and FIR warp) on G1's inputs: the
     un-captured call twice, the first call and 3 replays, outputs, meas
     and ok byte-equal; timed beside G1's un-captured align and FIR.
 J8. ``median_jitter_px_device_impl`` on J7's outputs (27 x 21 1080p
     pairs): the un-captured call twice, the first call and 3 replays,
     byte-equal f32, the out/in ratios equal G1 (d)'s; timed.
 G2 path. 8 frames of config 4's content through ``align_clip_impl`` with
     model="homography" and the three thresholds as (3,) DynAlignParams,
     launch counts set to 0 before and read after: kernel C once per level,
     kernel B never; the 0.02 px combo against the run without ``dyn``: ok
     equal, >= 6 of 7 frames aligned.
 G3. The apps' pipeline at 1080p without cv2: 32 frames of bench.py's
     content written as a .y4m, read back bit-equal through
     ``utils.io.read_video`` (the native Y4M reader, built by ``make -C
     native``), stabilized by apps/video_test's ``stabilize_streaming``,
     ``stabilize_chunked`` and ``stabilize_batch`` (crop 0), each scored
     with ``median_jitter_px_device``: 22 outputs, output jitter < 0.6x
     the input's, align failures printed; the batch mode, a one-shot call
     of ``_stabilize_clip_jit`` (``_stabilize_streams_jit`` on one
     stream), once more un-captured: byte-equal, its time beside the first
     call's. Nothing is written as mp4.
 12. The port on the card against the port on the CPU (the plain versions)
     on a small clip: ok equal, >= 99 % of output pixels within 1 LSB.
 S1. The streaming path, timed: ``VideoStabilizer`` (crop 32, defaults
     otherwise: lag 10, smoother memory 5, bilinear) over 48 frames of one
     1080p stream of bench.py's content (seed 100) from a fresh state,
     twice: un-captured under the span recorder (the stage table), then
     through its replayed graphs (``_to_gray``, ``_align_next_frame_impl``,
     ``_smooth_window``, ``_warp_fn``; the first call of each key
     captures), each with every launch count set to 0 before and read
     after. Checks 38
     outputs of (1016, 1856, 3) u8, align success >= 0.9 of the 47
     alignable frames, TX/TY against the known motion (phase 9's bars),
     and the launches: kernel A once per output, kernel B once per level
     of every frame (the first frame runs the level loop, as in the JAX
     package), kernel C never. Prints the per-frame latency (host clock up
     to each frame's sync; median and p90 of frames 12-47) and the
     per-frame stage table from the spans; then 8 more frames, replayed,
     run under torch.profiler (device busy share).
 J3. A third fresh ``VideoStabilizer`` over S1's frames with every key
     already captured: no new capture; the outputs, measurements and
     flags of both replayed runs byte-equal to S1's un-captured run; the
     per-frame median and p90 over frames 12-47 beside the un-captured
     run's.
 S2. Streaming vs chunked on the card: S1's first 32 frames against
     ``stabilize_stream_chunked`` (16-frame chunks): ok equal,
     measurements within 1e-5, >= 99.5 % of output pixels within 1 LSB
     (the JAX package's bars, test_batch.py:28-83).
 S5. S1's clip and checks with ``AlignerParams(fixed_iters=4)`` (kernel
     B's fixed mode, the card's counterpart of bench_latency's ``_fixed4``):
     per-frame median and p90, AlignNextFrame, success and known-motion
     error printed beside S1's.
 S3. Kernel A's and B's inputs captured from 4 frames of a 1080p stream
     with rotation and zoom (after ``lag`` frames from a fresh state,
     un-captured so that the spies see the wrappers' calls):
     kernel B at one item per launch at the six levels (phase 5's bars,
     the items' A/B >= 10x the A/B bar too; two launches bit-identical;
     wrapper and device time per level) and kernel A at one frame per
     launch (max 1 LSB, >= 99.9 % equal), with ``grid_sample`` on one
     frame as the yardstick.
 S4. The streaming path on the card against the CPU on a small clip
     (96x128, 20 frames): ok equal, >= 99 % of pixels within 1 LSB.
 P1. ``python -m video_stabilizer_tpu_torch.bench`` at its defaults (8
     streams x 16 1080p frames, 4 reps x 4 chunks), in this process: its
     JSON line parses with its metric string and the card's name, the
     align success >= 0.9, and the launch counts show kernels A and B
     launched, C not.
 P2. ``apps/bench_configs.py``'s ``bench_4k`` at 2 streams, 3 reps:
     kernels A and C launched, B not; success >= 0.9 on the frames after
     each stream's first.
 P3. The latency modes, shortened: ``bench_latency`` (chain 16, 3 reps;
     the chain replayed as one captured graph),
     ``bench_latency_chunk2`` (chain 8, 3 reps) and
     ``bench_latency_request`` (20 samples): each line parses, each value
     positive and finite.
 J4. ``apps/bench_configs.py --mode latency`` at chain 32, 5 reps: the
     JAX tool's ``run_chain``, 32 align steps captured as one graph
     (``bench_configs.run_chain``: 1 capture, 5 replays, kernel B's
     launches counted through them); prints its p50 beside the same steps
     issued one call each.
 P4. ``apps/profile_chunk.py`` on one un-captured 1080p chunk (a replayed
     graph has no Python frames): its per-kernel table
     names kernel A's and B's symbols, ``--parse-only`` reprints the same
     totals from the saved trace, and ``--by-source`` puts over 90 % of
     the device time on frames under ``video_stabilizer_tpu_torch/``.
 P5. The scale-out modules on the card: ``graft_entry.entry()``,
     ``dryrun_multichip(1)``, a sharded chunk on the one-card mesh
     byte-equal to the unsharded call on the same 2 1080p streams (outputs
     and carried state), ``stabilize_streams_sharded`` on those 2 x 32
     frames twice (a capture of the card's ``_stabilize_streams_jit``, then
     a replay) byte-equal to the un-captured clip, and
     ``apps/multihost_smoke`` (CPU, gloo) as a subprocess.

After each phase every program's graphs but the streaming programs' are
dropped (a chunk graph holds a memory pool of 8.76 GB); the streaming
programs' stay. Every
phase runs; the script exits 1 if any failed, 2 without a card. On
success it prints the per-stage times, one ``{"kernels": [...]}`` line
(nine entries: kernel A's two chunked forms and its one-frame form, B per
chunk, at one item, in its fixed mode at K = 4 (S5's launches) and with
per-item thresholds (G1's launches), C per chunk and with per-item
thresholds (the G2 path's launches)), the
card's name and power limit, and as its last line ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
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
                release_graphs()
                log(f"   ({time.perf_counter() - t0:.1f} s)")
        return run
    return deco


def release_graphs():
    """Drop every program's captured graphs after a phase but the streaming
    programs': a chunk, clip, sweep or metric graph holds its own memory
    pool (8.76 GB for an 8-stream 1080p or a 2-stream 4K chunk), and the
    phases run dozens of configurations. The streaming programs' pools are
    small (under 0.1 GB each) and stay, so that the streaming phases replay
    graphs the earlier ones captured."""
    from video_stabilizer_tpu_torch.models import aligner, smoother, stabilizer
    from video_stabilizer_tpu_torch.utils import graphs
    streaming = (aligner._align_next_frame_impl, smoother._smooth_window,
                 stabilizer._to_gray, stabilizer._warp_fn)
    graphs.reset([p for p in graphs.PROGRAMS if p not in streaming])


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
    the keyframes in use read once (the item's float32 threshold
    included), each output written once. Both kernels take (windows,
    key_index, tmpl, jac_masked, hinv, two (K, 2, N) keypoint coordinates,
    ox, oy, initial transform) and a threshold per item."""
    windows, key_index, *per_item = args[:5]
    fx, fy, ox, oy, t_init = args[5:10]
    k, p, _, n = windows.shape
    iters_per_key = torch.zeros(k, dtype=torch.float64,
                                device=iters.device).index_add_(
        0, key_index.long(), iters.double())
    taps = float(torch.clamp(iters_per_key * 2 * n * 16, max=p * p * n).sum())
    keys = int(torch.unique(key_index).numel())
    item_bytes = sum(a.numel() * a.element_size()
                     for a in (key_index, *per_item, t_init)) \
        + t_init.shape[0] * 4
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
        f"{totals['ms']:.4f} ms (device {totals['device_ms']:.4f} ms; "
        f"0.549-0.577 ms on an NVIDIA H100 80GB HBM3 at 700 W with the "
        f"threshold a launch argument, PERF.md section 6), plain "
        f"{totals['plain_ms']:.3f} ms, bound {totals['bound_ms']:.4f} ms")
    return dict(name="gn_solve", route="cuda",
                source="video_stabilizer_tpu_torch/csrc/gn_solve.cu",
                replaces=GN_REPLACES, max_abs_err=worst, ms=totals["ms"],
                device_ms=totals["device_ms"], plain_ms=totals["plain_ms"],
                bound_ms=totals["bound_ms"],
                bound_by=max(bound_share, key=bound_share.get),
                library_ms=None)


def gn_compare(args, kw, level, ab_check=True):
    """Kernel B against its plain version on one level's items, phase 5's
    bars: converged equal, A/B within GN_AB_BAR, TX/TY within GN_T_BAR px,
    two launches bit-identical, and (``ab_check``) the items' A/B median at
    least 10x the A/B bar. Returns (the kernel's outputs, the largest
    gap)."""
    from video_stabilizer_tpu_torch.ops.gn_solve import (
        gn_solve, gn_solve_plain)

    got = gn_solve(*args, **kw)
    want = gn_solve_plain(*args, **kw)
    (t_g, c_g, _, i_g), (t_w, c_w, _, i_w) = got, want
    d_ab = float((t_g[:, :2] - t_w[:, :2]).abs().max())
    d_t = float((t_g[:, 2:] - t_w[:, 2:]).abs().max())
    same_conv = bool((c_g == c_w).all())
    for i in torch.nonzero(c_g != c_w).flatten().tolist():
        log(f"    item {i}: converged {bool(c_g[i])} (kernel) vs "
            f"{bool(c_w[i])} (plain), iters {int(i_g[i])} vs {int(i_w[i])}")
    check(same_conv and d_ab <= GN_AB_BAR and d_t <= GN_T_BAR,
          f"{level}: converged equal on all items {same_conv}; |dA,dB| "
          f"{d_ab:.2e} (bar {GN_AB_BAR:.0e}), |dTX,dTY| {d_t:.2e} px (bar "
          f"{GN_T_BAR:.0e}), |d iters| {int((i_g - i_w).abs().max())}; mean "
          f"iters {float(i_g.float().mean()):.2f}, converged "
          f"{float(c_g.float().mean()) * 100:.1f} %")
    if ab_check:
        ab = t_w[:, :2].abs().amax(dim=1)
        check(float(ab.median()) >= 10 * GN_AB_BAR,
              f"{level}: the items' max(|A|,|B|) has median "
              f"{float(ab.median()):.2e} and max {float(ab.max()):.2e}, "
              f">= 10x the A/B bar")
    check(deterministic(lambda: gn_solve(*args, **kw)),
          f"{level}: two launches give bit-identical outputs")
    return got, max(d_ab, d_t)


# The counts of kernel B's fixed-iteration mode held to its plain version;
# the last is the streaming latency mode of S5 and the kernels line.
FIXED_KS = (1, 4)
FIXED_NAME = f"gn_solve[fixed {FIXED_KS[-1]}]"


@phase("kernel B in fixed-iteration mode vs its plain version (the six "
       "1080p levels, K = 1 and 4)")
def check_gn_fixed(cap):
    """Phase 5's items and bars with ``fixed_iters`` = K: converged (the
    last step moved no corner by the threshold) equal, iters == K on every
    item, A/B 1e-5, TX/TY 1e-3 px, two launches bit-identical; per level
    the wrapper's time between CUDA events and the device time (CUDA
    graph) at each K. Returns the kernels line's entry at the last K."""
    from video_stabilizer_tpu_torch.ops.gn_solve import (
        OPS_PER_SAMPLE, gn_solve, gn_solve_plain)

    calls = cap["gn_calls"]
    worst, entry = 0.0, None
    for k in FIXED_KS:
        totals = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0)
        bound_share = dict(bytes=0.0, operations=0.0)
        for args, kw in calls:
            kwf = dict(kw, fixed_iters=k)
            p, n = args[0].shape[1], args[0].shape[3]
            level = (f"K={k} {kw['width']}x{kw['height']} (P={p}, N={n}, "
                     f"{args[-1].shape[0]} items)")
            (t_g, _, _, i_g), gap = gn_compare(args, kwf, level,
                                               ab_check=False)
            worst = max(worst, gap)
            i_w = gn_solve_plain(*args, **kwf)[3]
            check(bool((i_g == k).all()) and bool((i_w == k).all()),
                  f"{level}: iters == {k} on every item, both engines")
            ms = cuda_ms(lambda: gn_solve(*args, **kwf), 20)
            device_ms = graph_ms(lambda: gn_solve(*args, **kwf), 20)
            plain_ms = cuda_ms(lambda: gn_solve_plain(*args, **kwf), 2)
            bytes_moved = gn_bytes(args, t_g, i_g)
            ops = int(i_g.sum()) * 2 * n * OPS_PER_SAMPLE
            bound_ms, bound_by = roofline(bytes_moved, ops)
            bound_share[bound_by] += bound_ms
            log(f"    kernel {ms:.4f} ms (device {device_ms:.4f} ms), plain "
                f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            for key, val in (("ms", ms), ("device_ms", device_ms),
                             ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
                totals[key] += val
        log(f"  K={k}, per chunk (sum of {len(calls)} levels): kernel "
            f"{totals['ms']:.4f} ms (device {totals['device_ms']:.4f} ms), "
            f"plain {totals['plain_ms']:.3f} ms, bound "
            f"{totals['bound_ms']:.4f} ms")
        entry = dict(name=f"gn_solve[fixed {k}]", route="cuda",
                     source="video_stabilizer_tpu_torch/csrc/gn_solve.cu",
                     replaces=GN_REPLACES, ms=totals["ms"],
                     device_ms=totals["device_ms"],
                     plain_ms=totals["plain_ms"],
                     bound_ms=totals["bound_ms"],
                     bound_by=max(bound_share, key=bound_share.get),
                     library_ms=None)
    entry["max_abs_err"] = worst
    return entry


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


# Per-frame homography of the moving perspective stream: random steps
# within these bounds (p0, p1, p3, p4; p2, p5 normalized by W; p6, p7),
# with |p6|, |p7| at least half their bound.
PERSP_STEP = (1e-3, 1e-3, 2.0 / W4K, 1e-3, 1e-3, 2.0 / W4K, 2e-3, 2e-3)


def perspective_stream(first, steps):
    """(T, H, W, 3) u8 frames on the card: ``first``, then each frame the
    previous one warped by the next (8,) homography of ``steps`` through
    kernel A's homography + Lanczos2 form (as capture_4k builds its
    pairs)."""
    from video_stabilizer_tpu_torch.ops.warp_kernel import warp_frames
    seq = [first]
    for p in steps:
        seq.append(warp_frames(seq[-1][None].contiguous(), p[None], 0,
                               interp="lanczos2", model=HOMOGRAPHY)[0])
    return torch.stack(seq)


@phase("4K content: kernel C on a moving perspective stream, kernel B at "
       "4K (similarity)")
def check_4k_content(params_4k, dev):
    """A 4K chunk of 2 streams x 16 frames through the 4K path (fresh
    state), stream 0 a moving perspective sequence (``perspective_stream``,
    p6/p7 != 0 in every step), stream 1 bench_configs' content with
    rotation and zoom: kernel C against its plain version at all 7 levels,
    phase 8's bars (converged equal, corner gap <= 0.02 px, the
    perspective items' median max(|p6|,|p7|) >= 10x the largest p6/p7
    gap, bit-identical launches). Then the same content (stream 0 its own
    seed's frames) through the 4K similarity path: kernel B against its
    plain version at its 7 levels, phase 5's bars."""
    from video_stabilizer_tpu_torch.config import StabilizerParams
    from video_stabilizer_tpu_torch.models import aligner, chunked
    from video_stabilizer_tpu_torch.models import homography_aligner as ha
    from video_stabilizer_tpu_torch.ops.gn8_solve import (
        gn8_solve, gn8_solve_plain)
    from video_stabilizer_tpu_torch.ops.gn_solve import gn_solve

    host, _ = synth_streams(dev, CHUNK, GN_CONTENT, H4K, W4K, SEEDS_4K)
    frames = torch.as_tensor(host).to(dev)
    g = torch.Generator().manual_seed(SEED + 4)
    bound = torch.tensor(PERSP_STEP)
    steps = (torch.rand((CHUNK - 1, 8), generator=g) * 2 - 1) * bound
    sign = torch.where(steps[:, 6:] < 0, -1.0, 1.0)
    steps[:, 6:] = sign * (0.5 + 0.5 * torch.rand((CHUNK - 1, 2),
                                                  generator=g)) * bound[6:]
    persp = frames.clone()
    persp[0] = perspective_stream(frames[0, 0], steps.to(dev))
    states = chunked.init_stream_state(W4K, H4K, params_4k, 3, 2, dev,
                                       model=HOMOGRAPHY)
    with mock.patch.object(ha, "gn8_solve", wraps=gn8_solve) as spy:
        chunked.stabilize_chunk_core(states, persp, params_4k, W4K, H4K,
                                     HOMOGRAPHY)
    calls = [(c.args, c.kwargs) for c in spy.call_args_list]
    del persp
    levels = len(aligner.level_specs(W4K, H4K, params_4k.aligner))
    check(len(calls) == levels,
          f"{len(calls)} kernel C launches ({levels} levels)")
    # Stream 0's items but its first (frame 0 against the zero keyframe).
    persp_items = torch.arange(1, CHUNK, device=dev)
    for args, kw in calls:
        w, h = kw["width"], kw["height"]
        level = f"4K content {w}x{h} (N={args[0].shape[3]})"
        p_g, c_g, _, i_g = gn8_solve(*args, **kw)
        p_w, c_w, _, i_w = gn8_solve_plain(*args, **kw)
        same = bool((c_g == c_w).all())
        gap = float(corner_gap(p_g, p_w, w, h).max())
        p67_gap = float((p_g[:, 6:] - p_w[:, 6:]).abs().max())
        median = float(p_w[persp_items, 6:].abs().amax(dim=1).median())
        check(same and gap <= GN8_CORNER_BAR,
              f"{level}: converged equal {same}; corner gap {gap:.2e} px "
              f"(bar {GN8_CORNER_BAR:.0e}); |d iters| "
              f"{int((i_g - i_w).abs().max())}; converged "
              f"{float(c_g.float().mean()) * 100:.1f} %")
        check(median >= 10 * p67_gap,
              f"{level}: the perspective stream's max(|p6|,|p7|) has median "
              f"{median:.2e}, >= 10x the largest p6/p7 gap {p67_gap:.2e}")
        check(deterministic(lambda: gn8_solve(*args, **kw)),
              f"{level}: two launches give bit-identical outputs")
    del calls

    params = StabilizerParams(crop_pixels=32)
    states = chunked.init_stream_state(W4K, H4K, params, 3, 2, dev)
    with mock.patch.object(aligner, "gn_solve", wraps=gn_solve) as spy:
        chunked.stabilize_chunk_core(states, frames, params, W4K, H4K)
    calls = [(c.args, c.kwargs) for c in spy.call_args_list]
    check(len(calls) == levels,
          f"{len(calls)} kernel B launches at 4K ({levels} levels)")
    for args, kw in calls:
        gn_compare(args, kw, f"4K similarity {kw['width']}x{kw['height']} "
                   f"(N={args[0].shape[3]}, {args[-1].shape[0]} items)")


def drive_path(frames, params, dev, model="similarity"):
    """Drive a chunked path over every chunk of ``frames`` (S, T, H, W, 3)
    from a fresh state, twice: un-captured (``graphs.eager()``) under a
    span Recorder, for the per-stage device times; then through the entry
    point, which on the card replays the captured chunk (its first call
    captures), with every launch count set to 0 just before and read just
    after. Checks each replayed chunk's output; prints both runs' chunk
    times, frames/s, peak memory and the stage table. Returns (launch
    counts, meas (S, T, P), ok (S, T), states, last chunk, stages)."""
    from video_stabilizer_tpu_torch.models import chunked
    from video_stabilizer_tpu_torch.utils import graphs
    from video_stabilizer_tpu_torch.utils.spans import Recorder

    streams, total, height, width = frames.shape[:4]
    # Each chunk arrives in its own pinned host buffer, as a server's
    # decoder would leave it; filling the buffers is set-up, not timed.
    chunks = [torch.from_numpy(np.ascontiguousarray(
        frames[:, c:c + CHUNK])).pin_memory()
        for c in range(0, total, CHUNK)]

    # The stages, from the un-captured chunk: a replay runs no span.
    states = chunked.init_stream_state(width, height, params, 3, streams,
                                       dev, model=model)
    eager_walls, stage_runs = [], []
    with graphs.eager():
        for chunk in chunks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with Recorder() as rec:
                states = chunked.stabilize_chunk_streams(states, chunk,
                                                         params, model)[0]
            torch.cuda.synchronize()
            eager_walls.append((time.perf_counter() - t0) * 1e3)
            stage_runs.append(rec.totals())

    states = chunked.init_stream_state(width, height, params, 3, streams,
                                       dev, model=model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    walls, device_ms, metas, succs = [], [], [], []
    for c, chunk in enumerate(chunks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        states, out, meas, succ, valid = chunked.stabilize_chunk_streams(
            states, chunk, params, model)
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))
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
    prog = chunked._stabilize_chunk_streams_jit
    check(prog.replays == len(chunks) - 1,
          f"the entry point replayed the captured chunk {prog.replays} "
          f"times (want {len(chunks) - 1}: the first call captures)")

    log("  chunk wall through the entry point (host clock, synchronized; "
        "chunk 0 runs eagerly and captures): "
        + ", ".join(f"{w:.1f}" for w in walls) + " ms")
    log(f"  the same chunks on the device timeline (CUDA events): "
        + ", ".join(f"{w:.1f}" for w in device_ms) + " ms")
    log("  un-captured chunks (graphs.eager(), under the span recorder): "
        + ", ".join(f"{w:.1f}" for w in eager_walls) + " ms")
    steady = walls[1:]
    fps = streams * CHUNK / (np.mean(steady) / 1e3)
    log(f"  steady chunk {np.mean(steady):.1f} ms = {fps:.1f} frames/s "
        f"(replays, mean of chunks 1-{len(chunks) - 1}; un-captured "
        f"{np.mean(eager_walls[1:]):.1f} ms); peak device memory "
        f"{peak_gb:.2f} GB (the graph's pool included)")
    names = list(stage_runs[0])
    mean = {k: float(np.mean([r.get(k, 0.0) for r in stage_runs[1:]]))
            for k in names}
    log(f"  stage device times of the un-captured chunk, mean of chunks "
        f"1-{len(chunks) - 1} (CUDA events):")
    for k in names:
        log(f"    {k:<22} {mean[k]:9.3f} ms")
    log(f"    {'sum of stages':<22} {sum(mean.values()):9.3f} ms")
    log(f"  launches: {launches}")
    ok = np.concatenate(succs, axis=1)
    rate = float(ok.mean())
    check(rate >= 0.9, f"align success rate {rate:.4f} "
          f"({int(ok.sum())} of {ok.size}; each stream's first frame has "
          "nothing to align to)")
    mean["steady chunk (host clock)"] = float(np.mean(steady))
    mean["un-captured chunk (host clock)"] = float(np.mean(eager_walls[1:]))
    return (launches, np.concatenate(metas, axis=1), ok, states, chunks[-1],
            mean)


@phase("main path: 1080p similarity, 8 streams x 16-frame chunks, carried "
       "state")
def main_path(frames, poses, params, dev):
    launches, meas, ok, states, last, stages = drive_path(frames, params,
                                                          dev)
    check(launches.get("warp_frames[similarity,bilinear]", 0) > 0
          and launches["gn_solve"] > 0,
          "kernel A (similarity, bilinear) and kernel B launched")
    known_motion_checks(meas, ok, poses)
    return launches, states, last, stages


def known_motion_checks(meas, ok, poses):
    """Phase 9's bars on a translation-only 1080p clip's measurements."""
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


@phase("4K homography path: 2 streams x 16-frame chunks, carried state")
def main_path_4k(frames, poses, params, dev):
    launches, meas, ok, states, last, stages = drive_path(
        frames, params, dev, HOMOGRAPHY)
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
    return launches, states, last, stages


@phase("device busy share of one more chunk, replayed (torch.profiler)")
def profile_chunk(states, chunk, params, model="similarity"):
    from video_stabilizer_tpu_torch.models import chunked

    # The first call captures; the profiled one replays (the entry point
    # leaves its input state as it was).
    chunked.stabilize_chunk_streams(states, chunk, params, model)
    span_ms, by_name = device_events(
        lambda: chunked.stabilize_chunk_streams(states, chunk, params,
                                                model), 1)
    busy = sum(ms for ms, _ in by_name.values())
    if busy <= 0:
        log("  the profiler recorded no device time: busy share not "
            "measured")
        return
    log(f"  chunk {span_ms:.1f} ms on the device timeline (under the "
        f"profiler), kernels and copies {busy:.1f} ms: busy "
        f"{busy / span_ms * 100:.1f} %, idle "
        f"{(1 - busy / span_ms) * 100:.1f} %")
    log("  top device time by kernel:")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (ms, count) in top:
        log(f"    {ms:9.3f} ms  {count:6d}x  {name[:70]}")


def device_events(run, reps):
    """(span ms, {name: [ms, count]}) of ``reps`` calls of ``run()`` under
    torch.profiler (CUDA activity), from its raw device events: kernels,
    copies and memsets, each counted once. (The profiler's
    ``key_averages`` also gives each launching operator its kernels' time,
    so a sum over its rows counts a kernel twice.)"""
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            run()
        end.record()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            row = by_name.setdefault(e.name(), [0.0, 0])
            row[0] += e.duration_ns() / 1e6
            row[1] += 1
    return start.elapsed_time(end), by_name


J_STEADY = {"similarity": 20, HOMOGRAPHY: 8}   # J1's and J2's replays
J_PROFILED = 3                                 # replays under the profiler
J_OUTPUTS = ("outputs", "meas", "succ", "valid")


def leaves_equal(a, b) -> bool:
    from video_stabilizer_tpu_torch.parallel.mesh import tensor_leaves
    la, lb = tensor_leaves(a), tensor_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def within_bars(name, got, want) -> bool:
    """The bars of phases 9 and 10 for an output on which the un-captured
    path is not deterministic itself: outputs within 1 LSB on >= 99.9 %,
    measurements within 1e-3, flags equal."""
    if name == "outputs":
        d = (got.to(torch.int16) - want.to(torch.int16)).abs()
        return int(d.max()) <= 1 and float((d == 0).float().mean()) >= 0.999
    if name == "meas":
        return float((got - want).abs().max()) <= 1e-3
    return bool(torch.equal(got, want))


def captured_vs_eager(frames, params, dev, model="similarity"):
    """J1 / J2: the chunks of ``frames`` through the captured entry point
    against the un-captured composition (``graphs.eager()``), from the same
    fresh state on the same pinned inputs; then the replay's steady time,
    capture cost, memory, device-busy share and launches per replay."""
    from video_stabilizer_tpu_torch.models import chunked
    from video_stabilizer_tpu_torch.parallel.mesh import tensor_leaves
    from video_stabilizer_tpu_torch.utils import graphs

    prog = chunked._stabilize_chunk_streams_jit
    streams, total, height, width = frames.shape[:4]
    chunks = [torch.from_numpy(np.ascontiguousarray(
        frames[:, c:c + CHUNK])).pin_memory()
        for c in range(0, total, CHUNK)]

    def fresh():
        return chunked.init_stream_state(width, height, params, 3, streams,
                                         dev, model=model)

    eager, eager_walls = [], []
    for _ in range(2):
        states, outs = fresh(), []
        with graphs.eager():
            for c, chunk in enumerate(chunks):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                states, *res = chunked.stabilize_chunk_streams(
                    states, chunk, params, model)
                torch.cuda.synchronize()
                if c:
                    eager_walls.append((time.perf_counter() - t0) * 1e3)
                outs.append(res)
        eager.append((states, outs))
    unstable = [name for i, name in enumerate(J_OUTPUTS)
                if not all(torch.equal(a[i], b[i])
                           for a, b in zip(eager[0][1], eager[1][1]))]
    if not leaves_equal(eager[0][0], eager[1][0]):
        unstable.append("state")
    log(f"  the un-captured path run twice: "
        + (f"not deterministic in {unstable}" if unstable
           else "byte-equal in outputs, meas, succ, valid and state"))
    want_state, want = eager[0]
    del eager

    graphs.reset([prog])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    reset_launch_counts()
    states, got = fresh(), []
    for c, chunk in enumerate(chunks):
        states, *res = chunked.stabilize_chunk_streams(states, chunk, params,
                                                       model)
        got.append(res)
        if c == 0:
            first = [x.clone() for x in res]
    torch.cuda.synchronize()
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(prog.captures == 1 and prog.replays == len(chunks) - 1,
          f"{prog.captures} capture, {prog.replays} replays over "
          f"{len(chunks)} chunks (the first call captures)")
    for i, name in enumerate(J_OUTPUTS):
        pairs = [(g[i], w[i]) for g, w in zip(got, want)]
        if name in unstable:
            check(all(within_bars(name, g, w) for g, w in pairs),
                  f"{name}: within phase 9's / 10's bars of the un-captured "
                  "path (which is not deterministic there itself)")
        else:
            check(all(torch.equal(g, w) for g, w in pairs),
                  f"{name} of {len(chunks)} chunks byte-equal to the "
                  "un-captured path")
    if "state" not in unstable:
        check(leaves_equal(states, want_state),
              f"carried state ({len(tensor_leaves(states))} tensors) "
              "byte-equal to the un-captured path")
    check(all(torch.equal(a, b) for a, b in zip(first, got[0])),
          "chunk 0's returned values unchanged after chunks 1-"
          f"{len(chunks) - 1} ran")
    del got, want, want_state, first
    stats = prog.stats()[0]
    log(f"  capture: first call {stats['first_call_s']:.2f} s (eager "
        f"{stats['eager_s']:.2f} s, capture {stats['capture_s']:.2f} s, "
        f"instantiate {stats['instantiate_s']:.2f} s); graph pool "
        f"{stats['pool_bytes'] / 1e9:.2f} GB; peak device memory "
        f"{peak_gb:.2f} GB ({base_gb:.2f} GB held before the run)")
    per_replay = {(f"{k[0]}[{','.join(k[1])}]" if k[1] else k[0]): n
                  for k, n in stats["launches_per_replay"].items()}
    log(f"  launches per replay {per_replay}; this run's counts {launches}")

    n = J_STEADY[model]
    walls = []
    for k in range(n):
        t0 = time.perf_counter()
        states = chunked.stabilize_chunk_streams(
            states, chunks[k % len(chunks)], params, model)[0]
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    walls = np.asarray(walls)
    med, med_e = float(np.median(walls)), float(np.median(eager_walls))
    spread = (walls.max() - walls.min()) / med * 100
    log(f"  replayed chunk, host clock, each synchronized, {n} chunks: "
        f"median {med:.2f} ms, min {walls.min():.2f}, max {walls.max():.2f}, "
        f"spread (max - min) / median {spread:.1f} % = "
        f"{streams * CHUNK / med * 1e3:.1f} frames/s; "
        f"un-captured, same phase, {len(eager_walls)} chunks: median "
        f"{med_e:.1f} ms, min {min(eager_walls):.1f}, max "
        f"{max(eager_walls):.1f} ({med_e / med:.2f}x)")

    def replay():
        nonlocal states
        states = chunked.stabilize_chunk_streams(states, chunks[0], params,
                                                 model)[0]
    span, by_name = device_events(replay, J_PROFILED)
    busy = sum(ms for ms, _ in by_name.values())
    events = sum(n for _, n in by_name.values())
    copies = {}
    for name, (ms, _) in by_name.items():
        if name.startswith("Memcpy"):
            kind = name.split(" (")[0]
            copies[kind] = copies.get(kind, 0.0) + ms
    if busy > 0:
        log(f"  {J_PROFILED} replays under torch.profiler: {span:.1f} ms on "
            f"the device timeline, {events} device events, busy "
            f"{busy:.1f} ms = {busy / span * 100:.1f} % (the profiler slows "
            f"the replay; its device events, {busy / J_PROFILED:.1f} ms a "
            f"replay, are {busy / J_PROFILED / med * 100:.1f} % of the "
            f"unprofiled median); copies per replay "
            + ", ".join(f"{k} {v / J_PROFILED:.2f} ms"
                        for k, v in sorted(copies.items())))
    else:
        log("  the profiler recorded no device time: busy share not "
            "measured")
    return dict(median=med, eager=med_e, walls=walls)


@phase("J1. the captured 1080p chunk (8 streams x 16 frames) against the "
       "un-captured one, and its replay")
def captured_1080p(frames, params, dev):
    return captured_vs_eager(frames, params, dev)


@phase("J2. the captured 4K config 4 chunk (2 streams x 16 frames) against "
       "the un-captured one, and its replay")
def captured_4k(frames, params, dev):
    return captured_vs_eager(frames, params, dev, HOMOGRAPHY)


J_CLIP_FRAMES = 32        # J5's and J6's clips: phase 9's / 10's first 32
J_CLIP_REPLAYS = 5
J_CLIP_OUTPUTS = ("outputs", "meas", "succ")


def replay_figures(walls, eager_ms, frames=None) -> str:
    """Median, min, max and spread of replayed host-clock times beside the
    un-captured ones."""
    walls = np.asarray(walls)
    med, med_e = float(np.median(walls)), float(np.median(eager_ms))
    rate = f" = {frames / med * 1e3:.1f} frames/s" if frames else ""
    return (f"replayed, each synchronized, {len(walls)} calls: median "
            f"{med:.2f} ms, min {walls.min():.2f}, max {walls.max():.2f}, "
            f"spread (max - min) / median "
            f"{(walls.max() - walls.min()) / med * 100:.1f} %{rate}; "
            f"un-captured, same phase: "
            + ", ".join(f"{ms:.1f}" for ms in eager_ms)
            + f" ms ({med_e / med:.2f}x)")


def program_vs_eager(prog, run, names, replays):
    """A program's entry point ``run()`` against the same call inside
    ``graphs.eager()``: the un-captured call twice (an output in which it
    differs from itself is held to ``within_bars`` instead of byte
    equality), then
    the first call (eager run and capture) and ``replays`` replays, each
    against the un-captured results, from a reset program with the launch
    counts set to 0. Prints the capture's figures, the pool, the peak
    memory and the launches per replay; returns (the last replay's
    outputs, the replays' host ms, the un-captured ms)."""
    from video_stabilizer_tpu_torch.utils import graphs

    eager, eager_ms = [], []
    with graphs.eager():
        for _ in range(2):
            out, ms = timed(run)
            eager.append(out)
            eager_ms.append(ms)
    unstable = [n for n, a, b in zip(names, *eager) if not torch.equal(a, b)]
    log("  the un-captured call run twice: "
        + (f"not deterministic in {unstable}" if unstable
           else f"byte-equal in {', '.join(names)}"))
    want = eager[0]
    del eager

    def same(got):
        return all((within_bars(n, g, w) if n in unstable
                    else torch.equal(g, w))
                   for n, g, w in zip(names, got, want))

    graphs.reset([prog])
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    reset_launch_counts()
    first, first_ms = timed(run)
    first_copy = [x.clone() for x in first]
    ok_first = same(first)
    walls, ok_replays = [], True
    for _ in range(replays):
        out, ms = timed(run)
        walls.append(ms)
        ok_replays &= same(out)
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kind = "within the bars of the un-captured path where it is not " \
        "deterministic, byte-equal elsewhere" if unstable else "byte-equal"
    check(prog.captures == 1 and prog.replays == replays,
          f"{prog.name}: {prog.captures} capture, {prog.replays} replays")
    check(ok_first and ok_replays,
          f"{', '.join(names)} of the first call and of {replays} replays "
          f"{kind} to the un-captured call")
    check(all(torch.equal(a, b) for a, b in zip(first, first_copy)),
          "the first call's returned values unchanged after the replays")
    stats = prog.stats()[0]
    log(f"  first call {first_ms:.1f} ms (eager {stats['eager_s']:.2f} s, "
        f"capture {stats['capture_s']:.2f} s, instantiate "
        f"{stats['instantiate_s']:.2f} s); graph pool "
        f"{stats['pool_bytes'] / 1e9:.2f} GB; peak device memory "
        f"{peak_gb:.2f} GB ({base_gb:.2f} GB held before)")
    per_replay = {(f"{k[0]}[{','.join(k[1])}]" if k[1] else k[0]): n
                  for k, n in stats["launches_per_replay"].items()}
    log(f"  launches per replay {per_replay}; this run's counts {launches}")
    return out, walls, eager_ms, stats


def clip_vs_eager(frames, params, dev, model="similarity"):
    """J5 / J6: ``stabilize_streams`` (``stabilize_streams_homography``),
    which replay ``_stabilize_streams_jit``, on the first J_CLIP_FRAMES
    frames of every stream, captured and replayed, against the un-captured
    call on the same card clip."""
    from video_stabilizer_tpu_torch.models import batch, homography_aligner

    host = torch.from_numpy(np.ascontiguousarray(frames[:, :J_CLIP_FRAMES]))
    clip, up_ms = timed(lambda: host.to(dev))
    log(f"  the entry point's upload: {host.numel() / 1e6:.1f} MB pageable "
        f"host -> card in {up_ms:.1f} ms (before the call; the program "
        "copies the card clip into its static input)")
    if model == "similarity":
        def run():
            return batch.stabilize_streams(clip, params, dev)
    else:
        def run():
            return homography_aligner.stabilize_streams_homography(
                clip, params, dev)
    out, walls, eager_ms, stats = program_vs_eager(
        batch._stabilize_streams_jit, run, J_CLIP_OUTPUTS, J_CLIP_REPLAYS)
    streams, total = host.shape[:2]
    lag = params.lag
    check(tuple(out[0].shape) == (streams, total - lag,
                                  host.shape[2] - 2 * params.crop_pixels,
                                  host.shape[3] - 2 * params.crop_pixels, 3),
          f"output {tuple(out[0].shape)}; align success "
          f"{float(out[2][:, 1:].float().mean()):.3f}")
    need = "gn_solve" if model == "similarity" else "gn8_solve"
    per = stats["launches_per_replay"]
    check(any(k[0] == "warp_frames" and k[1] is None for k in per)
          and per.get((need, None), 0) > 0,
          f"kernel A and kernel {'B' if need == 'gn_solve' else 'C'} "
          "launched in every replay")
    log("  clip " + replay_figures(walls, eager_ms, streams * total))
    return walls


@phase("J5. the captured 1080p similarity clip (stabilize_streams, 8 streams "
       "x 32 frames) against the un-captured one, and its replay")
def clip_1080p(frames, params, dev):
    return clip_vs_eager(frames, params, dev)


@phase("J6. the captured 4K config 4 clip (stabilize_streams_homography, 2 "
       "streams x 32 frames) against the un-captured one, and its replay")
def clip_4k(frames, params, dev):
    return clip_vs_eager(frames, params, dev, HOMOGRAPHY)


J_LENGTHS = (32, 24, 16)  # J9 (a): three clip lengths in a row
J_HELD_SLACK = 0.25e9     # J9 (a): bytes held beyond the kept key's


@phase("J9. the clip programs' memory over three clip lengths in a row, and "
       "the programs J5-J8 do not run: the FIR warp inside the clip, "
       "eval_combos, median_flow_px alone")
def clip_programs(frames, params, dev):
    """See J9 in the module's docstring."""
    from video_stabilizer_tpu_torch.apps import grid_search_smoother as gss
    from video_stabilizer_tpu_torch.config import StabilizerParams
    from video_stabilizer_tpu_torch.models import batch
    from video_stabilizer_tpu_torch.utils import flow, graphs
    from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

    prog = batch._stabilize_streams_jit
    graphs.reset([prog])
    clip = torch.from_numpy(
        np.ascontiguousarray(frames[:, :J_LENGTHS[0]])).to(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_reserved()
    log(f"  (a) {clip.shape[0]} streams, lengths {J_LENGTHS} then "
        f"{J_LENGTHS[-1]} again; the card's reserved memory after each call "
        f"(its cache emptied) over the {base / 1e9:.2f} GB before:")
    held_ok = True
    for t in J_LENGTHS + J_LENGTHS[-1:]:
        out, ms = timed(lambda: batch.stabilize_streams(clip[:, :t], params,
                                                        dev))
        del out
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved() - base
        pool = prog.stats()[0]["pool_bytes"]
        static_in = clip[:, :t].numel()
        keys = len(prog.stats())
        held_ok &= keys == 1 and held <= pool + static_in + J_HELD_SLACK
        log(f"    T = {t}: {ms:.1f} ms; keys kept {keys}, captures "
            f"{prog.captures}, replays {prog.replays}, evictions "
            f"{prog.evictions}; held {held / 1e9:.2f} GB, the key's pool "
            f"{pool / 1e9:.2f} GB + static input {static_in / 1e9:.2f} GB")
    n = len(J_LENGTHS)
    check(held_ok and (prog.captures, prog.replays, prog.evictions)
          == (n, 1, n - 1),
          f"one key kept after each call, the card holding no more than its "
          f"pool and static input + {J_HELD_SLACK / 1e9:.2f} GB; {n} "
          f"captures, {n - 1} evictions, the repeated length replayed")
    del clip

    log("  (b) the FIR output warp inside the clip program:")
    fir = dataclasses.replace(params, output_warp="fir")
    clip = torch.from_numpy(
        np.ascontiguousarray(frames[:2, :J_LENGTHS[0]])).to(dev)
    out, walls, eager_ms, stats = program_vs_eager(
        prog, lambda: batch.stabilize_streams(clip, fir, dev),
        J_CLIP_OUTPUTS, 2)
    per = stats["launches_per_replay"]
    check(per.get(("gn_solve", None), 0) > 0
          and per.get(("warp_frames", None), 0) == 0,
          "kernel B launched in every replay, kernel A not (the FIR warps)")
    log("  FIR clip " + replay_figures(walls, eager_ms))
    del clip, out

    log("  (c) eval_combos on the smoother sweep's default clip:")
    h, w, t = 360, 640, 60
    small = torch.as_tensor(synth_shaky_clip(
        t, h, w, seed=4, jitter_px=1.0, pan_px_per_frame=0.3, device=dev),
        device=dev)
    gray = flow.gray_f32(small).round().to(torch.uint8)
    align = StabilizerParams().aligner
    with graphs.eager():
        want = batch._align_clip_jit(gray, align, w, h)
    (meas, ok), first_ms = timed(lambda: batch._align_clip_jit(gray, align,
                                                               w, h))
    check(torch.equal(meas, want[0]) and torch.equal(ok, want[1]),
          f"the app's one align, first call {first_ms:.1f} ms: byte-equal "
          "to the un-captured one")
    combos = list(itertools.product(gss.LAMBDAS, gss.DECAYS))
    lams = torch.tensor([c[0] for c in combos], device=dev)
    decays = torch.tensor([c[1] for c in combos], device=dev)
    pair = StabilizerParams(lag=10, smoother_memory=5)
    out, walls, eager_ms, _ = program_vs_eager(
        gss.eval_combos,
        lambda: (gss.eval_combos(small, meas, ok, pair, lams, decays),),
        ("outputs",), 2)
    check(tuple(out[0].shape) == (len(combos), t - pair.lag,
                                  h - 2 * gss.CROP, w - 2 * gss.CROP, 3),
          f"eval_combos output {tuple(out[0].shape)}")
    log(f"  eval_combos ({len(combos)} combos) "
        + replay_figures(walls, eager_ms))
    del small, out

    log("  (d) median_flow_px called alone:")
    gray = flow.gray_f32(torch.from_numpy(
        np.ascontiguousarray(frames[0, :9])).to(dev))
    prev, curr = gray[:-1], gray[1:]
    out, walls, eager_ms, _ = program_vs_eager(
        flow.median_flow_px, lambda: (flow.median_flow_px(prev, curr),),
        ("medians",), 3)
    check(tuple(out[0].shape) == (8,) and bool(torch.isfinite(out[0]).all()),
          f"8 pairs' medians, finite: {[round(float(x), 3) for x in out[0]]}")
    log("  median_flow_px over 8 pairs " + replay_figures(walls, eager_ms))


@phase("1080p similarity with selection='topk': 8 streams x 16-frame "
       "chunks, carried state")
def topk_path(frames, poses, params, dev, mask_stages):
    """Phase 9's run with the exact-count keypoint selection: the same
    checks, and its stage table beside phase 9's (histogram mask)."""
    launches, meas, ok, _, _, stages = drive_path(frames, params, dev)
    check(launches.get("warp_frames[similarity,bilinear]", 0) > 0
          and launches["gn_solve"] > 0,
          "kernel A (similarity, bilinear) and kernel B launched")
    known_motion_checks(meas, ok, poses)
    log("  stage device times, mean of chunks 1-3 (CUDA events), ms: "
        "histogram mask (phase 9) | topk")
    for k in stages:
        log(f"    {k:<26} {mask_stages.get(k, float('nan')):9.3f} "
            f"{stages[k]:9.3f}")
    for name, st in (("mask", mask_stages), ("topk", stages)):
        log(f"    select, all levels ({name}): "
            f"{sum(v for k, v in st.items() if k.startswith('select')):.3f}"
            " ms")
    select_op_times(params.aligner, dev)
    return launches


def select_op_times(aligner_params, dev):
    """The two selections alone, one after the other on the same warp
    diffs (integer-valued, so with ties), at each 1080p level's (items, 2,
    N) shape: each call's time between CUDA events, host launch overhead
    included. The chunk's stage times above move with the host's pace
    between runs; this compares the two ops within one stretch of it."""
    from video_stabilizer_tpu_torch.models.aligner import level_specs
    from video_stabilizer_tpu_torch.ops.select import (
        histogram_mask, topk_mask)

    g = torch.Generator().manual_seed(SEED + 7)
    rows = []
    for spec in level_specs(WIDTH, HEIGHT, aligner_params):
        n = spec.ht * spec.wt
        wd = torch.floor(torch.rand((STREAMS * CHUNK, 2, n), generator=g)
                         * 64).to(dev)
        frac = aligner_params.smallest_fraction
        rows.append((f"{spec.width}x{spec.height}",
                     cuda_ms(lambda: histogram_mask(wd, frac), 20),
                     cuda_ms(lambda: topk_mask(wd, frac), 20)))
    log(f"  the selection alone, ({STREAMS * CHUNK}, 2, N) warp diffs, ms "
        "per call: " + ", ".join(f"{lv} mask {m:.3f} topk {t:.3f}"
                                 for lv, m, t in rows)
        + f"; all levels mask {sum(r[1] for r in rows):.3f}, topk "
        f"{sum(r[2] for r in rows):.3f}")


def fir_oracle_gap(frames, ts, fir, oracle, group):
    """(max |diff| LSB, share within 1, share within 2) between the FIR
    warp and the gather oracle, ``group`` frames at a time."""
    worst, within1, within2, total = 0, 0, 0, 0
    for i in range(0, frames.shape[0], group):
        f, t = frames[i:i + group], ts[i:i + group]
        diff = (fir(f, t).to(torch.int16) - oracle(f, t).to(torch.int16)).abs()
        worst = max(worst, int(diff.max()))
        within1 += int((diff <= 1).sum())
        within2 += int((diff <= 2).sum())
        total += diff.numel()
    return worst, within1 / total, within2 / total


@phase("FIR output warp on the card (1080p, similarity + bilinear): against "
       "the gather oracle, timed beside kernel A and grid_sample")
def check_fir(states, chunk, params, dev):
    """``ops/fast_warp.warp_image_fast`` against ``ops/warp.warp_image_bgr``
    (zero border) at tests/test_fast_warp_oracle.py's bars: on phase 9's
    128 delayed frames with their corrections (<= 2 LSB on > 99.9 %); on 8
    of them at integer translations (bit-exact), at subpixel translations
    (<= 1 LSB) and at rotation / zoom within the envelope, |A,B| <= 0.0027
    (<= 2 LSB on > 99.9 %, at most 8). Then the FIR path of the pipeline
    (``batch._warp_frames`` with output_warp="fir", crop 32) timed on the
    128 frames beside kernel A and grid_sample."""
    from video_stabilizer_tpu_torch import transforms as T
    from video_stabilizer_tpu_torch.config import resolve_residual_bound
    from video_stabilizer_tpu_torch.models import batch, chunked
    from video_stabilizer_tpu_torch.ops.fast_warp import warp_image_fast
    from video_stabilizer_tpu_torch.ops.warp import warp_image_bgr
    from video_stabilizer_tpu_torch.ops.warp_kernel import warp_frames

    _, delayed, accums, *_ = chunked.stabilize_chunk_core(
        states, chunk.to(dev), params, WIDTH, HEIGHT)
    frames = delayed.reshape(-1, HEIGHT, WIDTH, 3).contiguous()
    ts = T.center_to_ul(accums, WIDTH, HEIGHT,
                        minus_one=True).reshape(-1, 4).contiguous()
    rb = resolve_residual_bound(params, WIDTH, HEIGHT)

    def fir(f, t):
        return warp_image_fast(f, t, residual_bound=rb)

    def oracle(f, t):
        return warp_image_bgr(f, t, border="zero")

    worst, w1, w2 = fir_oracle_gap(frames, ts, fir, oracle, 8)
    check(w2 > 0.999 and worst <= 8,
          f"{frames.shape[0]} frames, real corrections (|A,B| <= "
          f"{float(ts[:, :2].abs().max()):.1e}), residual bound {rb}: max "
          f"|diff| {worst} LSB, {w1 * 100:.4f} % within 1, {w2 * 100:.4f} % "
          "within 2")
    g = torch.Generator().manual_seed(SEED + 5)
    sub = frames[:8].contiguous()
    shifts = torch.randint(-150, 151, (8, 2), generator=g).float()
    zero = torch.zeros((8, 2))
    cases = {
        "integer translation": (torch.cat([zero, shifts], 1), 0, 0.0),
        "subpixel translation": (torch.cat(
            [zero, (torch.rand((8, 2), generator=g) * 2 - 1) * 30], 1), 1,
            0.0),
        "rotation / zoom, |A,B| <= 0.0027": (torch.cat(
            [(torch.rand((8, 2), generator=g) * 2 - 1) * 0.0027,
             (torch.rand((8, 2), generator=g) * 2 - 1) * 10], 1), 8, 0.999),
    }
    for name, (t, max_bar, share_bar) in cases.items():
        worst_c, _, w2_c = fir_oracle_gap(sub, t.to(dev), fir, oracle, 8)
        check(worst_c <= max_bar and (share_bar == 0.0 or w2_c > share_bar),
              f"{name} (8 frames): max |diff| {worst_c} LSB (bar "
              f"{max_bar}), {w2_c * 100:.4f} % within 2")
    del sub

    params_fir = dataclasses.replace(params, output_warp="fir")
    crop = params.crop_pixels
    fir_ms = cuda_ms(lambda: batch._warp_frames(frames, ts, params_fir, WIDTH,
                                                HEIGHT, "similarity"), 3)
    kernel_ms = cuda_ms(lambda: warp_frames(frames, ts, crop), 10)
    library_ms = grid_sample_ms(frames, ts, crop, 5)
    log(f"  {frames.shape[0]} frames, crop {crop}: FIR {fir_ms:.3f} ms, "
        f"kernel A {kernel_ms:.3f} ms, grid_sample {library_ms:.3f} ms; FIR "
        f"/ kernel A {fir_ms / kernel_ms:.1f}")


@phase("FIR output warp on the card (4K, homography + Lanczos2): against "
       "the gather oracle, timed beside kernel A")
def check_fir_4k(states, chunk, params, dev):
    """``ops/fast_warp.warp_homography_fast`` + Lanczos2 against the gather
    oracle (``ops/warp.warp_field_bgr`` on the homography's sample
    positions, zero border) on phase 10's 32 delayed frames with their
    corrections and on 4 of them with random homographies within the
    envelope (|p0,p1,p3,p4| <= 1e-3, |p6,p7| <= 2e-3, |t| <= 40 px):
    <= 2 LSB on > 99.9 %. Then the FIR path timed on the 32 frames beside
    kernel A."""
    from video_stabilizer_tpu_torch.config import resolve_residual_bound
    from video_stabilizer_tpu_torch.models import batch, chunked
    from video_stabilizer_tpu_torch.ops.fast_warp import (
        homography_field, warp_homography_fast)
    from video_stabilizer_tpu_torch.ops.warp import warp_field_bgr
    from video_stabilizer_tpu_torch.ops.warp_kernel import warp_frames

    _, delayed, accums, *_ = chunked.stabilize_chunk_core(
        states, chunk.to(dev), params, W4K, H4K, HOMOGRAPHY)
    frames = delayed.reshape(-1, H4K, W4K, 3).contiguous()
    ts = accums.reshape(-1, 8).contiguous()
    rb = resolve_residual_bound(params, W4K, H4K)

    def fir(f, p):
        return warp_homography_fast(f, p, interp="lanczos2",
                                    residual_bound=rb)

    def oracle(f, p):
        return warp_field_bgr(f, *homography_field(p, H4K, W4K),
                              interp="lanczos2", border="zero")

    for name, (f, p) in {
            "real corrections": (frames, ts),
            "random homographies": (frames[:4], (
                (torch.rand((4, 8), generator=torch.Generator().manual_seed(
                    SEED + 6)) * 2 - 1) * torch.tensor(
                    [1e-3, 1e-3, 40.0 / W4K, 1e-3, 1e-3, 40.0 / W4K, 2e-3,
                     2e-3])).to(dev))}.items():
        worst, w1, w2 = fir_oracle_gap(f, p, fir, oracle, 2)
        check(w2 > 0.999,
              f"{name} ({f.shape[0]} frames), residual bound {rb}: max "
              f"|diff| {worst} LSB, {w1 * 100:.4f} % within 1, "
              f"{w2 * 100:.4f} % within 2")
    params_fir = dataclasses.replace(params, output_warp="fir")
    crop = params.crop_pixels
    fir_ms = cuda_ms(lambda: batch._warp_frames(frames, ts, params_fir, W4K,
                                                H4K, HOMOGRAPHY), 2)
    kernel_ms = cuda_ms(lambda: warp_frames(frames, ts, crop,
                                            interp="lanczos2",
                                            model=HOMOGRAPHY), 10)
    log(f"  {frames.shape[0]} frames, crop {crop}: FIR {fir_ms:.3f} ms, "
        f"kernel A {kernel_ms:.3f} ms; FIR / kernel A "
        f"{fir_ms / kernel_ms:.1f}; no library call: grid_sample has no "
        "Lanczos2")


def one_item(args, item):
    """Kernel B's arguments cut to one item: key_index, tmpl, jac_masked,
    hinv and t_init are per item; the keyframes' operands stay."""
    one = list(args)
    for k in (1, 2, 3, 4, 9):
        one[k] = args[k][item:item + 1]
    return one


def item_kw(kw, item):
    """A GN launch's keyword arguments cut to one of its items: its own
    threshold, where the launch has one per item."""
    thr = kw["threshold"]
    if isinstance(thr, torch.Tensor) and thr.dim() == 1:
        return dict(kw, threshold=thr[item:item + 1])
    return kw


def permuted_keypoints(one):
    """The same item with its keypoints in another (seeded random) order:
    the same sums, added in another order."""
    n = one[0].shape[-1]
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(SEED))
    perm = perm.to(one[0].device)
    out = list(one)
    for k in (0, 2, 3, 5, 6, 7, 8):  # windows, tmpl, jac, fx, fy, ox, oy
        out[k] = one[k][..., perm].contiguous()
    return out


def step_sequence(solve, one, kw, steps):
    """Iterations 1 .. ``steps`` of ``solve`` on one item's arguments, each
    one step of its fixed-iteration mode from the transform the step before
    left (a GN step depends only on the transform it starts from). Returns
    (per step: the max corner move in px at the level's size, the GN
    corners of t_K against t_(K-1) in float64, and whether the engine's own
    float32 test found that step below the threshold), and t_steps."""
    from video_stabilizer_tpu_torch import transforms as T
    from video_stabilizer_tpu_torch.ops.gn_solve import gn_corners
    w, h = kw["width"], kw["height"]
    corners = gn_corners(w, h, one[0].device).double()

    def at(t):
        return T.warp_points_center(t.double()[:, None, :], corners, w * 0.5,
                                    h * 0.5)
    args = list(one)
    out = []
    for _ in range(steps):
        t_k, below, _, _ = solve(*args, **dict(kw, fixed_iters=1))
        out.append((float((at(t_k) - at(args[9])).norm(dim=-1).amax()),
                    bool(below[0])))
        args[9] = t_k
    return out, args[9]


def diagnose_item(item, name, args, kw):
    """Kernel B and its plain version on one item of one level, on the same
    inputs: their own loops (converged, iterations), and side by side the
    per-iteration max corner move of each (fixed mode, one step at a time
    up to max_iters), with the plain version on the keypoints in another
    order as a third column: the same arithmetic summed in another order.
    '*' marks a step the engine itself found below the threshold."""
    from video_stabilizer_tpu_torch.ops.gn_solve import (
        gn_solve, gn_solve_plain)
    one = one_item(args, item)
    kw = item_kw(kw, item)
    own = {}
    for ename, solve in (("kernel", gn_solve), ("plain", gn_solve_plain)):
        _, conv, d01, iters = solve(*one, **kw)
        own[ename] = (bool(conv[0]), int(iters[0]), float(d01[0]))
    log(f"      on the {name} run's inputs: kernel converged "
        f"{own['kernel'][0]} in {own['kernel'][1]}, plain "
        f"{own['plain'][0]} in {own['plain'][1]} iterations (max_iters "
        f"{kw['max_iters']}); "
        f"disp01 {own['kernel'][2]:.4f} / {own['plain'][2]:.4f} px")
    m = kw["max_iters"]
    seq_k, t_k = step_sequence(gn_solve, one, kw, m)
    seq_p, _ = step_sequence(gn_solve_plain, one, kw, m)
    seq_r, _ = step_sequence(gn_solve_plain, permuted_keypoints(one), kw, m)
    direct = gn_solve(*one, **dict(kw, fixed_iters=m))[0]
    log(f"      kernel fixed_iters={m} from the start equals its {m} single "
        f"steps bit for bit: {bool(torch.equal(direct, t_k))}")

    def first_gap(a, b, tol):
        return next((k + 1 for k, (x, y) in enumerate(zip(a, b))
                     if abs(x[0] - y[0]) > tol), None)

    for label, other in (("kernel vs plain", seq_k),
                         ("plain permuted vs plain", seq_r)):
        gaps = [abs(x[0] - y[0]) for x, y in zip(other, seq_p)]
        flips = [k + 1 for k, (x, y) in enumerate(zip(other, seq_p))
                 if x[1] != y[1]]
        log(f"      {label}: steps equal to 1e-6 px up to step "
            f"{(first_gap(other, seq_p, 1e-6) or m + 1) - 1}, largest gap "
            f"{max(gaps):.2e} px (step {gaps.index(max(gaps)) + 1}); "
            f"own stop test differs at steps {flips[:8]}")
    log("      step: kernel / plain / plain permuted (px; * below the "
        "threshold by the engine's own test)")
    for r in range(0, m, 3):
        log("        " + "  ".join(
            f"{k + 1:2d}: " + " / ".join(
                f"{seq[k][0]:.7f}{'*' if seq[k][1] else ' '}"
                for seq in (seq_k, seq_p, seq_r))
            for k in range(r, min(r + 3, m))))


@phase("1080p at 4 px jitter: one chunk with kernel B, one with its plain "
       "version")
def wide_jitter(params, dev):
    """Reported, with no bar: how the GN loop fares past bench.py's 1 px
    jitter, with the kernel and with its plain version (the reference's
    loop in PyTorch) on the same chunk. Each item whose converged flag
    differs between the two runs is named (stream, frame, level) and
    diagnosed (``diagnose_item``) on each run's own inputs of that level."""
    from video_stabilizer_tpu_torch.models import aligner, chunked
    from video_stabilizer_tpu_torch.ops.gn_solve import (
        gn_solve, gn_solve_plain)
    from video_stabilizer_tpu_torch.utils import graphs

    frames, poses = synth_streams(dev, CHUNK, WIDE_CONTENT)
    runs = {}
    for name, engine in (("kernel", gn_solve), ("plain", gn_solve_plain)):
        levels = []

        def recorded(*args, engine=engine, levels=levels, **kw):
            out = engine(*args, **kw)
            levels.append((args, kw, out))
            return out
        states = chunked.init_stream_state(WIDTH, HEIGHT, params, 3, STREAMS,
                                           dev)
        # Un-captured, so that the patched engine runs at every level.
        with mock.patch.object(aligner, "gn_solve", recorded), \
                graphs.eager():
            _, _, meas, ok, _ = chunked.stabilize_chunk_streams(
                states, frames, params)
        meas, ok = meas.cpu().numpy(), ok.cpu().numpy()
        rms, max_err = known_motion_error(meas[..., 2:], ok, poses)
        runs[name] = levels
        log(f"  {name}: {int(ok.sum())} of {ok.size} frames aligned; "
            f"TX/TY against the known motion RMS {rms:.4f} px, max "
            f"{max_err:.4f} px")
        for _, kw, (_, conv, _, iters) in levels:
            log(f"    {kw['width']}x{kw['height']}: "
                f"{float(conv.float().mean()) * 100:.1f} % converged, "
                f"{int((iters >= kw['max_iters']).sum())} of "
                f"{iters.numel()} items at max_iters, mean iters "
                f"{float(iters.float().mean()):.2f}")
    for (args, kw, got), (pargs, pkw, want) in zip(runs["kernel"],
                                                   runs["plain"]):
        level = f"{kw['width']}x{kw['height']}"
        differ = torch.nonzero(got[1] != want[1]).flatten().tolist()
        log(f"  {level}: converged differs on {len(differ)} items; "
            f"|dTX,dTY| over all items "
            f"{float((got[0][:, 2:] - want[0][:, 2:]).abs().max()):.2e} px")
        for item in differ[:2]:
            # Items are stream-major, then frame (aligner.align_pairs).
            log(f"    item {item}: stream {item // CHUNK}, frame "
                f"{item % CHUNK}, level {level}: the kernel run converged "
                f"{bool(got[1][item])} in {int(got[3][item])} iterations, "
                f"the plain run {bool(want[1][item])} in "
                f"{int(want[3][item])}")
            diagnose_item(item, "kernel", args, kw)
            diagnose_item(item, "plain", pargs, pkw)


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
# Parameter sweeps (kernels B and C with one threshold per item) and the
# apps' pipeline
# --------------------------------------------------------------------------

SWEEP_FRAMES = 32         # G1's and G3's clip: bench.py's content, seed 100
ITEM_NAME_B = "gn_solve[per-item threshold]"
ITEM_NAME_C = "gn8_solve[per-item threshold]"
# The threshold axis of the reference's grid (grid_search_align.cpp:135-146):
# G2 draws one per item, and its 4K path sweeps all three.
ITEM_THRESHOLDS = (0.01, 0.02, 0.04)


def timed(fn):
    """(fn(), host milliseconds from a synchronized start to the device's
    end of its work)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def gn_item_entry(name, source, replaces, totals, bound_share, worst):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=worst, ms=totals["ms"],
                device_ms=totals["device_ms"], plain_ms=totals["plain_ms"],
                bound_ms=totals["bound_ms"],
                bound_by=max(bound_share, key=bound_share.get),
                library_ms=None)


def similarity_corner_gap(t_a, t_b, width, height):
    """(B,) max distance between the level's GN corners ((w-1, h-1)
    extent) under two (B, 4) centre-pivot similarities, in px."""
    from video_stabilizer_tpu_torch import transforms as T
    from video_stabilizer_tpu_torch.ops.gn_solve import gn_corners
    corners = gn_corners(width, height, t_a.device).double()

    def at(t):
        return T.warp_points_center(t.double()[:, None, :], corners,
                                    width * 0.5, height * 0.5)
    return torch.linalg.vector_norm(at(t_a) - at(t_b), dim=-1).amax(dim=-1)


# An item whose two engines stop one iteration apart is held to this: the
# plain engine's move at the step where the first engine stopped lies
# within this share of the item's threshold, so the two engines' stop tests
# straddle the threshold by their sum-order rounding (phase 11's finding).
KNIFE_EDGE = 0.1


def step_apart_items(plain, args, kw, i_g, i_w, gap_fn):
    """The items whose engines stopped at different iterations: per item
    (index, kernel and plain iterations, threshold, the plain engine's
    corner move in px at the first engine's last step, knife-edge or not).
    The move comes from the plain engine run alone on the item with
    max_iters k - 1 and k, k the fewer iterations."""
    out = []
    for item in torch.nonzero(i_g != i_w).flatten().tolist():
        one, okw = one_item(args, item), item_kw(kw, item)
        thr = float(torch.as_tensor(okw["threshold"]).reshape(-1)[0])
        k = int(min(i_g[item], i_w[item]))
        before = plain(*one, **dict(okw, max_iters=k - 1))[0]
        after = plain(*one, **dict(okw, max_iters=k))[0]
        move = float(gap_fn(before, after, kw["width"], kw["height"])[0])
        edge = (abs(int(i_g[item]) - int(i_w[item])) == 1
                and abs(move - thr) <= KNIFE_EDGE * thr)
        out.append((item, int(i_g[item]), int(i_w[item]), thr, move, edge))
        log(f"    item {item}: kernel {int(i_g[item])} vs plain "
            f"{int(i_w[item])} iterations at threshold {thr:.4g} px; the "
            f"plain engine's step {k} moved {move:.6f} px "
            f"({(move / thr - 1) * 100:+.2f} % of the threshold)")
    return out


def per_item_b(calls):
    """G1 (a): kernel B against its plain version on the sweep's items, one
    threshold per item, at every level: converged equal; on the items whose
    engines ran the same iterations, phase 5's bars (A/B 1e-5, TX/TY 1e-3
    px; the clip is translation only, so not the A/B >= 10x check); the
    items that stopped one iteration apart straddle their threshold
    (KNIFE_EDGE) and are at most 1 % of the level (or 1); two launches
    bit-identical; iterations summed by threshold; wrapper, device and
    plain times and the bound, summed over the levels."""
    from video_stabilizer_tpu_torch.ops.gn_solve import (
        OPS_PER_SAMPLE, gn_solve, gn_solve_plain)

    totals = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0)
    bound_share = dict(bytes=0.0, operations=0.0)
    worst = 0.0
    iters_by_thr = {v: 0 for v in ITEM_THRESHOLDS}
    for args, kw in calls:
        p, n = args[0].shape[1], args[0].shape[3]
        items = args[9].shape[0]
        level = f"{kw['width']}x{kw['height']} (P={p}, N={n}, {items} items)"
        (t_g, c_g, _, i_g) = gn_solve(*args, **kw)
        (t_w, c_w, _, i_w) = gn_solve_plain(*args, **kw)
        same = i_g == i_w
        d_ab = float((t_g[:, :2] - t_w[:, :2])[same].abs().max())
        d_t = float((t_g[:, 2:] - t_w[:, 2:])[same].abs().max())
        worst = max(worst, d_ab, d_t)
        apart = step_apart_items(gn_solve_plain, args, kw, i_g, i_w,
                                 similarity_corner_gap)
        conv_equal = bool((c_g == c_w).all())
        check(conv_equal and d_ab <= GN_AB_BAR and d_t <= GN_T_BAR
              and all(a[-1] for a in apart)
              and len(apart) <= max(1, items // 100),
              f"{level}: converged equal {conv_equal}; on the "
              f"{int(same.sum())} items with equal iterations |dA,dB| "
              f"{d_ab:.2e} (bar {GN_AB_BAR:.0e}), |dTX,dTY| {d_t:.2e} px "
              f"(bar {GN_T_BAR:.0e}); {len(apart)} items one step apart, "
              f"each within {KNIFE_EDGE:.0%} of its threshold "
              f"{all(a[-1] for a in apart)}; mean iters "
              f"{float(i_g.float().mean()):.2f}")
        check(deterministic(lambda: gn_solve(*args, **kw)),
              f"{level}: two launches give bit-identical outputs")
        for v in ITEM_THRESHOLDS:
            iters_by_thr[v] += int(i_g[kw["threshold"] == v].sum())
        ms = cuda_ms(lambda: gn_solve(*args, **kw), 10)
        device_ms = graph_ms(lambda: gn_solve(*args, **kw), 10)
        plain_ms = cuda_ms(lambda: gn_solve_plain(*args, **kw), 1)
        bytes_moved = gn_bytes(args, t_g, i_g)
        ops = int(i_g.sum()) * 2 * n * OPS_PER_SAMPLE
        bound_ms, bound_by = roofline(bytes_moved, ops)
        bound_share[bound_by] += bound_ms
        log(f"    kernel {ms:.4f} ms (device {device_ms:.4f} ms), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        for k, v in (("ms", ms), ("device_ms", device_ms),
                     ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
            totals[k] += v
    log(f"  per sweep (sum of {len(calls)} levels): kernel "
        f"{totals['ms']:.4f} ms (device {totals['device_ms']:.4f} ms), "
        f"plain {totals['plain_ms']:.3f} ms, bound "
        f"{totals['bound_ms']:.4f} ms")
    lo, hi = ITEM_THRESHOLDS[0], ITEM_THRESHOLDS[-1]
    check(iters_by_thr[lo] > iters_by_thr[hi],
          "each item stops at its own threshold: iterations summed over the "
          "levels, by threshold, " + ", ".join(
              f"{v} px {n}" for v, n in iters_by_thr.items()))
    return gn_item_entry(ITEM_NAME_B,
                         "video_stabilizer_tpu_torch/csrc/gn_solve.cu",
                         GN_REPLACES, totals, bound_share, worst)


@phase("G1 aligner sweep at 1080p: grid_search_align's 27 combos in one "
       "level loop")
def aligner_sweep(dev):
    """The combos of apps/grid_search_align (threshold x fraction x
    max_displacement, window margin widened to 22) on 32 frames of bench.py's
    content through ``align_clip_impl`` with (27,) DynAlignParams, the
    launch counts set to 0 just before and read just after. (a) kernel B
    with per-item thresholds against its plain version on the sweep's
    items; (b) each combo run alone with those values in its AlignerParams
    (ok equal, phase 5's bars); (c) the sweep's align time beside the 27
    runs alone; (d) the FIR warp and the device jitter metric over all
    combos' outputs, timed, the best combo's out/in ratio below 0.6.
    Returns (the kernels line's entry, kernel B's launches, the inputs and
    un-captured figures that J7 and J8 use)."""
    from video_stabilizer_tpu_torch.apps import grid_search_align as gsa
    from video_stabilizer_tpu_torch.config import StabilizerParams
    from video_stabilizer_tpu_torch.models import aligner
    from video_stabilizer_tpu_torch.models.batch import (
        _align_clip_jit, align_clip_impl)
    from video_stabilizer_tpu_torch.ops.gn_solve import gn_solve
    from video_stabilizer_tpu_torch.utils import graphs
    from video_stabilizer_tpu_torch.utils.flow import (
        gray_f32, median_jitter_px_device_impl)

    frames = synth_streams(dev, SWEEP_FRAMES, MAIN_CONTENT, seeds=[SEED])[0][0]
    clip = torch.from_numpy(frames).to(dev)
    gray = torch.from_numpy(gsa.host_gray(frames)).to(dev)
    combos = gsa.combo_grid()
    base, line = gsa.widened_aligner()
    log(f"  {len(combos)} combos x {SWEEP_FRAMES} frames; {line}")
    params = StabilizerParams(aligner=base, enable_smoother=False,
                              crop_pixels=gsa.CROP)
    dyn = gsa.dyn_params(combos, dev)
    levels = len(aligner.level_specs(WIDTH, HEIGHT, base))
    torch.cuda.synchronize()
    reset_launch_counts()
    with mock.patch.object(aligner, "gn_solve", wraps=gn_solve) as spy:
        (meas, ok), sweep_ms = timed(
            lambda: align_clip_impl(gray, base, WIDTH, HEIGHT, dyn=dyn))
    launches = launch_counts()
    calls = [(c.args, c.kwargs) for c in spy.call_args_list]
    check(launches["gn_solve"] == levels == len(calls)
          and calls[0][1]["threshold"].shape == (len(combos) * SWEEP_FRAMES,),
          f"kernel B launched once per level ({launches['gn_solve']} of "
          f"{levels}) for all {len(combos)} x {SWEEP_FRAMES} items, one "
          "threshold per item")

    log("  (a) kernel B with per-item thresholds vs its plain version:")
    entry = per_item_b(calls)

    ok_equal, bit_equal, d_ab, d_t, alone_ms = True, 0, 0.0, 0.0, 0.0
    for c, (thr, frac, md) in enumerate(combos):
        one = dataclasses.replace(base, threshold=thr, smallest_fraction=frac,
                                  max_displacement=md)
        (m1, ok1), ms = timed(
            lambda: align_clip_impl(gray, one, WIDTH, HEIGHT))
        alone_ms += ms
        same = bool((ok1 == ok[c]).all())
        ok_equal &= same
        both = ok1 & ok[c]
        if bool(both.any()):
            d = (m1 - meas[c]).abs()[both]
            d_ab = max(d_ab, float(d[:, :2].max()))
            d_t = max(d_t, float(d[:, 2:].max()))
        bit_equal += int(torch.equal(m1, meas[c]) and same)
        if not same:
            log(f"    combo {c} ({thr}, {frac}, {md}): ok differs on frames "
                f"{torch.nonzero(ok1 != ok[c]).flatten().tolist()}")
    check(ok_equal and d_ab <= GN_AB_BAR and d_t <= GN_T_BAR,
          f"(b) the sweep vs each combo alone: ok equal on every frame "
          f"{ok_equal}; |dA,dB| {d_ab:.2e} (bar {GN_AB_BAR:.0e}), |dTX,dTY| "
          f"{d_t:.2e} px (bar {GN_T_BAR:.0e}); {bit_equal} of {len(combos)} "
          "combos bit-equal")
    log(f"  (c) align: the sweep {sweep_ms:.1f} ms for {len(combos)} combos "
        f"un-captured; the combos one by one {alone_ms:.1f} ms in all "
        f"({alone_ms / sweep_ms:.2f}x the sweep)")
    rates = ok[:, 1:].float().mean(dim=1)
    log(f"  align success per combo (frames 1-{SWEEP_FRAMES - 1}): "
        + ", ".join(f"{float(r):.2f}" for r in rates))
    # The sweep's align replayed (``_align_clip_jit``, the (27,) dyn an
    # input), against the un-captured run above.
    graphs.reset([_align_clip_jit])
    walls, same = [], True
    for k in range(1 + J_CLIP_REPLAYS):
        (m_r, ok_r), ms = timed(
            lambda: _align_clip_jit(gray, base, WIDTH, HEIGHT, dyn))
        same &= torch.equal(m_r, meas) and torch.equal(ok_r, ok)
        if k:
            walls.append(ms)
        else:
            first_ms = ms
    check(same and _align_clip_jit.replays == J_CLIP_REPLAYS,
          f"    the sweep's align replayed ({_align_clip_jit.replays} "
          "replays): meas and ok byte-equal to the un-captured sweep")
    log(f"    first call {first_ms:.1f} ms, graph pool "
        f"{_align_clip_jit.stats()[0]['pool_bytes'] / 1e9:.2f} GB; "
        + replay_figures(walls, [sweep_ms]))
    # The smoother sweep's one align (apps/grid_search_smoother.py): the
    # clip without dyn at the default parameters, a one-shot call.
    one_shot = StabilizerParams().aligner
    with graphs.eager():
        (m_e, ok_e), eager_ms = timed(
            lambda: _align_clip_jit(gray, one_shot, WIDTH, HEIGHT))
    (m_f, ok_f), first_ms = timed(
        lambda: _align_clip_jit(gray, one_shot, WIDTH, HEIGHT))
    check(torch.equal(m_f, m_e) and torch.equal(ok_f, ok_e),
          f"    the smoother sweep's one align: its first call (eager run "
          f"and capture) {first_ms:.1f} ms against {eager_ms:.1f} ms "
          "un-captured, byte-equal")

    with graphs.eager():
        outs, warp_ms = timed(lambda: gsa.warp_combos(clip, meas, ok,
                                                      params))
        in_j, in_ms = timed(lambda: float(median_jitter_px_device_impl(
            gray_f32(clip))))
        out_j, metric_ms = timed(lambda: median_jitter_px_device_impl(
            gray_f32(outs)).cpu())
    ratios = out_j / max(in_j, 1e-9)
    best = int(torch.argmin(ratios))
    log(f"  (d) un-captured: FIR warp of {outs.shape[0]} x {outs.shape[1]} "
        f"frames {warp_ms:.1f} ms; device jitter metric over all combos' "
        f"outputs {metric_ms:.1f} ms ({outs.shape[0] * (outs.shape[1] - 1)} "
        f"pairs), over the input {in_ms:.1f} ms (replayed: J7, J8)")
    check(bool(torch.isfinite(ratios).all()) and float(ratios[best]) < 0.6,
          f"input jitter {in_j:.3f} px; best combo {combos[best]} out/in "
          f"{float(ratios[best]):.4f}, worst {float(ratios.max()):.4f}")
    del outs
    inputs = dict(gray=gray, clip=clip, dyn=dyn, params=params, in_j=in_j,
                  ratios=ratios, align_ms=sweep_ms, warp_ms=warp_ms,
                  metric_ms=metric_ms)
    return entry, launches["gn_solve"], inputs


J_SWEEP_REPLAYS = 3


@phase("J7. G1's sweep (run_combos: align, accumulate and FIR warp of 27 "
       "combos) captured and replayed against the un-captured one")
def sweep_replayed(g1):
    """``run_combos`` on G1's inputs: the un-captured call twice, the first
    call and J_SWEEP_REPLAYS replays, outputs, meas and ok byte-equal;
    times beside G1 (c) and (d)'s un-captured align and FIR. Returns the
    last replay's outputs for J8."""
    from video_stabilizer_tpu_torch.apps import grid_search_align as gsa

    out, walls, eager_ms, _ = program_vs_eager(
        gsa.run_combos,
        lambda: gsa.run_combos(g1["gray"], g1["clip"], g1["dyn"],
                               g1["params"]),
        ("outputs", "meas", "ok"), J_SWEEP_REPLAYS)
    log(f"  run_combos {replay_figures(walls, eager_ms)}; G1's un-captured "
        f"align {g1['align_ms']:.1f} ms + FIR {g1['warp_ms']:.1f} ms")
    return out[0]


@phase("J8. the dense-LK jitter metric (median_jitter_px_device_impl) on "
       "J7's outputs, captured and replayed against the un-captured one")
def metric_replayed(outs, g1):
    """``median_jitter_px_device_impl`` over the 27 combos' outputs: the
    un-captured call twice, the first call and J_SWEEP_REPLAYS replays,
    byte-equal f32; the out/in ratios equal G1 (d)'s."""
    from video_stabilizer_tpu_torch.utils.flow import (
        gray_f32, median_jitter_px_device_impl)

    gray = gray_f32(outs)
    del outs
    out, walls, eager_ms, _ = program_vs_eager(
        median_jitter_px_device_impl,
        lambda: (median_jitter_px_device_impl(gray),), ("medians",),
        J_SWEEP_REPLAYS)
    ratios = out[0].cpu() / max(g1["in_j"], 1e-9)
    check(torch.equal(ratios, g1["ratios"]),
          "the replayed metric's out/in ratios equal G1 (d)'s")
    log(f"  metric over {gray.shape[0]} x {gray.shape[1] - 1} pairs "
        f"{replay_figures(walls, eager_ms)}; G1 (d) un-captured "
        f"{g1['metric_ms']:.1f} ms")


@phase("G2 kernel C with per-item thresholds vs its plain version (phase "
       "8's 4K items)")
def check_gn8_per_item(cap):
    """Phase 8's captured and perspective items, each with a threshold drawn
    from ITEM_THRESHOLDS, at all 7 levels, with phase 8's bars: converged
    equal and corners within GN8_CORNER_BAR on every item; the perspective
    items' p6/p7 >= 10x the p6/p7 gap of the items whose engines ran the
    same iterations (an item whose engines stopped apart compares two
    iterates, not the kernel's p6/p7 update); two launches bit-identical.
    Items whose engines stopped apart are printed with the plain engine's
    move at the deciding step, but not held to KNIFE_EDGE: along the 8x8
    Hessian's ill-conditioned p6/p7 direction the engines' steps part by up
    to 20 % of a 0.01 px threshold at 60x33 (an NVIDIA H100 80GB HBM3, 700
    W), which the corner bar covers. Times and bound of the captured items;
    the p6/p7 gap printed by threshold."""
    from video_stabilizer_tpu_torch.ops.gn8_solve import (
        OPS_PER_SAMPLE, gn8_solve, gn8_solve_plain)

    g = torch.Generator().manual_seed(SEED + 11)
    choices = torch.tensor(ITEM_THRESHOLDS)
    totals = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0)
    bound_share = dict(bytes=0.0, operations=0.0)
    worst = 0.0
    for (args, kw), (pargs, pkw) in zip(cap["gn8_calls"], cap["persp_calls"]):
        w, h = kw["width"], kw["height"]
        level = f"{w}x{h} (P={args[0].shape[1]}, N={args[0].shape[3]})"
        gaps, conv_equal, p67_gap, median, apart = [], True, 0.0, 0.0, []
        n_items = 0
        for name, (a, k) in (("captured", (args, kw)),
                             ("perspective", (pargs, pkw))):
            items = a[9].shape[0]
            n_items += items
            thr = choices[torch.randint(0, len(choices), (items,),
                                        generator=g)].to(a[0].device)
            k = dict(k, threshold=thr)
            p_g, c_g, _, i_g = gn8_solve(*a, **k)
            p_w, c_w, _, i_w = gn8_solve_plain(*a, **k)
            check(deterministic(lambda: gn8_solve(*a, **k)),
                  f"{level} {name}: two launches give bit-identical outputs")
            conv_equal &= bool((c_g == c_w).all())
            gaps.append(float(corner_gap(p_g, p_w, w, h).max()))
            apart += step_apart_items(gn8_solve_plain, a, k, i_g, i_w,
                                      corner_gap)
            d67 = (p_g[:, 6:] - p_w[:, 6:]).abs().amax(dim=1)
            same = i_g == i_w
            if bool(same.any()):
                p67_gap = max(p67_gap, float(d67[same].max()))
            log(f"    {level} {name}, {items} items: |d iters| "
                f"{int((i_g - i_w).abs().max())}; p6/p7 gap by threshold: "
                + ", ".join(f"{v} px {float(d67[thr == v].max()):.2e}"
                            for v in ITEM_THRESHOLDS
                            if bool((thr == v).any())))
            if name == "perspective":
                median = float(p_w[:, 6:].abs().amax(dim=1).median())
            else:
                kwc, p_cap, iters = k, p_g, i_g
        worst = max(worst, *gaps)
        check(conv_equal and max(gaps) <= GN8_CORNER_BAR
              and median >= 10 * p67_gap,
              f"{level}: converged equal {conv_equal}; corner gap "
              f"{max(gaps):.2e} px (bar {GN8_CORNER_BAR:.0e}) over all "
              f"{n_items} items, {len(apart)} of them stopped apart; "
              f"perspective items' max(|p6|,|p7|) median {median:.2e} vs "
              f"the p6/p7 gap {p67_gap:.2e} at equal iterations")
        ms = cuda_ms(lambda: gn8_solve(*args, **kwc), 10)
        device_ms = graph_ms(lambda: gn8_solve(*args, **kwc), 10)
        plain_ms = cuda_ms(lambda: gn8_solve_plain(*args, **kwc), 1)
        bytes_moved = gn_bytes(args, p_cap, iters)
        ops = int(iters.sum()) * 2 * args[0].shape[3] * OPS_PER_SAMPLE
        bound_ms, bound_by = roofline(bytes_moved, ops)
        bound_share[bound_by] += bound_ms
        log(f"    kernel {ms:.4f} ms (device {device_ms:.4f} ms), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        for key, val in (("ms", ms), ("device_ms", device_ms),
                         ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
            totals[key] += val
    log(f"  per chunk (sum of {len(cap['gn8_calls'])} levels): kernel "
        f"{totals['ms']:.4f} ms (device {totals['device_ms']:.4f} ms), "
        f"plain {totals['plain_ms']:.3f} ms, bound "
        f"{totals['bound_ms']:.4f} ms")
    return gn_item_entry(ITEM_NAME_C,
                         "video_stabilizer_tpu_torch/csrc/gn8_solve.cu",
                         GN8_REPLACES, totals, bound_share, worst)


@phase("G2 path: the 4K homography aligner over three thresholds in one "
       "level loop")
def homography_sweep(params_4k, dev):
    """8 frames of config 4's content (seed 5) through ``align_clip_impl``
    with model="homography" and (3,) DynAlignParams (ITEM_THRESHOLDS, the
    params' fraction and bound), the launch counts set to 0 just before and
    read just after: kernel C once per level, kernel B never. The 0.02 px
    combo against the run without ``dyn``: ok equal (the corner gap at full
    size printed). Returns kernel C's launches."""
    from video_stabilizer_tpu_torch.models.aligner import (
        DynAlignParams, level_specs)
    from video_stabilizer_tpu_torch.models.batch import align_clip_impl

    al = params_4k.aligner
    frames = synth_streams(dev, 8, MAIN_CONTENT, H4K, W4K,
                           seeds=[SEEDS_4K[0]])[0][0]
    clip = torch.from_numpy(frames).to(dev)
    c_n = len(ITEM_THRESHOLDS)
    dyn = DynAlignParams(
        torch.tensor(ITEM_THRESHOLDS, device=dev),
        torch.full((c_n,), al.smallest_fraction, device=dev),
        torch.full((c_n,), al.max_displacement, device=dev))
    levels = len(level_specs(W4K, H4K, al))
    torch.cuda.synchronize()
    reset_launch_counts()
    (p, ok), ms = timed(lambda: align_clip_impl(clip, al, W4K, H4K, dyn=dyn,
                                                model=HOMOGRAPHY))
    launches = launch_counts()
    check(launches["gn8_solve"] == levels and launches["gn_solve"] == 0,
          f"kernel C launched once per level ({launches['gn8_solve']} of "
          f"{levels}) for {c_n} x 8 items, kernel B not")
    log(f"  sweep {ms:.1f} ms; align success per threshold "
        + ", ".join(f"{t} px {int(ok[c, 1:].sum())}/7"
                    for c, t in enumerate(ITEM_THRESHOLDS)))
    (p1, ok1), ms1 = timed(lambda: align_clip_impl(clip, al, W4K, H4K,
                                                   model=HOMOGRAPHY))
    c = ITEM_THRESHOLDS.index(al.threshold)
    both = ok1 & ok[c]
    gap = float(corner_gap(p[c][both], p1[both], W4K, H4K).max()) \
        if bool(both.any()) else 0.0
    check(bool(torch.isfinite(p).all()) and bool((ok1 == ok[c]).all())
          and int(ok1[1:].sum()) >= 6,
          f"the {al.threshold} px combo vs the run without dyn ({ms1:.1f} "
          f"ms): ok equal {bool((ok1 == ok[c]).all())}, "
          f"{int(ok1[1:].sum())}/7 aligned; corner gap {gap:.2e} px at "
          f"{W4K}x{H4K}")
    return launches["gn8_solve"]


def write_y4m(path, gray_frames):
    """A 420jpeg YUV4MPEG2 file of (T, H, W) u8 gray frames with neutral
    chroma, laid out as tests/test_native.py:63-71 writes one."""
    t, h, w = gray_frames.shape
    chroma = np.full((h // 2, w // 2), 128, np.uint8).tobytes()
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 C420jpeg\n".encode())
        for y in gray_frames:
            f.write(b"FRAME\n" + y.tobytes() + chroma + chroma)


@phase("G3 the apps' pipeline at 1080p without cv2: .y4m through the "
       "native reader, video_test's three modes, the device jitter metric")
def apps_pipeline(dev):
    """32 frames of bench.py's content written as a .y4m, read back through
    ``utils.io.read_video`` (the native Y4M reader), stabilized by
    apps/video_test's ``stabilize_streaming``, ``stabilize_chunked`` and
    ``stabilize_batch`` (crop 0, video_test.cpp:54), each scored with
    ``median_jitter_px_device``: 22 outputs of 1080x1920x3, output jitter
    below 0.6x the input's (tests/test_flow.py:72-86). Nothing is written
    as mp4."""
    import tempfile

    from video_stabilizer_tpu_torch.apps import video_test
    from video_stabilizer_tpu_torch.config import StabilizerParams
    from video_stabilizer_tpu_torch.utils import graphs, io, native
    from video_stabilizer_tpu_torch.utils.flow import median_jitter_px_device

    frames = synth_streams(dev, SWEEP_FRAMES, MAIN_CONTENT, seeds=[SEED])[0][0]
    check(native.available(), "native/libframepipe.so built and loaded")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "clip.y4m")
        write_y4m(path, frames[..., 0])
        (read, ms) = timed(lambda: list(io.read_video(path)))
    check(len(read) == SWEEP_FRAMES
          and np.array_equal(np.stack(read), frames),
          f"the .y4m reads back as the clip's {len(read)} frames, bit-equal "
          f"({ms:.1f} ms)")
    params = StabilizerParams(crop_pixels=0)
    in_j = median_jitter_px_device(frames, device=dev)
    for mode, run in (("streaming", video_test.stabilize_streaming),
                      ("chunked", video_test.stabilize_chunked),
                      ("batch", video_test.stabilize_batch)):
        (outs, failures), ms = timed(lambda: run(read, params, device=dev))
        out_j = median_jitter_px_device(outs, device=dev)
        check(len(outs) == SWEEP_FRAMES - params.lag
              and outs[0].shape == (HEIGHT, WIDTH, 3)
              and out_j < 0.6 * in_j,
              f"{mode}: {len(outs)} outputs in {ms:.1f} ms, align failures "
              f"{failures}; jitter {in_j:.3f} -> {out_j:.3f} px (ratio "
              f"{out_j / in_j:.3f}, bar 0.6)")
    # The batch mode is a one-shot caller of ``_stabilize_clip_jit`` (the
    # streams program on one stream): its call above paid the eager run and
    # the capture.
    with graphs.eager():
        (eager_outs, _), eager_ms = timed(
            lambda: video_test.stabilize_batch(read, params, device=dev))
    check(all(np.array_equal(a, b) for a, b in zip(eager_outs, outs)),
          f"batch mode un-captured {eager_ms:.1f} ms against its first call "
          f"{ms:.1f} ms (eager run and capture): outputs byte-equal")


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


def timed_stream(host, poses, params, dev, eager=False):
    """``STREAM_FRAMES`` pinned host frames through a fresh
    ``VideoStabilizer`` with every launch count set to 0 before and read
    after, each frame timed on the host clock up to its sync: through its
    replayed graphs, or with ``eager`` un-captured (``graphs.eager()``)
    under a span Recorder, for the stage table. Checks the outputs, the
    align success and TX/TY against the known motion (phase 9's bars) and
    the launches: kernel A once per output, kernel B once per level of
    every frame (the first included, as in the JAX package), kernel C
    never. Prints the per-frame latency (and the stage table); returns its
    figures, the stabilizer (to run on) and the recorded measurements."""
    from video_stabilizer_tpu_torch.models import aligner
    from video_stabilizer_tpu_torch.models.stabilizer import VideoStabilizer
    from video_stabilizer_tpu_torch.utils import graphs
    from video_stabilizer_tpu_torch.utils.spans import Recorder

    lag, crop = params.lag, params.crop_pixels
    stab = VideoStabilizer(params, dev)
    record = recording(stab)
    mode = graphs.eager if eager else contextlib.nullcontext
    spans = Recorder if eager else contextlib.nullcontext
    torch.cuda.synchronize()
    reset_launch_counts()
    walls, device_ms, stage_runs, outs = [], [], [], []
    with mode():
        for i in range(STREAM_FRAMES):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            with spans() as rec:
                out = stab.process_frame(host[i])
            end.record()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            device_ms.append(start.elapsed_time(end))
            if eager:
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
    log(f"  {'un-captured (graphs.eager())' if eager else 'replayed'}: "
        f"per-frame latency, host clock up to the frame's sync, frames "
        f"{STREAM_STEADY}-{STREAM_FRAMES - 1}: median "
        f"{np.median(steady):.1f} ms, p90 {np.percentile(steady, 90):.1f} "
        f"ms, min {steady.min():.1f}, max {steady.max():.1f}; on the "
        f"device timeline median "
        f"{np.median(device_ms[STREAM_STEADY:]):.1f} ms")
    log(f"  frames 0-{STREAM_STEADY - 1} (host clock): "
        + ", ".join(f"{w:.0f}" for w in walls[:STREAM_STEADY]) + " ms")
    figures = dict(median=float(np.median(steady)),
                   p90=float(np.percentile(steady, 90)), align=None,
                   success=rate, rms=rms, max_err=max_err)
    if not eager:
        return dict(launches=launches, levels=levels, stab=stab, meas=meas,
                    ok=ok, outs=outs, figures=figures, walls=walls)
    runs = stage_runs[STREAM_STEADY:]
    names = sorted({k for r in runs for k in r},
                   key=lambda k: (k not in STREAM_TOP,
                                  STREAM_TOP.index(k) if k in STREAM_TOP
                                  else 0, k))
    stages = {k: float(np.mean([r.get(k, 0.0) for r in runs]))
              for k in names}
    log(f"  per-frame stage device times, mean of frames {STREAM_STEADY}-"
        f"{STREAM_FRAMES - 1} (CUDA events; the aligner's stages nest in "
        "AlignNextFrame, keyframe runs every other frame):")
    for k in names:
        pad = "" if k in STREAM_TOP else "  "
        log(f"    {pad}{k:<26} {stages[k]:9.3f} ms")
    log(f"    sum of the top stages      "
        f"{sum(stages.get(k, 0.0) for k in STREAM_TOP):9.3f} ms")
    figures["align"] = stages.get("AlignNextFrame", 0.0)
    return dict(launches=launches, levels=levels, stab=stab, meas=meas,
                ok=ok, outs=outs, figures=figures, walls=walls)


@phase("S1. streaming path: 1080p, one stream, VideoStabilizer, timed")
def streaming_path(frames, poses, params, dev):
    """``timed_stream`` on S1's clip, then ``STREAM_PROFILED`` more frames
    under torch.profiler. Returns the first ``STREAM_VS_CHUNKED`` frames'
    results for S2, the launches and S1's figures."""
    # Each frame arrives in its own pinned host buffer, as a camera's
    # decoder would leave it; filling the buffers is set-up, not timed.
    host = [torch.from_numpy(np.ascontiguousarray(f)).pin_memory()
            for f in frames]
    eager = timed_stream(host, poses, params, dev, eager=True)
    run = timed_stream(host, poses, params, dev)
    stab = run["stab"]

    # Device busy share over more frames, from the profiler's raw device
    # events: a frame runs some 40k device operations, too many to build
    # the profiler's event tree (key_averages) in time.
    more = iter(host[STREAM_FRAMES:STREAM_FRAMES + STREAM_PROFILED])
    span_ms, by_name = device_events(
        lambda: stab.process_frame(next(more)), STREAM_PROFILED)
    busy = sum(ms for ms, _ in by_name.values())
    if busy > 0:
        per_frame = busy / STREAM_PROFILED
        log(f"  {STREAM_PROFILED} replayed frames under torch.profiler: "
            f"{span_ms:.1f} ms on the device timeline, "
            f"{sum(n for _, n in by_name.values())} kernels and copies "
            f"{busy:.1f} ms: busy {busy / span_ms * 100:.1f} %, idle "
            f"{(1 - busy / span_ms) * 100:.1f} %; {per_frame:.1f} ms of "
            f"device events a frame, "
            f"{per_frame / run['figures']['median'] * 100:.1f} % of the "
            "unprofiled median frame")
    else:
        log("  the profiler recorded no device time: busy share not "
            "measured")
    n_vs = STREAM_VS_CHUNKED - params.lag
    return dict(launches=run["launches"], levels=run["levels"],
                meas=run["meas"][:STREAM_VS_CHUNKED],
                ok=run["ok"][:STREAM_VS_CHUNKED],
                outs=torch.stack(run["outs"][:n_vs]).cpu().numpy(),
                figures=run["figures"], eager=eager, replayed=run,
                host=host)


@phase("J3. the streaming path replayed against the un-captured one (S1's "
       "clip, every graph captured)")
def streaming_replayed(host, poses, params, dev, s1):
    """A third fresh ``VideoStabilizer`` over S1's frames, every key of
    its programs captured by S1's replayed run: outputs and measurements of
    both replayed runs byte-equal to S1's un-captured run; the per-frame
    median and p90 over frames 12-47 (36 frames) beside the un-captured
    run's."""
    from video_stabilizer_tpu_torch.models import aligner, smoother
    from video_stabilizer_tpu_torch.models import stabilizer as stab_mod

    progs = (stab_mod._to_gray, aligner._align_next_frame_impl,
             smoother._smooth_window, stab_mod._warp_fn)
    before = {p.name: p.captures for p in progs}
    run = timed_stream(host, poses, params, dev)
    new = {p.name: p.captures - before[p.name] for p in progs}
    check(not any(new.values()),
          f"no new capture in this run ({new}); replays so far "
          f"{ {p.name: p.replays for p in progs} }")
    eager = s1["eager"]
    for name, got in (("S1's replayed run", s1["replayed"]),
                      ("this run", run)):
        same_out = len(got["outs"]) == len(eager["outs"]) and all(
            torch.equal(a, b) for a, b in zip(got["outs"], eager["outs"]))
        same_meas = (np.array_equal(got["meas"], eager["meas"])
                     and np.array_equal(got["ok"], eager["ok"]))
        check(same_out and same_meas,
              f"{name}: {len(got['outs'])} outputs byte-equal "
              f"{same_out}, measurements and flags byte-equal {same_meas}")
    fig, eag = run["figures"], eager["figures"]
    log(f"  replayed | un-captured, frames {STREAM_STEADY}-"
        f"{STREAM_FRAMES - 1} ({STREAM_FRAMES - STREAM_STEADY} frames): "
        f"median {fig['median']:.2f} | {eag['median']:.1f} ms, p90 "
        f"{fig['p90']:.2f} | {eag['p90']:.1f} ms")
    return fig


@phase("S3 capture: kernels A's and B's inputs from a stream with rotation "
       "and zoom")
def capture_stream(params, dev):
    """A fresh ``VideoStabilizer`` over ``params.lag`` frames of one 1080p
    stream of GN_CONTENT (rotation and zoom jitter), then
    ``STREAM_CAPTURED`` more with kernel A's and B's inputs captured."""
    from video_stabilizer_tpu_torch.models import aligner, batch
    from video_stabilizer_tpu_torch.models.stabilizer import VideoStabilizer
    from video_stabilizer_tpu_torch.ops.gn_solve import gn_solve
    from video_stabilizer_tpu_torch.ops.warp_kernel import warp_frames

    from video_stabilizer_tpu_torch.utils import graphs

    frames, _ = synth_streams(dev, params.lag + STREAM_CAPTURED, GN_CONTENT,
                              seeds=[SEED])
    stab = VideoStabilizer(params, dev)
    # Un-captured: a replay calls no wrapper for the spies to see.
    with graphs.eager():
        for f in frames[0, :params.lag]:
            stab.process_frame(f)
        with mock.patch.object(aligner, "gn_solve",
                               wraps=gn_solve) as gn_spy, \
                mock.patch.object(batch, "warp_frames",
                                  wraps=warp_frames) as warp_spy:
            for f in frames[0, params.lag:]:
                stab.process_frame(f)
    torch.cuda.synchronize()
    return dict(levels=len(aligner.level_specs(WIDTH, HEIGHT,
                                               params.aligner)),
                gn_calls=[(c.args, c.kwargs) for c in gn_spy.call_args_list],
                warp_calls=[(c.args, c.kwargs)
                            for c in warp_spy.call_args_list])


@phase("S5. streaming path with fixed_iters=4: 1080p, S1's stream, timed")
def streaming_fixed(frames, poses, params, dev, s1_figures):
    """S1's clip and checks (``timed_stream``) with
    ``AlignerParams(fixed_iters=4)``: every level of every frame runs
    exactly 4 GN iterations in kernel B's fixed mode (the card's
    counterpart of apps/bench_configs.py's bench_latency ``_fixed4``).
    Prints S1's figures beside S5's."""
    host = [torch.from_numpy(np.ascontiguousarray(f)).pin_memory()
            for f in frames[:STREAM_FRAMES]]
    run = timed_stream(host, poses, params, dev)
    fig = run["figures"]
    log("  S1 (converging loop) | S5 (fixed_iters=4), both replayed: "
        f"per-frame median {s1_figures['median']:.1f} | {fig['median']:.1f} "
        f"ms, p90 {s1_figures['p90']:.1f} | {fig['p90']:.1f} ms, success "
        f"{s1_figures['success']:.4f} | {fig['success']:.4f}, TX/TY RMS "
        f"{s1_figures['rms']:.4f} | {fig['rms']:.4f} px (max "
        f"{s1_figures['max_err']:.4f} | {fig['max_err']:.4f})")
    return run["launches"]


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
       "versions (captured from a stream with rotation and zoom)")
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
        same, d_ab, d_t, iters, ab = True, 0.0, 0.0, [], []
        one_item = all(args[-1].shape[0] == 1 for args, _ in items)
        for args, k in items:
            t_g, c_g, _, i_g = gn_solve(*args, **k)
            t_w, c_w, _, i_w = gn_solve_plain(*args, **k)
            same &= bool((c_g == c_w).all())
            d_ab = max(d_ab, float((t_g[:, :2] - t_w[:, :2]).abs().max()))
            d_t = max(d_t, float((t_g[:, 2:] - t_w[:, 2:]).abs().max()))
            iters.append(int(i_g[0]))
            ab.append(float(t_w[0, :2].abs().max()))
        worst = max(worst, d_ab, d_t)
        check(one_item and same and d_ab <= GN_AB_BAR and d_t <= GN_T_BAR,
              f"{level}, {len(items)} frames, one item per launch "
              f"{one_item}: converged equal {same}; "
              f"|dA,dB| {d_ab:.2e} (bar {GN_AB_BAR:.0e}), |dTX,dTY| "
              f"{d_t:.2e} px (bar {GN_T_BAR:.0e}); iterations {iters}")
        check(float(np.median(ab)) >= 10 * GN_AB_BAR,
              f"{level}: the items' max(|A|,|B|) has median "
              f"{float(np.median(ab)):.2e}, >= 10x the A/B bar")
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
    check(forms == {((1, HEIGHT, WIDTH, 3), crop,
                      (("interp", "bilinear"), ("model", "similarity")))}
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


# --------------------------------------------------------------------------
# P1-P5: the measuring tools and the scale-out layer, each run through the
# entry point its user calls, with the launch counts set to 0 before and
# read after
# --------------------------------------------------------------------------

def run_tool(fn, *args, **kw):
    """(return value, stdout lines, launch counts) of one tool run; what it
    prints on stdout and stderr is logged."""
    out, err = io.StringIO(), io.StringIO()
    reset_launch_counts()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        ret = fn(*args, **kw)
    launches = launch_counts()
    lines = out.getvalue().splitlines()
    run_tool.stderr = err.getvalue()
    for line in err.getvalue().splitlines() + lines:
        log("  | " + line)
    return ret, lines, launches


def json_line(lines, metric: str) -> dict:
    """The tool's last stdout line as JSON, checked for its metric and a
    positive finite value."""
    got = json.loads(lines[-1])
    value = got.get("value")
    check(got.get("metric") == metric and isinstance(value, (int, float))
          and math.isfinite(value) and value > 0,
          f"JSON line {got.get('metric')} = {value} {got.get('unit')} "
          f"(want {metric}, a positive finite value)")
    return got


def kernels_launched(launches, a_form: str, b: bool, c: bool, what: str):
    check(launches.get(f"warp_frames[{a_form}]", 0) > 0
          and (launches["gn_solve"] > 0) == b
          and (launches["gn8_solve"] > 0) == c,
          f"{what}: launches {launches}")


@phase("P1. python -m video_stabilizer_tpu_torch.bench at its defaults "
       "(8 streams x 16 1080p frames, 4 reps x 4 chunks)")
def tool_bench(smi):
    from video_stabilizer_tpu_torch import bench

    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    with mock.patch.dict(os.environ, env, clear=True):
        (line, ok_rate), lines, launches = run_tool(bench.main)
    got = json_line(lines, "stabilized_1080p_bgr_fps_8streams_chunked")
    check(got == line and set(got) == {"metric", "value", "unit", "device"}
          and got["device"] == smi,
          f"one JSON line of metric, value, unit and device "
          f"{got.get('device')!r}")
    check(ok_rate >= 0.9, f"align success {ok_rate:.4f} (the last chunk)")
    kernels_launched(launches, "similarity,bilinear", True, False,
                     "kernel A (similarity, bilinear) and B launched, C not")


@phase("P2. apps/bench_configs.py --mode 4k: config 4, 2 streams x 16 "
       "frames, 3 reps")
def tool_bench_4k():
    from video_stabilizer_tpu_torch.apps import bench_configs

    _, lines, launches = run_tool(bench_configs.main, [
        "--mode", "4k", "--streams", "2", "--frames", "16", "--reps", "3"])
    got = json_line(lines, "stabilized_4k_bgr_homography_lanczos2_fps_"
                           "2streams_chunked")
    check(got["align_success"] >= 0.9,
          f"align success {got['align_success']:.4f} on the frames after "
          "each stream's first")
    kernels_launched(launches, "homography,lanczos2", False, True,
                     "kernel A (homography, Lanczos2) and C launched, B not")


LATENCY_MODES = (
    (["--mode", "latency", "--chain", "16", "--reps", "3"],
     "p50_on_device_align_latency_1080p"),
    (["--mode", "latency-chunk2", "--chain", "8", "--reps", "3"],
     "p50_e2e_latency_1080p_chunk2_single_stream"),
    (["--mode", "latency-request", "--samples", "20"],
     "single_request_latency_1080p_chunk2"),
)


@phase("P3. apps/bench_configs.py's latency modes, shortened (chain 16 / "
       "chain 8 / 20 samples)")
def tool_latency():
    from video_stabilizer_tpu_torch.apps import bench_configs

    for argv, metric in LATENCY_MODES:
        _, lines, launches = run_tool(bench_configs.main, argv)
        json_line(lines, metric)
        log(f"  launches: {launches}")


@phase("J4. apps/bench_configs.py --mode latency: 32 streaming align "
       "steps as one captured graph, 5 reps")
def latency_chain(dev):
    from video_stabilizer_tpu_torch.apps import bench_configs
    from video_stabilizer_tpu_torch.config import AlignerParams
    from video_stabilizer_tpu_torch.models import aligner

    chain, reps = 32, 5
    bench_configs.run_chain.reset()
    _, lines, launches = run_tool(bench_configs.main, [
        "--mode", "latency", "--chain", str(chain), "--reps", str(reps)])
    got = json_line(lines, "p50_on_device_align_latency_1080p")
    prog = bench_configs.run_chain
    check(prog.captures == 1 and prog.replays == reps,
          f"run_chain: {prog.captures} capture, {prog.replays} replays "
          f"(want 1 and {reps})")
    levels = len(aligner.level_specs(WIDTH, HEIGHT, AlignerParams()))
    want = levels * chain * (1 + 2 * reps)
    check(launches["gn_solve"] == want and launches["gn8_solve"] == 0,
          f"kernel B launched {launches['gn_solve']} times (want {want}: "
          f"{levels} levels x {chain} steps, in the first call, {reps} "
          f"replays of the chain and {reps} chains issued step by step)")
    stats = prog.stats()[0]
    issued = [ln for ln in run_tool.stderr.splitlines()
              if "issued one call each" in ln]
    log(f"  on the device (one replay of the {chain}-step graph): p50 "
        f"{got['value']:.3f} ms/frame; issued step by step: "
        f"{issued[0].split(': ', 1)[1] if issued else 'not printed'}; "
        f"capture {stats['capture_s']:.2f} s, instantiate "
        f"{stats['instantiate_s']:.2f} s, graph pool "
        f"{stats['pool_bytes'] / 1e6:.1f} MB")

    # The same chain timed on the device timeline (CUDA events) both ways:
    # one replay of the chain's graph, and its steps' graphs replayed one
    # call each.
    from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip
    params = AlignerParams()
    clip = torch.from_numpy(synth_shaky_clip(
        chain, HEIGHT, WIDTH, seed=6, jitter_px=1.0, color=False)).to(dev)
    state0 = aligner.init_state(WIDTH, HEIGHT, params, dev)

    def device_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(state0, clip, params, WIDTH, HEIGHT)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / chain
    whole = [device_ms(prog) for _ in range(reps)]
    steps = [device_ms(bench_configs._chain_steps) for _ in range(reps)]
    log(f"  device timeline, ms a step: the chain's graph "
        + ", ".join(f"{t:.3f}" for t in whole) + "; the steps' graphs one "
        "call each " + ", ".join(f"{t:.3f}" for t in steps))


@phase("P4. apps/profile_chunk.py on one 1080p chunk (8 x 16 frames): per "
       "kernel, --parse-only, --by-source")
def tool_profile():
    from video_stabilizer_tpu_torch.apps import profile_chunk

    with tempfile.TemporaryDirectory() as logdir:
        args = ["--logdir", logdir, "--top", "15"]
        t0 = time.perf_counter()
        totals, _, _ = run_tool(profile_chunk.main, args)
        size = os.path.getsize(os.path.join(logdir, "trace.json"))
        log(f"  run, trace and summary {time.perf_counter() - t0:.1f} s; "
            f"trace {size / 1e6:.1f} MB")
        names = list(totals)
        for symbol in ("warp_kernel", "gn_solve_kernel"):
            hits = [n for n in names if symbol in n]
            check(bool(hits), f"the per-kernel table names {symbol}: "
                  f"{hits[:1]}")
        t0 = time.perf_counter()
        parsed, _, _ = run_tool(profile_chunk.main, args + ["--parse-only"])
        check(parsed == totals,
              f"--parse-only reprints the same {len(totals)} totals "
              f"({time.perf_counter() - t0:.1f} s)")
        by_src, _, _ = run_tool(profile_chunk.main,
                                args + ["--parse-only", "--by-source"])
    total = sum(us for us, _ in totals.values())
    mine = sum(us for name, (us, _) in by_src.items()
               if name.startswith(profile_chunk.PACKAGE))
    check(total > 0 and mine / total > 0.9,
          f"--by-source: {mine / 1e3:.1f} of {total / 1e3:.1f} ms of device "
          f"time ({100 * mine / max(total, 1e-9):.1f} %) on frames under "
          f"{profile_chunk.PACKAGE}")


@phase("P5. the scale-out modules on the card: graft_entry, the one-card "
       "mesh, multihost_smoke")
def scale_out(params, dev):
    # The two-process CPU smoke runs beside the card's part of the phase.
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    smoke = subprocess.Popen(
        [sys.executable, "-m", "video_stabilizer_tpu_torch.apps."
         "multihost_smoke"], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        on_card(params, dev)
        text, _ = smoke.communicate(timeout=180)
    finally:
        if smoke.poll() is None:
            smoke.kill()
            smoke.wait()
    for line in text.splitlines()[-6:]:
        log("  | " + line)
    check(smoke.returncode == 0 and "multihost smoke OK" in text,
          f"multihost_smoke (2 processes, CPU, gloo): exit "
          f"{smoke.returncode} after {time.perf_counter() - t0:.1f} s")


def on_card(params, dev):
    """P5's card part: the graft entry points, and a sharded chunk on the
    one-card mesh against the unsharded call."""
    from video_stabilizer_tpu_torch import graft_entry, parallel
    from video_stabilizer_tpu_torch.models import batch, chunked
    from video_stabilizer_tpu_torch.parallel.mesh import tensor_leaves
    from video_stabilizer_tpu_torch.utils import graphs

    fn, (clip,) = graft_entry.entry()
    out = fn(clip)
    check(tuple(out.shape) == (4, 164, 304, 3) and out.dtype == torch.uint8
          and out.device.type == "cuda" and bool(out.any()),
          f"graft_entry.entry(): {tuple(out.shape)} {out.dtype} on "
          f"{out.device}")
    run_tool(graft_entry.dryrun_multichip, 1)

    # Two 1080p streams over two 16-frame chunks, through the one-card mesh
    # and through the unsharded call.
    frames, _ = synth_streams(dev, 2 * CHUNK, MAIN_CONTENT,
                              seeds=[SEED, SEED + 1])
    mesh = parallel.make_mesh()
    check(mesh.devices == (torch.device("cuda", 0),),
          f"make_mesh(): {mesh.devices}")
    sharded = parallel.init_sharded_stream_states(2, WIDTH, HEIGHT, params,
                                                  mesh)
    state = chunked.init_stream_state(WIDTH, HEIGHT, params, 3, 2, dev)
    same = True
    for c in range(2):
        chunk = frames[:, c * CHUNK:(c + 1) * CHUNK]
        sharded, *got = parallel.stabilize_chunk_streams_sharded(
            sharded, chunk, mesh, params)
        state, *want = chunked.stabilize_chunk_streams(
            state, torch.from_numpy(chunk), params)
        same &= all(torch.equal(g.shards[0], w) for g, w in zip(got, want))
    same_state = all(torch.equal(g, w) for g, w in zip(
        tensor_leaves(sharded.shards[0]), tensor_leaves(state)))
    check(same and same_state,
          f"sharded chunk on the one-card mesh byte-equal to the unsharded "
          f"call: outputs, measurements, flags {same}, carried state "
          f"{same_state}")

    # The sharded clip on the same streams: the shard replays the card's
    # ``_stabilize_streams_jit`` graph; against the un-captured clip.
    prog = batch._stabilize_streams_jit
    graphs.reset([prog])
    clip = torch.from_numpy(frames).to(dev)
    with graphs.eager():
        want, eager_ms = timed(lambda: batch.stabilize_streams(clip, params,
                                                               dev))
    runs = [timed(lambda: parallel.stabilize_streams_sharded(clip, mesh,
                                                             params))
            for _ in range(2)]
    same = all(torch.equal(g.shards[0], w)
               for got, _ in runs for g, w in zip(got, want))
    check(same and prog.captures == 1 and prog.replays == 1,
          f"sharded clip (2 x {clip.shape[1]} frames) on the one-card mesh: "
          f"first call {runs[0][1]:.1f} ms (capture), replay "
          f"{runs[1][1]:.1f} ms, un-captured {eager_ms:.1f} ms; outputs, "
          f"measurements, flags byte-equal to the un-captured clip {same}")


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
    params_topk = dataclasses.replace(
        params, aligner=AlignerParams(selection="topk"))
    params_fixed = dataclasses.replace(
        params, aligner=AlignerParams(fixed_iters=FIXED_KS[-1]))
    crop = params.crop_pixels
    synth_on_card(dev)
    kernels = {}
    cap = capture(params, dev)
    if cap is not None:
        kernels["warp_frames[similarity,bilinear]"] = check_warp(cap, crop,
                                                                 dev)
        kernels["gn_solve"] = check_gn(cap)
        kernels[FIXED_NAME] = check_gn_fixed(cap)
        del cap
    cap = capture_4k(params_4k, dev)
    if cap is not None:
        kernels["warp_frames[homography,lanczos2]"] = check_warp_4k(
            cap, crop, dev)
        kernels["gn8_solve"] = check_gn8(cap)
        kernels[ITEM_NAME_C] = check_gn8_per_item(cap)
        del cap
    torch.cuda.empty_cache()
    check_4k_content(params_4k, dev)
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
        if result is None:
            del frames
            continue
        launches, states, last_chunk, stages = result
        for kname in kernels:
            if launches.get(kname, 0) > 0:
                path_launches[kname] = launches[kname]
        if model == "similarity":
            # Right after phase 9, so that both runs meet the same host
            # pace: on an NVIDIA H100 80GB HBM3 (700.00 W) a run after the
            # profiler's chunk read 1.2-1.5x slower in every eager stage,
            # the smoother's included.
            topk_path(frames, poses, params_topk, dev, stages)
        profile_chunk(states, last_chunk, prm, model)
        if model == "similarity":
            check_fir(states, last_chunk, prm, dev)
        else:
            check_fir_4k(states, last_chunk, prm, dev)
        del states, last_chunk
        torch.cuda.empty_cache()
        if model == "similarity":
            captured_1080p(frames, prm, dev)
            clip_1080p(frames, prm, dev)
            clip_programs(frames, prm, dev)
        else:
            captured_4k(frames, prm, dev)
            clip_4k(frames, prm, dev)
        del frames
        torch.cuda.empty_cache()
    # The sweeps: G1 (kernel B, one threshold per item) and G2's 4K path
    # (kernel C), each with its own launch counts; then G3.
    sweep = aligner_sweep(dev)
    if sweep is not None:
        kernels[ITEM_NAME_B], path_launches[ITEM_NAME_B], g1 = sweep
        outs = sweep_replayed(g1)
        if outs is not None:
            metric_replayed(outs, g1)
        del sweep, g1, outs
    torch.cuda.empty_cache()
    n_c = homography_sweep(params_4k, dev)
    if n_c:
        path_launches[ITEM_NAME_C] = n_c
    apps_pipeline(dev)
    torch.cuda.empty_cache()
    wide_jitter(params, dev)
    small_reference(dev)

    # The streaming path: its own clip, its own launch counts (S1, and S5 in
    # kernel B's fixed mode), read into the one-frame / one-item entries of
    # kernels A and B (S3) and the fixed-mode entry.
    t0 = time.perf_counter()
    frames, poses = synth_streams(
        dev, STREAM_FRAMES + STREAM_PROFILED, MAIN_CONTENT, seeds=[SEED])
    frames, poses = frames[0], poses[0]
    log(f"== streaming path's clip {frames.shape} in "
        f"{time.perf_counter() - t0:.1f} s")
    s1 = streaming_path(frames, poses, params, dev)
    one = (None, None)
    if s1 is not None:
        j3 = streaming_replayed(s1["host"][:STREAM_FRAMES], poses, params,
                                dev, s1)
        streaming_vs_chunked(frames, params, dev, s1)
        for name, counted in STREAM_KERNELS:
            if s1["launches"].get(counted, 0) > 0:
                path_launches[name] = s1["launches"][counted]
        s5 = streaming_fixed(frames, poses, params_fixed, dev,
                             j3 or s1["figures"])
        if s5 is not None and s5.get("gn_solve", 0) > 0:
            path_launches[FIXED_NAME] = s5["gn_solve"]
    del frames, s1
    s3 = capture_stream(params, dev)
    if s3 is not None:
        one = check_one_item(s3, crop) or one
    del s3
    torch.cuda.empty_cache()
    for (name, _), entry in zip(STREAM_KERNELS, one):
        kernels[name] = entry
    streaming_small_reference(dev)
    torch.cuda.empty_cache()

    # The tools and the scale-out layer: each its own launch counts.
    tool_bench(smi)
    tool_bench_4k()
    tool_latency()
    latency_chain(dev)
    tool_profile()
    scale_out(params, dev)

    missing = [k for k, v in kernels.items()
               if v is None or k not in path_launches]
    if failures or missing or len(kernels) != 9:
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
