#!/usr/bin/env python
"""Trace one chunk of the chunked pipeline with ``torch.profiler`` and
print where the device time goes: per kernel, or per source frame of the
port (``--by-source``). The port of the JAX package's
``apps/profile_chunk.py``.

    python -m video_stabilizer_tpu_torch.apps.profile_chunk [--mode 1080p]
        [--streams 8] [--frames 16] [--logdir output/profile_chunk]
        [--by-source | --copies] [--parse-only] [--device cuda|cpu]

Two chunks run first (the kernels' build at first use, and the lag
window); the third runs once as the profiler's warm-up step, then again
traced with the CPU and CUDA activities and Python stacks, and is written
as a Chrome trace, ``<logdir>/trace.json``. Every
chunk runs un-captured (``utils.graphs.eager()``: ``stabilize_chunk_core``
and the warp, eager), since a replayed graph has no Python frames to
attribute its kernels to; so the trace shows the eager chunk, not the
graph that the entry points replay on the card.
``--parse-only`` summarizes that file again without touching the card.

Per kernel: the device time and count of every kernel, copy and memset,
summed from the trace's events directly (the profiler's ``key_averages``
over a chunk's tens of thousands of events is far slower); then one line
with the port's hand kernels A-J (``HAND_KERNELS``: kernel J, select's
prelude, is ``prelude_kernel``) and their device time.

By source: each device event is linked to the runtime call that launched
it by its correlation id, and its time goes to the innermost Python frame
under ``video_stabilizer_tpu_torch/`` that encloses that call on the
launching thread. A frame is named as torch's Python tracer names it: the
file, the line its function starts at, and the function.

Copies (``--copies``): the device time of every copy (a kernel or memcpy
whose name says copy) by its site: the source frame as above, the
top-level ``aten`` operator that issued it and that operator's input
shapes (the trace records them), so that two copies in one function tell
apart.

A trace of a CPU run has no device events: there the top-level ``aten``
operators stand in for them, each its own launch.
"""

import argparse
import bisect
import json
import os
import sys
import time
from collections import defaultdict

import numpy as np

PACKAGE = "video_stabilizer_tpu_torch/"
# The port's hand kernels (csrc/*.cu) by the symbol of their __global__
# functions: the per-kernel table's names hold it, and the summary line
# under the table charges each kernel's device time to its letter.
HAND_KERNELS = {
    "A": ("warp_kernel",), "B": ("gn_solve_kernel",),
    "C": ("gn8_solve_kernel",), "D": ("tvl1_wave_kernel", "tvl1_any_kernel"),
    "E": ("pinv4_kernel", "pinv8_kernel"), "F": ("accum_kernel",),
    "G": ("gray_kernel",), "H": ("pyr_down_kernel", "pyr_down_wide_kernel"),
    "I": ("keyframe_kernel",), "J": ("prelude_kernel",)}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
UNATTRIBUTED = "<no frame under video_stabilizer_tpu_torch/>"


def load_trace(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _spans(events, cat):
    return [e for e in events if e.get("cat") == cat and e.get("ph") == "X"]


def _top_level(ops):
    """The operators no other operator of the same thread encloses."""
    out = []
    ends = {}
    for e in sorted(ops, key=lambda e: (e["ts"], -e["dur"])):
        key = (e["pid"], e["tid"])
        if e["ts"] >= ends.get(key, float("-inf")):
            out.append(e)
            ends[key] = e["ts"] + e["dur"]
    return out


def device_work(events):
    """(work, launches): the device events, or on a trace without any the
    top-level CPU operators, and for each the event that issued it (its
    runtime call; an operator is its own). A device event whose launch the
    trace lacks maps to None."""
    work = [e for cat in DEVICE_CATS for e in _spans(events, cat)]
    if not work:
        work = _top_level(_spans(events, "cpu_op"))
        return work, work
    by_corr = {}
    for cat in LAUNCH_CATS:
        for e in _spans(events, cat):
            by_corr[e.get("args", {}).get("correlation")] = e
    return work, [by_corr.get(e.get("args", {}).get("correlation"))
                  for e in work]


def summarize_ops(events) -> dict:
    """{name: (microseconds, count)} of the device work."""
    totals = defaultdict(lambda: [0.0, 0])
    for e in device_work(events)[0]:
        t = totals[e["name"]]
        t[0] += e["dur"]
        t[1] += 1
    return {k: tuple(v) for k, v in totals.items()}


def _package_frames(events, launches):
    """The innermost Python frame under ``PACKAGE`` that encloses each
    launch on its thread (``UNATTRIBUTED`` where none does), by one sweep
    over each thread's properly nested frames."""
    frames = defaultdict(list)
    for e in _spans(events, "python_function"):
        frames[(e["pid"], e["tid"])].append(e)
    queries = defaultdict(list)
    for i, launch in enumerate(launches):
        if launch is not None:
            queries[(launch["pid"], launch["tid"])].append(i)
    names = [UNATTRIBUTED] * len(launches)
    for key, idx in queries.items():
        # Frames open before launches that start at the same time.
        items = sorted(
            [(f["ts"], 0, f) for f in frames.get(key, ())]
            + [(launches[i]["ts"], 1, i) for i in idx],
            key=lambda x: (x[0], x[1],
                           -x[2]["dur"] if x[1] == 0 else 0))
        stack = []   # (end, innermost package frame at or below)
        for ts, kind, item in items:
            while stack and stack[-1][0] < ts:
                stack.pop()
            if kind == 0:
                inner = (item["name"] if item["name"].startswith(PACKAGE)
                         else (stack[-1][1] if stack else None))
                stack.append((ts + item["dur"], inner))
            elif stack and stack[-1][1] is not None:
                names[item] = stack[-1][1]
    return names


def summarize_by_source(events) -> dict:
    """{frame: (microseconds, count)} of the device work, by the innermost
    frame under ``PACKAGE`` that launched it."""
    work, launches = device_work(events)
    totals = defaultdict(lambda: [0.0, 0])
    for e, name in zip(work, _package_frames(events, launches)):
        t = totals[name]
        t[0] += e["dur"]
        t[1] += 1
    return {k: tuple(v) for k, v in totals.items()}


def _is_copy(e) -> bool:
    return e.get("cat") == "gpu_memcpy" or "copy" in e["name"].lower()


def _issuing_ops(events, launches):
    """The top-level CPU operator enclosing each launch on its thread (None
    where none does)."""
    ops = {}
    for op in _top_level(_spans(events, "cpu_op")):
        ops.setdefault((op["pid"], op["tid"]), []).append(op)
    starts = {k: [op["ts"] for op in v] for k, v in ops.items()}
    out = []
    for launch in launches:
        if launch is None:
            out.append(None)
            continue
        key = (launch["pid"], launch["tid"])
        i = bisect.bisect_right(starts.get(key, []), launch["ts"]) - 1
        op = ops[key][i] if i >= 0 else None
        out.append(op if op is not None and launch["ts"] <= op["ts"]
                   + op["dur"] else None)
    return out


def summarize_copies(events) -> dict:
    """{site: (microseconds, count)} of the device copies, a site being
    "frame | operator input shapes"."""
    work, launches = device_work(events)
    totals = defaultdict(lambda: [0.0, 0])
    for e, frame, op in zip(work, _package_frames(events, launches),
                            _issuing_ops(events, launches)):
        if not _is_copy(e):
            continue
        what = "<no operator>" if op is None else (
            f"{op['name']} {op.get('args', {}).get('Input Dims', '')}")
        t = totals[f"{frame} | {what}".rstrip()]
        t[0] += e["dur"]
        t[1] += 1
    return {k: tuple(v) for k, v in totals.items()}


def print_table(title: str, totals: dict, top: int):
    grand = sum(us for us, _ in totals.values())
    print(f"\n== {title}: {len(totals)} distinct, total "
          f"{grand / 1e3:.3f} ms ==")
    for name, (us, n) in sorted(totals.items(), key=lambda kv: -kv[1][0])[
            :top]:
        share = 100.0 * us / grand if grand else 0.0
        print(f"{us / 1e3:9.3f} ms  {share:5.1f}%  x{n:<6d} {name[:110]}")


def summarize(path: str, by_source: bool, top: int,
              copies: bool = False) -> dict:
    """Print and return one table of the trace at ``path``."""
    events = load_trace(path)
    on_device = any(e.get("cat") in DEVICE_CATS for e in events)
    what = "device time" if on_device else "CPU operator time (no device)"
    if copies:
        totals = summarize_copies(events)
        print_table(f"{what} of copies by site", totals, top)
    elif by_source:
        totals = summarize_by_source(events)
        print_table(f"{what} by source frame", totals, top)
    else:
        totals = summarize_ops(events)
        print_table(f"{what} by kernel", totals, top)
        print("hand kernels: " + ", ".join(
            f"{letter} {us / 1e3:.3f} ms x{n}"
            for letter, (us, n) in hand_kernel_totals(totals).items()))
    return totals


def hand_kernel_totals(totals: dict) -> dict:
    """{letter: (microseconds, count)} of the hand kernels in a per-kernel
    table (``HAND_KERNELS``' symbols), the ones present."""
    out = {}
    for letter, symbols in HAND_KERNELS.items():
        rows = [v for name, v in totals.items()
                if any(sym in name for sym in symbols)]
        if rows:
            out[letter] = (sum(us for us, _ in rows),
                           sum(n for _, n in rows))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--logdir", default=os.path.join("output",
                                                     "profile_chunk"))
    ap.add_argument("--mode", choices=["1080p", "4k"], default="1080p",
                    help="4k = config 4 (homography + phase + Lanczos2)")
    ap.add_argument("--height", type=int, default=None,
                    help="frame rows (default 1080; 2160 in --mode 4k)")
    ap.add_argument("--width", type=int, default=None,
                    help="frame columns (default 1920; 3840 in --mode 4k)")
    ap.add_argument("--parse-only", action="store_true",
                    help="skip the run; summarize <logdir>/trace.json")
    ap.add_argument("--by-source", action="store_true",
                    help="device time by the port's source frame")
    ap.add_argument("--copies", action="store_true",
                    help="device time of copies by source frame, operator "
                    "and input shapes")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    path = os.path.join(args.logdir, "trace.json")
    if args.parse_only:
        return summarize(path, args.by_source, args.top, args.copies)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from video_stabilizer_tpu_torch.config import (
        AlignerParams, StabilizerParams)
    from video_stabilizer_tpu_torch.device import resolve_device
    from video_stabilizer_tpu_torch.models.chunked import (
        _stabilize_chunk_streams_jit, init_stream_state)
    from video_stabilizer_tpu_torch.utils import graphs
    from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

    dev = resolve_device(args.device)
    if args.mode == "4k":
        h, w = args.height or 2160, args.width or 3840
        params = StabilizerParams(
            aligner=AlignerParams(phase_correlate=True),
            output_interp="lanczos2", crop_pixels=32)
        model = "homography"
    else:
        h, w = args.height or 1080, args.width or 1920
        params = StabilizerParams(crop_pixels=32)
        model = "similarity"
    clip = synth_shaky_clip(args.frames, h, w, seed=5, jitter_px=1.0,
                            pan_px_per_frame=0.3, device=dev)
    clips = torch.from_numpy(
        np.broadcast_to(clip, (args.streams,) + clip.shape).copy()).to(dev)
    states = init_stream_state(w, h, params, 3, args.streams, dev, model)
    inputs = [clips + k for k in range(3)]

    def run(states, x):
        with graphs.eager():
            states, out, meas, ok, valid = _stabilize_chunk_streams_jit(
                states, x, params, w, h, model)
        return states, float(out[:, -1, ::64, ::64].sum())

    print("profiling the un-captured chunk (stabilize_chunk_core and the "
          "warp, eager, under utils.graphs.eager()): a replayed graph has "
          "no Python frames", file=sys.stderr)

    t0 = time.perf_counter()
    states, _ = run(states, inputs[0])
    print(f"warm-up (incl. the kernels' build at first use) "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
    states, _ = run(states, inputs[1])

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    # One warm-up step, then the traced one: the profiler starts recording
    # device work some time after a session opens (on the H100, 55 ms
    # after it in one run: the first 10 kernels of a chunk traced at once
    # were missing), so the same chunk runs once untraced first.
    once = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with profile(activities=activities, with_stack=True, record_shapes=True,
                 schedule=once) as prof:
        run(states, inputs[2])
        prof.step()
        t0 = time.perf_counter()
        states, _ = run(states, inputs[2])
        dt = time.perf_counter() - t0
        prof.step()
    n = args.streams * args.frames
    print(f"traced call: {dt:.3f}s for {n} frames ({n / dt:.1f} fps, "
          f"{dt / n * 1e3:.2f} ms/frame, under the profiler)",
          file=sys.stderr)
    os.makedirs(args.logdir, exist_ok=True)
    prof.export_chrome_trace(path)
    return summarize(path, args.by_source, args.top, args.copies)


if __name__ == "__main__":
    main()
