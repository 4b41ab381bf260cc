"""Chunked-serving bench of the port: stabilized 1080p BGR frames/s on one
card, under the JAX package's ``bench.py`` protocol.

    python -m video_stabilizer_tpu_torch.bench

S streams run the chunked serving path (``models/chunked.py``) with their
state carried from chunk to chunk, so once past the lag window every input
frame gives exactly one warped, cropped output frame. Throughput is
(streams x chunk frames) / chunk time, the best of ``BENCH_REPS`` reps,
each rep ``BENCH_INNER`` chunks submitted with no host sync between them
and one scalar fetched at its end.

Knobs (environment): ``BENCH_HEIGHT`` (1080), ``BENCH_WIDTH`` (1920),
``BENCH_STREAMS`` (8), ``BENCH_FRAMES`` (16 per chunk), ``BENCH_REPS``
(4), ``BENCH_INNER`` (4), ``BENCH_MERGE_COARSE`` (0), ``BENCH_PAIR_VMAP``
(0) and ``BENCH_DEVICE`` (``cuda``; ``cpu`` runs the plain versions).

Prints one JSON line: {"metric", "value", "unit", "device"}, ``device``
being the card's name and power limit as ``nvidia-smi`` reports them (or
``cpu``). Progress, every rep's time and the align success rate of the
last chunk go to stderr.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def device_label(dev: torch.device) -> str:
    """The card's name and power limit (``nvidia-smi``), or ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def main(device=None):
    """Run the bench with the ``BENCH_*`` knobs (``device`` in place of
    ``BENCH_DEVICE`` when given); print the JSON line and return (that
    line's dict, the last chunk's align success rate)."""
    from video_stabilizer_tpu_torch.config import (
        AlignerParams, StabilizerParams)
    from video_stabilizer_tpu_torch.device import resolve_device
    from video_stabilizer_tpu_torch.models.chunked import (
        _stabilize_chunk_streams_jit, init_stream_state)
    from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

    env = os.environ.get
    height = int(env("BENCH_HEIGHT", "1080"))
    width = int(env("BENCH_WIDTH", "1920"))
    streams = int(env("BENCH_STREAMS", "8"))
    frames = int(env("BENCH_FRAMES", "16"))   # per chunk
    reps = int(env("BENCH_REPS", "4"))
    inner = int(env("BENCH_INNER", "4"))
    merge_coarse = int(env("BENCH_MERGE_COARSE", "0"))
    pair_vmap = env("BENCH_PAIR_VMAP", "0") != "0"
    dev = resolve_device(device or env("BENCH_DEVICE", "cuda"))
    params = StabilizerParams(
        crop_pixels=32,
        aligner=AlignerParams(merge_coarse=merge_coarse,
                              pair_vmap=pair_vmap))
    label = device_label(dev)
    print(f"bench: {streams} streams x {frames}-frame chunks @ "
          f"{width}x{height} BGR on {dev} ({label})", file=sys.stderr)

    # One synthetic stream broadcast to S streams: content does not set
    # the time.
    clip = synth_shaky_clip(frames, height, width, seed=5, jitter_px=1.0,
                            pan_px_per_frame=0.3, device=dev)
    clips = torch.from_numpy(
        np.broadcast_to(clip, (streams,) + clip.shape).copy()).to(dev)
    states = init_stream_state(width, height, params, 3, streams, dev)

    def run_chunk(states, x):
        # The serving loop owns its state chain: the program takes its
        # donation, as bench.py's does.
        states, out, meas, ok, valid = _stabilize_chunk_streams_jit(
            states, x, params, width, height)
        return states, out, ok

    t0 = time.perf_counter()
    states, out, ok = run_chunk(states, clips)
    float(out[:, -1, ::64, ::64].sum())
    print(f"bench: first call (incl. the kernels' build at first use) "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # Distinct inputs per chunk, made on the device before any timing (u8
    # wraps around). State carries across every call: this is the serving
    # loop. A rep submits its chunks with no host sync between them; a
    # device-side probe of each chunk's output and success is summed so no
    # output can be skipped, and the one scalar fetched ends the rep.
    variants = [clips + (k + 1) for k in range(inner)]
    states, out, ok = run_chunk(states, variants[0])  # past the lag window
    float(out[:, -1, ::64, ::64].sum())
    times = []
    for _rep in range(reps):
        t0 = time.perf_counter()
        probe = None
        for v in variants:
            states, out, ok = run_chunk(states, v)
            p = out[:, -1, ::64, ::64].sum() + ok.sum()
            probe = p if probe is None else probe + p
        float(probe)
        times.append((time.perf_counter() - t0) / inner)
    ok_rate = float(ok.float().mean())
    best = min(times)
    fps = streams * frames / best
    print(f"bench: steady-state {best:.3f}s per {streams * frames}-frame "
          f"chunk (1 warped output per input frame); "
          f"times={['%.3f' % t for t in times]}; "
          f"align success rate={ok_rate:.3f}", file=sys.stderr)
    line = {
        "metric": f"stabilized_{height}p_bgr_fps_{streams}streams_chunked",
        "value": round(fps, 2),
        "unit": "frames/sec",
        "device": label,
    }
    print(json.dumps(line))
    return line, ok_rate


if __name__ == "__main__":
    main()
