#!/usr/bin/env python
"""Benchmarks of the other north-star configurations, beside the headline
``python -m video_stabilizer_tpu_torch.bench``: the port of the JAX
package's ``apps/bench_configs.py``.

Modes (--mode):
  1080p     the chunked 1080p similarity bench (``bench.main``, in this
            process).
  4k        config 4: 4K BGR, 8-DOF homography, phase-correlation init,
            Lanczos2 output warp, chunked with carried state.
  latency   p50 per-frame latency of the streaming (batch 1) align path at
            1080p gray: K align steps as one program (``run_chain``, a
            captured graph on the card), one sync at the end.
  latency-chunk2   p50 ms per frame of one stream fed 2-frame chunks
            through the chunked pipeline, chained, one fetch per rep.
  latency-request  p50 / p99 of ONE 2-frame chunk, submit to result, with
            no chaining; plus the dispatch floor and the full-frame fetch.

    python -m video_stabilizer_tpu_torch.apps.bench_configs --mode 4k

Every result is one JSON line, with the device it ran on (the card's name
and power limit, or ``cpu``). ``--gn`` is accepted as in the JAX package,
but the port runs kernels B and C whatever ``gn_kernel`` says (port
``config.py``), so no metric name carries the JAX package's ``gn-``
suffix. ``--device cpu`` runs the plain versions (at ``--height`` /
``--width`` small enough for a CPU).
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from video_stabilizer_tpu_torch.utils.graphs import Program


def _setup(device):
    from video_stabilizer_tpu_torch.bench import device_label
    from video_stabilizer_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    return dev, device_label(dev)


def _res(height: int, name_at_default: str, default: int) -> str:
    return name_at_default if height == default else f"{height}p"


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _after_first(ok) -> float:
    """Align success over (S, T) flags, each stream's first frame (nothing
    to align to) left out."""
    return float(ok[:, 1:].float().mean())


def bench_4k(streams: int, frames: int, reps: int, gn: str = "auto",
             pair_vmap: bool = False, *, height: int = 2160,
             width: int = 3840, device="cuda"):
    """Config 4, chunked steady state: 8-DOF homography + phase correlation
    + Lanczos2, state carried across chunks, one warped output per input
    frame (bench.py's protocol: 2 distinct inputs per rep, best rep)."""
    from video_stabilizer_tpu_torch.config import (
        AlignerParams, StabilizerParams)
    from video_stabilizer_tpu_torch.models.chunked import (
        _stabilize_chunk_streams_jit, init_stream_state)
    from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

    dev, label = _setup(device)
    params = StabilizerParams(
        aligner=AlignerParams(phase_correlate=True, gn_kernel=gn,
                              pair_vmap=pair_vmap),
        output_interp="lanczos2", crop_pixels=32)
    clip = synth_shaky_clip(frames, height, width, seed=5, jitter_px=1.0,
                            pan_px_per_frame=0.3, device=dev)
    clips = torch.from_numpy(
        np.broadcast_to(clip, (streams,) + clip.shape).copy()).to(dev)
    states = init_stream_state(width, height, params, 3, streams, dev,
                               model="homography")

    def run(states, x):
        states, out, meas, ok, valid = _stabilize_chunk_streams_jit(
            states, x, params, width, height, "homography")
        return states, out, ok

    oks = []
    t0 = time.perf_counter()
    states, out, ok = run(states, clips)
    float(out[:, -1, ::64, ::64].sum())
    oks.append(ok)
    print(f"4k: first call {time.perf_counter() - t0:.1f}s; "
          f"ok={_after_first(ok):.3f}", file=sys.stderr)
    variants = [clips + (k + 1) for k in range(2)]
    states, out, ok = run(states, variants[0])   # past the lag window
    float(out[:, -1, ::64, ::64].sum())
    oks.append(ok)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        probe = None
        for v in variants:
            states, out, ok = run(states, v)
            oks.append(ok)
            p = out[:, -1, ::64, ::64].sum()
            probe = p if probe is None else probe + p
        float(probe)
        times.append((time.perf_counter() - t0) / len(variants))
    best = min(times)
    return {
        "metric": f"stabilized_{_res(height, '4k', 2160)}_bgr_homography_"
                  f"lanczos2_fps_{streams}streams_chunked"
                  + ("_pairvmap" if pair_vmap else ""),
        "value": round(streams * frames / best, 2),
        "unit": "frames/sec",
        "align_success": _after_first(torch.cat(oks, dim=1)),
        "device": label,
        "note": f"chunked steady state, 1 warped output per input frame, "
                f"times={['%.3f' % t for t in times]}",
    }


def _chain_steps(state, frames, params, width: int, height: int):
    """``frames.shape[0]`` streaming align steps one after the other from
    ``state`` (the body of the JAX tool's ``lax.scan``): (final state,
    transforms (K, 4), success (K,))."""
    from video_stabilizer_tpu_torch.models.aligner import align_next_frame
    ts, oks = [], []
    for fr in frames.unbind(0):
        state, t, ok = align_next_frame(state, fr, params)
        ts.append(t)
        oks.append(ok)
    return state, torch.stack(ts), torch.stack(oks)


# The JAX tool's ``run_chain`` (apps/bench_configs.py:116-121): the chain of
# steps as one program, on the card one captured graph.
run_chain = Program(_chain_steps, static_argnames=("params", "width",
                                                   "height"),
                    name="run_chain")


def bench_latency(reps: int, chain: int, gn: str = "auto",
                  fixed_iters=None, merge_coarse: int = 0, *,
                  height: int = 1080, width: int = 1920, device="cuda"):
    """p50 per-frame latency of the streaming align path on the device:
    ``chain`` gray frames through the align step one after the other from
    the same start state every rep, as ONE program (``run_chain``, on the
    card a captured graph replayed), one fetch at the end: the JAX tool's
    ``lax.scan`` timing (apps/bench_configs.py:100-140). The same steps
    issued one call at a time (each on the card a replay of the step's own
    graph) give the host-issued chained figure, printed to stderr.
    ``align_next_frame`` leaves its input state untouched, so every rep
    starts from the same state."""
    from video_stabilizer_tpu_torch.config import AlignerParams
    from video_stabilizer_tpu_torch.models.aligner import init_state
    from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

    dev, label = _setup(device)
    params = AlignerParams(gn_kernel=gn, fixed_iters=fixed_iters,
                           merge_coarse=merge_coarse)
    clip = torch.from_numpy(synth_shaky_clip(
        chain, height, width, seed=6, jitter_px=1.0, color=False,
        device=dev)).to(dev)
    state0 = init_state(width, height, params, dev)

    t0 = time.perf_counter()
    _, ts, oks = run_chain(state0, clip, params, width, height)
    float(ts.sum())
    ok_rate = float(oks[1:].float().mean())
    print(f"latency: first call {time.perf_counter() - t0:.1f}s, "
          f"ok={ok_rate:.3f}", file=sys.stderr)

    variants = [clip + (k + 1) for k in range(reps)]
    _sync(dev)

    def per_frame_ms(chain_fn):
        out = []
        for v in variants:
            t0 = time.perf_counter()
            _, ts, _ = chain_fn(state0, v, params, width, height)
            float(ts.sum())
            out.append((time.perf_counter() - t0) / chain * 1e3)
        return out

    per_frame = per_frame_ms(run_chain)
    issued = per_frame_ms(_chain_steps)
    print(f"latency: the same steps issued one call each (host issue + "
          f"device): p50 {np.percentile(issued, 50):.3f} ms/frame, reps "
          f"{['%.2f' % t for t in issued]}", file=sys.stderr)
    return {
        "metric": f"p50_on_device_align_latency_"
                  f"{_res(height, '1080p', 1080)}"
                  + (f"_fixed{fixed_iters}" if fixed_iters else "")
                  + (f"_merge{merge_coarse}" if merge_coarse else ""),
        "value": round(float(np.percentile(per_frame, 50)), 3),
        "unit": "ms/frame",
        "align_success": ok_rate,
        "device": label,
        "note": f"{chain} sequential streaming align steps as one program "
                f"(a captured graph on the card), one fetch; per-frame ms "
                f"across reps: {['%.2f' % t for t in per_frame]}",
    }


def bench_latency_chunk2(reps: int, chain: int, gn: str = "auto",
                         merge_coarse: int = 0, *, height: int = 1080,
                         width: int = 1920, device="cuda"):
    """Low-latency serving: ONE stream fed 2-frame chunks through the
    chunked state-carrying pipeline (align, smooth, accumulate, warp), ms
    per frame; ``chain`` chunks per rep and one fetch per rep."""
    from video_stabilizer_tpu_torch.config import (
        AlignerParams, StabilizerParams)
    from video_stabilizer_tpu_torch.models.chunked import (
        _stabilize_chunk_jit, init_stream_state)
    from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

    dev, label = _setup(device)
    params = StabilizerParams(
        crop_pixels=32,
        aligner=AlignerParams(gn_kernel=gn, merge_coarse=merge_coarse))
    clip = torch.from_numpy(synth_shaky_clip(
        2 * chain, height, width, seed=6, jitter_px=1.0, device=dev)).to(dev)
    chunks = [clip[2 * k:2 * k + 2] for k in range(chain)]
    state = init_stream_state(width, height, params, 3, 1, dev)
    oks = []

    def run(state):
        probe = torch.zeros((), dtype=torch.int64, device=dev)
        for ch in chunks:
            state, out, meas, ok, valid = _stabilize_chunk_jit(
                state, ch, params, width, height)
            oks.append(ok)
            probe = probe + out[-1, ::64, ::64].sum()
        return state, probe

    t0 = time.perf_counter()
    state, probe = run(state)
    int(probe)
    print(f"latency-chunk2: first pass {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    per_frame = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state, probe = run(state)
        int(probe)
        per_frame.append((time.perf_counter() - t0) / (2 * chain) * 1e3)
    return {
        "metric": f"p50_e2e_latency_{_res(height, '1080p', 1080)}_chunk2_"
                  f"single_stream"
                  + (f"_merge{merge_coarse}" if merge_coarse else ""),
        "value": round(float(np.percentile(per_frame, 50)), 3),
        "unit": "ms/frame",
        "align_success": float(torch.cat(oks)[1:].float().mean()),
        "device": label,
        "note": f"{chain} chained 2-frame single-stream chunks (full "
                f"stabilize incl. output warp), one fetch per rep; "
                f"per-frame ms: {['%.2f' % t for t in per_frame]}",
    }


def bench_latency_request(samples: int, gn: str = "auto", *,
                          height: int = 1080, width: int = 1920,
                          device="cuda"):
    """Single-request latency: the wall time of ONE 2-frame chunk, submit
    to result, with no chaining: what a live caller waits per call
    (the reference's synchronous processFrame loop,
    stabilizer.cpp:9-112). Each request is timed twice: to the fetch of
    its (2,) success flags (the result computed) and to the fetch of its
    whole output frames. Also reports the dispatch floor: p50 of
    ``(x + 1).item()`` on a one-element device tensor."""
    from video_stabilizer_tpu_torch.config import (
        AlignerParams, StabilizerParams)
    from video_stabilizer_tpu_torch.models.chunked import (
        _stabilize_chunk_jit, init_stream_state)
    from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

    dev, label = _setup(device)
    params = StabilizerParams(crop_pixels=32,
                              aligner=AlignerParams(gn_kernel=gn))
    clip = synth_shaky_clip(64, height, width, seed=6, jitter_px=1.0,
                            device=dev)
    state = init_stream_state(width, height, params, 3, 1, dev)

    t0 = time.perf_counter()
    for k in range(8):                  # first use, and fill the lag window
        state, out, meas, ok, valid = _stabilize_chunk_jit(
            state, torch.from_numpy(clip[2 * k:2 * k + 2]).to(dev), params,
            width, height)
    ok.cpu()
    print(f"latency-request: warm-up {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)

    x = torch.ones((), dtype=torch.int32, device=dev)
    (x + 1).item()
    floor = []
    for _ in range(max(64, samples)):
        t0 = time.perf_counter()
        (x + 1).item()
        floor.append((time.perf_counter() - t0) * 1e3)

    # Inputs already on the device: a server's upload is pipelined with
    # the previous request.
    chunks = [torch.from_numpy(clip[2 * k:2 * k + 2]).to(dev)
              for k in range(16)]
    _sync(dev)
    lat_ready, lat_fetch, oks = [], [], []
    for i in range(samples):
        ch = chunks[i % len(chunks)]
        t0 = time.perf_counter()
        state, out, meas, ok, valid = _stabilize_chunk_jit(
            state, ch, params, width, height)
        oks.append(ok.cpu())                 # the result computed
        t1 = time.perf_counter()
        out.cpu()                            # and its frames on the host
        t2 = time.perf_counter()
        lat_ready.append((t1 - t0) * 1e3)
        lat_fetch.append((t2 - t0) * 1e3)

    def pct(v, q):
        return round(float(np.percentile(v, q)), 3)

    return {
        "metric": f"single_request_latency_{_res(height, '1080p', 1080)}_"
                  f"chunk2",
        "value": pct(lat_ready, 50),
        "unit": "ms/request (2 frames)",
        "align_success": float(torch.cat(oks).float().mean()),
        "device": label,
        "note": {
            "p50_ms_submit_to_ready": pct(lat_ready, 50),
            "p99_ms_submit_to_ready": pct(lat_ready, 99),
            "p50_ms_incl_frame_fetch": pct(lat_fetch, 50),
            "p99_ms_incl_frame_fetch": pct(lat_fetch, 99),
            "p50_ms_dispatch_floor": pct(floor, 50),
            "samples": samples,
            "comment": "ONE 2-frame chunk per timing (chain=1); the "
                       "chained latency-chunk2 number is the amortized "
                       "pipelined statistic: quote both",
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--mode",
                    choices=["1080p", "4k", "latency", "latency-chunk2",
                             "latency-request"],
                    default="latency")
    ap.add_argument("--streams", type=int, default=2)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--chain", type=int, default=32)
    ap.add_argument("--samples", type=int, default=100,
                    help="latency-request: number of single-call timings")
    ap.add_argument("--gn", choices=["auto", "xla", "pallas"],
                    default="auto",
                    help="accepted as in the JAX package; the port runs "
                         "its kernels whatever the value")
    ap.add_argument("--fixed-iters", type=int, default=None)
    ap.add_argument("--merge-coarse", type=int, default=0)
    ap.add_argument("--pair-vmap", type=int, default=0,
                    help="1 = AlignerParams.pair_vmap (accepted as in the "
                         "JAX package)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain versions)")
    ap.add_argument("--height", type=int, default=None,
                    help="frame rows (default 1080; 2160 in --mode 4k)")
    ap.add_argument("--width", type=int, default=None,
                    help="frame columns (default 1920; 3840 in --mode 4k)")
    args = ap.parse_args(argv)

    if args.mode == "1080p":
        from video_stabilizer_tpu_torch import bench
        bench.main(device=args.device)
        return 0
    four_k = args.mode == "4k"
    size = dict(height=args.height or (2160 if four_k else 1080),
                width=args.width or (3840 if four_k else 1920),
                device=args.device)
    if four_k:
        result = bench_4k(args.streams, args.frames, args.reps, args.gn,
                          bool(args.pair_vmap), **size)
    elif args.mode == "latency-chunk2":
        result = bench_latency_chunk2(args.reps, args.chain, args.gn,
                                      args.merge_coarse, **size)
    elif args.mode == "latency-request":
        result = bench_latency_request(args.samples, args.gn, **size)
    else:
        result = bench_latency(args.reps, args.chain, args.gn,
                               args.fixed_iters, args.merge_coarse, **size)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
