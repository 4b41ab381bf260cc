"""The serving soak of ``tests/test_soak.py`` on the CUDA card.

The same schedule as the JAX package's soak, not shortened: 5,000
two-frame chunks (10,000 frames of 64x48, a content jump every 1,000
frames) through one stream of the port's ``_stabilize_chunk_jit``, and the
port's streaming ``VideoStabilizer`` over the same frames, with the JAX
soak's bars: the state finite and ``||accum|| < 64`` every 500 chunks, the
counters exact, the last 128 outputs of both within 1 LSB on > 99 % of
pixels, the output jitter under 0.6x the input's. On the card every chunk
is a replay of one captured graph, so the soak also holds what the JAX
soak cannot: one capture and 4,999 replays, the card's reserved memory
flat within 16 MB on both sides, kernels A and B launched on both.

Marked ``soak``; it skips without a card, so the CPU runs only the check
that its frames are the JAX soak's. On the card, from the repository's
root (the card's machine has no JAX, so pytest is told to skip
``tests/conftest.py``)::

    python -m pytest tests/test_torch_soak.py -m soak -q -rA --noconftest

``python tests/test_torch_soak.py N`` runs the first N chunks of both
sides on the card and prints their times and memory readings as JSON.
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from video_stabilizer_tpu_torch.config import StabilizerParams
from video_stabilizer_tpu_torch.models import chunked
from video_stabilizer_tpu_torch.models.stabilizer import VideoStabilizer
from video_stabilizer_tpu_torch.utils import graphs, jitter
from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

H, W = 48, 64
N_CHUNKS = 5000
SEGMENT = 1000            # frames per content segment
KEEP = 128                # outputs compared at the end
CHECK_EVERY = 500         # chunks between state checks
PARAMS = StabilizerParams(lag=4, smoother_memory=2, crop_pixels=4)
DRIFT_BYTES = 16e6        # reserved memory allowed to move over the run
STREAM_FIRST_READ = 100   # the streaming side's first memory reading


def soak_frames(frames):
    """The first ``frames`` of the soak's input: segments of 1,000 shaky
    frames, seed 1000 + k, whose content jumps at each boundary."""
    segs = [synth_shaky_clip(SEGMENT, H, W, seed=1000 + k, jitter_px=0.6,
                             pan_px_per_frame=0.1)
            for k in range(-(-frames // SEGMENT))]
    return np.concatenate(segs, axis=0)[:frames]


def _launches():
    counts = graphs.launch_counts()
    return {"gn_solve": counts[("gn_solve", None)],
            "warp_frames": counts[("warp_frames", None)]}


def _zero_launches():
    graphs.add_launches({k: -n for k, n in graphs.launch_counts().items()})


def _reserved(dev):
    torch.cuda.synchronize(dev)
    return torch.cuda.memory_reserved(dev)


def chunked_side(frames, dev):
    """Every two frames through ``_stabilize_chunk_jit`` with the state
    carried: the state checks, the last KEEP valid outputs, the launches,
    each call's host ms (up to its outputs on the host), the reserved
    memory after the first and the last chunk and at each state check."""
    prog = chunked._stabilize_chunk_jit
    graphs.reset([prog])
    _zero_launches()
    state = chunked.init_stream_state(W, H, PARAMS, 3, device=dev)
    n = len(frames) // 2
    tail, norms, finite, ms, trace = [], [], True, [], []
    for k in range(n):
        t0 = time.perf_counter()
        state, out, _, _, valid = prog(
            state, torch.from_numpy(frames[2 * k:2 * k + 2]), PARAMS, W, H)
        out = out[valid].cpu().numpy()
        ms.append((time.perf_counter() - t0) * 1e3)
        if k == 0:
            first = _reserved(dev)
        if k % CHECK_EVERY == 0 or k == n - 1:
            accum = state.accum.cpu().numpy()
            finite &= bool(np.isfinite(accum).all()
                           and torch.isfinite(state.meas_tail).all())
            norms.append(float(np.linalg.norm(accum)))
            trace.append(torch.cuda.memory_reserved(dev))
        tail = (tail + list(out))[-KEEP:]
    return dict(tail=np.stack(tail), norms=norms, finite=finite,
                steps_seen=int(state.steps_seen), pairs_seen=int(
                    state.pairs_seen), captures=prog.captures,
                replays=prog.replays, launches=_launches(),
                reserved=(first, _reserved(dev)), trace=trace,
                ms=np.asarray(ms))


def streaming_side(frames, dev):
    """Every frame through ``VideoStabilizer``: the last KEEP outputs, the
    launches, each frame's host ms (up to its output on the host) and the
    reserved memory after frame STREAM_FIRST_READ and the last frame."""
    _zero_launches()
    stab = VideoStabilizer(PARAMS, device=dev)
    tail, ms = [], []
    for i, frame in enumerate(frames):
        t0 = time.perf_counter()
        out = stab.process_frame(frame)
        if out is not None:
            tail = (tail + [out.cpu().numpy()])[-KEEP:]
        ms.append((time.perf_counter() - t0) * 1e3)
        if i + 1 == STREAM_FIRST_READ:
            first = _reserved(dev)
    return dict(tail=np.stack(tail), launches=_launches(),
                reserved=(first, _reserved(dev)), ms=np.asarray(ms))


def run_soak(n_chunks, dev):
    """Both sides over the first ``n_chunks`` chunks' frames, each timed."""
    frames = soak_frames(2 * n_chunks)
    graphs.reset()
    t0 = time.perf_counter()
    chunk = chunked_side(frames, dev)
    t1 = time.perf_counter()
    stream = streaming_side(frames, dev)
    t2 = time.perf_counter()
    return frames, chunk, stream, (t1 - t0, t2 - t1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("the soak runs on a CUDA card, and there is none")
    return torch.device("cuda")


@pytest.mark.soak
def test_serving_soak_5k_chunks_on_the_card(monkeypatch):
    dev = _card()
    # Without cv2 (as on the card's machine) the jitter metric is the
    # port's dense-LK one on the card.
    monkeypatch.setenv("VIDSTAB_ALLOW_JITTER_FALLBACK", "1")
    frames, chunk, stream, seconds = run_soak(N_CHUNKS, dev)

    assert chunk["finite"], chunk["norms"]
    assert max(chunk["norms"]) < 64.0, chunk["norms"]
    assert chunk["steps_seen"] == 2 * N_CHUNKS
    assert chunk["pairs_seen"] == N_CHUNKS
    assert (chunk["captures"], chunk["replays"]) == (1, N_CHUNKS - 1)
    for side in (chunk, stream):
        first, last = side["reserved"]
        assert abs(last - first) <= DRIFT_BYTES, side["reserved"]
        assert side["launches"]["gn_solve"] > 0, side["launches"]
        assert side["launches"]["warp_frames"] > 0, side["launches"]

    a, b = chunk["tail"], stream["tail"]
    assert a.shape == b.shape == (KEEP, H - 2 * PARAMS.crop_pixels,
                                  W - 2 * PARAMS.crop_pixels, 3)
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    frac = float(np.mean(diff <= 1))
    assert frac > 0.99, frac

    in_j = jitter.median_jitter_px(list(frames[-KEEP:]), device=dev)
    out_j = jitter.median_jitter_px(list(a), device=dev)
    assert out_j < 0.6 * in_j, (in_j, out_j)
    print(json.dumps(_summary(chunk, stream, seconds)
                     | dict(within_1_lsb=frac, in_jitter_px=in_j,
                            out_jitter_px=out_j)))


def _summary(chunk, stream, seconds) -> dict:
    return dict(
        card=torch.cuda.get_device_name(0), seconds=list(seconds),
        chunk_ms_median=float(np.median(chunk["ms"])),
        frame_ms_median=float(np.median(stream["ms"])),
        chunk_reserved=list(chunk["reserved"]),
        chunk_reserved_every_500=chunk["trace"],
        stream_reserved=list(stream["reserved"]),
        captures=chunk["captures"], replays=chunk["replays"],
        chunk_launches=chunk["launches"], stream_launches=stream["launches"],
        max_accum_norm=max(chunk["norms"]))


def test_soak_frames_are_the_jax_soaks(monkeypatch):
    """The first segment (1,000 frames, seed 1000) equals what the JAX
    soak's ``_soak_frames`` makes for it. JAX is imported here, not at the
    top: the soak itself runs where JAX is not installed."""
    import test_soak
    monkeypatch.setattr(test_soak, "T", SEGMENT)
    assert np.array_equal(soak_frames(SEGMENT), test_soak._soak_frames())


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 250
    os.environ.setdefault("VIDSTAB_ALLOW_JITTER_FALLBACK", "1")
    _, chunk, stream, seconds = run_soak(n, torch.device("cuda"))
    print(json.dumps(_summary(chunk, stream, seconds)))
