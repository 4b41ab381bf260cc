"""Chunked streaming-batch stabilization: unbounded streams at batch speed.

Port of ``video_stabilizer_tpu.models.chunked``, for the similarity model
(4 parameters) and the 8-DOF homography model (``model="homography"``,
``batch.model_ops``). A fixed-size ``StreamState`` carries across successive
even-length chunks:

  - the aligner's keyframe carry and the global pair counter,
  - the trailing ``lag + smoother_memory`` measurements,
  - the running accumulated correction,
  - the trailing ``lag`` input frames,

so feeding chunks reproduces the unchunked clip path, and every input frame
eventually receives exactly one output warp. All state lives on the device
with streams on a leading axis S; the index bookkeeping of the JAX package
(chunked.py:23-30) is done in tensor ops, so a chunk needs no host sync
outside the GN plain version. On the card the entry points replay the
chunk as a captured CUDA graph (``_stabilize_chunk_streams_jit``,
``_stabilize_chunk_jit``, utils/graphs.py); ``stabilize_chunk_core`` stays
un-captured for the stage tables and the profiler, which need its Python
frames.

``stream_state_from_numpy`` and ``params_from_jax_dict`` carry a JAX
stream's state and parameters into the port: this system has no learned
weights, and these are its counterpart of carried weights.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch

from video_stabilizer_tpu_torch.config import (  # noqa: F401 (re-export)
    StabilizerParams, params_from_jax_dict)
from video_stabilizer_tpu_torch.device import resolve_device
from video_stabilizer_tpu_torch.models.aligner import LevelKeyData, level_specs
from video_stabilizer_tpu_torch.models.batch import (
    STATICS, PairCarry, align_pairs, fold_jitter, init_pair_carry, model_ops,
    warp_delayed)
from video_stabilizer_tpu_torch.models.smoother import tvl1_smooth
from video_stabilizer_tpu_torch.models.stabilizer import bgr_to_gray_batched
from video_stabilizer_tpu_torch.utils.graphs import Program
from video_stabilizer_tpu_torch.utils.spans import span


class StreamState(NamedTuple):
    """Fixed-size carried state of S stabilization streams."""
    pair: PairCarry              # aligner keyframe carry
    pairs_seen: torch.Tensor     # (S,) int32 global pair counter
    meas_tail: torch.Tensor      # (S, lag + memory, P) trailing measurements
    accum: torch.Tensor          # (S, P) accumulated correction, P = 4 or 8
    frame_tail: torch.Tensor     # (S, lag, H, W[, C]) trailing input frames
    steps_seen: torch.Tensor     # (S,) int32 global frames consumed


def init_stream_state(width: int, height: int, params: StabilizerParams,
                      channels: int = 3, streams: int = 1,
                      device=None, model: str = "similarity") -> StreamState:
    """The pre-stream state (zero history) of ``streams`` streams."""
    dev = resolve_device(device)
    npar = model_ops(model)["nparams"]
    specs = level_specs(width, height, params.aligner)
    tail = params.lag + params.smoother_memory
    shape = ((streams, params.lag, height, width, channels) if channels
             else (streams, params.lag, height, width))
    zeros_i = torch.zeros(streams, dtype=torch.int32, device=dev)
    return StreamState(
        pair=init_pair_carry(specs, streams, dev, model),
        pairs_seen=zeros_i,
        meas_tail=torch.zeros((streams, tail, npar), device=dev),
        accum=torch.zeros((streams, npar), device=dev),
        frame_tail=torch.zeros(shape, dtype=torch.uint8, device=dev),
        steps_seen=zeros_i.clone(),
    )


def _chunk_smoothed(full_meas, steps_seen, tc: int, params: StabilizerParams):
    """The smoothed transform paired with each of the chunk's folds
    (chunked.py:106-135): output j needs smoothed[sm_g], sm_g = steps_seen
    + j - memory, from the window [max(0, sm_g - lag), sm_g + memory]."""
    lag, memory = params.lag, params.smoother_memory
    tail_len = lag + memory
    window = tail_len + 1
    s_n, m_total, npar = full_meas.shape
    dev = full_meas.device
    js = torch.arange(tc, device=dev)[None, :]
    seen = steps_seen.to(torch.int64)[:, None]
    sm_g = seen + js - memory                             # (S, tc)
    start_g = torch.clamp(sm_g - lag, min=0)
    pos_start = start_g - seen + tail_len
    gather = torch.clamp(pos_start[..., None]
                         + torch.arange(window, device=dev), 0, m_total - 1)
    wins = torch.gather(
        full_meas[:, None].expand(s_n, tc, m_total, npar), 2,
        gather[..., None].expand(s_n, tc, window, npar))  # (S, tc, win, P)
    middle = torch.clamp(sm_g - start_g, min=0)
    valid = sm_g + memory - start_g + 1
    sm = tvl1_smooth(wins.transpose(-1, -2), params.lambda_,
                     valid_len=valid[..., None])          # (S, tc, P, win)
    pick = middle[..., None, None].expand(s_n, tc, npar, 1)
    return torch.gather(sm, -1, pick)[..., 0]


def stabilize_chunk_core(state: StreamState, frames, params: StabilizerParams,
                         width: int, height: int, model: str = "similarity"):
    """One chunk of S streams, everything up to (but excluding) the warp.

    Returns (new_state, delayed (S, tc, H, W[, C]), accums (S, tc, P),
    meas (S, tc, P), success (S, tc), out_valid (S, tc)).
    """
    tc = frames.shape[1]
    if tc % 2:
        raise ValueError(f"chunk length {tc} must be even (the aligner "
                         "consumes frames in keyframe pairs)")
    lag, memory = params.lag, params.smoother_memory
    tail_len = lag + memory
    specs = level_specs(width, height, params.aligner)
    dev = frames.device

    with span("gray"):
        gray = bgr_to_gray_batched(frames)
    pair, meas_c, succ_c = align_pairs(gray, specs, params.aligner,
                                       state.pair, state.pairs_seen, model)
    full_meas = torch.cat([state.meas_tail, meas_c], dim=1)
    with span("smooth"):
        if params.enable_smoother:
            smoothed = _chunk_smoothed(full_meas, state.steps_seen, tc,
                                       params)
        else:
            smoothed = torch.zeros_like(meas_c)

    # The accumulator scan (stabilizer.cpp:32-88): reset on the CURRENT
    # step's alignment failure, then fold measurement m = i - lag if any.
    with span("accumulate"):
        meas_m = full_meas[:, memory:memory + tc]
        js = torch.arange(tc, device=dev)[None, :]
        m_valid = state.steps_seen.to(torch.int64)[:, None] + js - lag >= 0
        accum = state.accum
        accums = []
        for j in range(tc):
            accum = torch.where(succ_c[:, j, None], accum,
                                torch.zeros_like(accum))
            folded = fold_jitter(accum, meas_m[:, j], smoothed[:, j], params,
                                 width, height, model)
            accum = torch.where(m_valid[:, j, None], folded, accum)
            accums.append(accum)

    # Output j warps the frame lag steps behind: position j of
    # [carried frame tail | chunk frames].
    all_frames = torch.cat([state.frame_tail, frames], dim=1)
    new_state = StreamState(
        pair=pair,
        pairs_seen=state.pairs_seen + tc // 2,
        meas_tail=full_meas[:, -tail_len:],
        accum=accum,
        frame_tail=all_frames[:, tc:],
        steps_seen=state.steps_seen + tc,
    )
    return (new_state, all_frames[:, :tc], torch.stack(accums, dim=1),
            meas_c, succ_c, m_valid)


def _chunk_streams(states: StreamState, frames, params: StabilizerParams,
                   width: int, height: int, model: str = "similarity"):
    """The chunk program's body: ``stabilize_chunk_core`` and the one warp
    of the whole (S, tc) batch (chunked.py:245-258)."""
    with span("upload"):
        frames = frames.to(states.accum.device)
    new_states, delayed, accums, meas, succ, valid = stabilize_chunk_core(
        states, frames, params, width, height, model)
    with span("warp"):
        out = warp_delayed(delayed, accums, params, width, height, model)
    return new_states, out, meas, succ, valid


def _chunk_one_stream(state: StreamState, frames, params: StabilizerParams,
                      width: int, height: int, model: str = "similarity"):
    new_state, out, meas, succ, valid = _chunk_streams(
        state, frames[None], params, width, height, model)
    return new_state, out[0], meas[0], succ[0], valid[0]


# The JAX package's two chunk programs (chunked.py:237-258): on the card
# each is captured once per static configuration and replayed
# (utils/graphs.py); a host frame tensor is copied straight into the
# graph's input (pinned memory: asynchronously).
_stabilize_chunk_streams_jit = Program(_chunk_streams,
                                       static_argnames=STATICS,
                                       name="_stabilize_chunk_streams_jit")
_stabilize_chunk_jit = Program(_chunk_one_stream, static_argnames=STATICS,
                               name="_stabilize_chunk_jit")


def stabilize_chunk_streams(states: StreamState, frames,
                            params: StabilizerParams,
                            model: str = "similarity"):
    """One chunk of S streams on the states' device, the whole (S, tc)
    batch warped in one launch of kernel A (chunked.py:245-258); on the
    card a replay of ``_stabilize_chunk_streams_jit``.

    Returns (new_states, out (S, tc, H-2c, W-2c[, C]) u8, meas (S, tc, P),
    success (S, tc), out_valid (S, tc)): ``out_valid`` is False for the
    first ``lag`` outputs of a fresh stream.
    """
    frames = torch.as_tensor(frames)
    return _stabilize_chunk_streams_jit(states, frames, params,
                                        frames.shape[3], frames.shape[2],
                                        model)


def stabilize_chunk_impl(state: StreamState, frames,
                         params: StabilizerParams, model: str = "similarity"):
    """One chunk of ONE stream: ``state`` with S = 1, frames
    (tc, H, W[, C]); on the card a replay of ``_stabilize_chunk_jit``."""
    frames = torch.as_tensor(frames)
    return _stabilize_chunk_jit(state, frames, params, frames.shape[2],
                                frames.shape[1], model)


class ChunkedStabilizer:
    """Stateful wrapper: feed even-length chunks of (T, H, W, 3) u8 frames;
    each call returns the stabilized outputs that became valid. ``model``
    selects the 4-DOF similarity or the 8-DOF homography family."""

    def __init__(self, params: StabilizerParams = StabilizerParams(),
                 model: str = "similarity", device=None):
        model_ops(model)
        self.params = params
        self.model = model
        self.device = resolve_device(device)
        self._state = None
        self._shape = None

    def process_chunk(self, frames_bgr):
        frames = torch.as_tensor(frames_bgr)
        h, w = frames.shape[1], frames.shape[2]
        ch = frames.shape[3] if frames.dim() == 4 else 0
        if self._state is None or self._shape != (h, w, ch):
            self._state = init_stream_state(w, h, self.params, ch, 1,
                                            self.device, self.model)
            self._shape = (h, w, ch)
        self._state, out, meas, succ, valid = stabilize_chunk_impl(
            self._state, frames, self.params, self.model)
        return out[valid], meas, succ


def stabilize_stream_chunked(frames_bgr, params: StabilizerParams,
                             chunk_size: int, model: str = "similarity",
                             device=None):
    """Stabilize a (T, H, W[, C]) u8 stream in ``chunk_size``-frame chunks
    (T and chunk_size even). Returns numpy (stabilized (T - lag, ...),
    meas (T, P), success (T,)), the same as the clip path on those frames."""
    dev = resolve_device(device)
    frames = torch.as_tensor(frames_bgr)
    t_total = frames.shape[0]
    if t_total % chunk_size:
        raise ValueError(f"stream length {t_total} must be a multiple of "
                         f"chunk_size {chunk_size}")
    h, w = frames.shape[1], frames.shape[2]
    ch = frames.shape[3] if frames.dim() == 4 else 0
    state = init_stream_state(w, h, params, ch, 1, dev, model)
    outs, meas_all, succ_all = [], [], []
    for start in range(0, t_total, chunk_size):
        state, out, meas, succ, valid = stabilize_chunk_impl(
            state, frames[start:start + chunk_size].to(dev), params, model)
        outs.append(out[valid].cpu().numpy())
        meas_all.append(meas.cpu().numpy())
        succ_all.append(succ.cpu().numpy())
    return (np.concatenate(outs, axis=0), np.concatenate(meas_all, axis=0),
            np.concatenate(succ_all, axis=0))


def _field(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def stream_state_from_numpy(d, model: str = "similarity",
                            device=None) -> StreamState:
    """The port's StreamState from a JAX ``StreamState`` whose leaves are
    numpy arrays (e.g. ``jax.tree.map(np.asarray, state)``), or from a
    mapping with the same field names; ``model`` names the family that
    built it (its keyframes' ``LevelKeyDataH`` carry the same fields as
    ``LevelKeyData``, with an 8-row Jacobian). A single stream (scalar
    ``pairs_seen``) gets a leading stream axis of 1; a stacked batch of
    streams keeps its leading axis."""
    dev = resolve_device(device)
    npar = model_ops(model)["nparams"]
    got = np.shape(_field(d, "accum"))[-1]
    if got != npar:
        raise ValueError(f"a {model} state carries {npar} parameters, this "
                         f"one {got}")
    single = np.ndim(_field(d, "pairs_seen")) == 0

    def conv(x, dtype=None):
        t = torch.from_numpy(np.array(x))
        if dtype is not None:
            t = t.to(dtype)
        return (t[None] if single else t).contiguous().to(dev)

    pair = _field(d, "pair")
    key = tuple(
        LevelKeyData(idx_x=conv(_field(k, "idx_x"), torch.int32),
                     idx_y=conv(_field(k, "idx_y"), torch.int32),
                     coords=conv(_field(k, "coords"), torch.float32),
                     jac=conv(_field(k, "jac"), torch.float32),
                     windows=conv(_field(k, "windows"), torch.uint8))
        for k in _field(pair, "key"))
    return StreamState(
        pair=PairCarry(key_pyr=tuple(conv(p, torch.uint8)
                                     for p in _field(pair, "key_pyr")),
                       key=key),
        pairs_seen=conv(_field(d, "pairs_seen"), torch.int32),
        meas_tail=conv(_field(d, "meas_tail"), torch.float32),
        accum=conv(_field(d, "accum"), torch.float32),
        frame_tail=conv(_field(d, "frame_tail"), torch.uint8),
        steps_seen=conv(_field(d, "steps_seen"), torch.int32),
    )
