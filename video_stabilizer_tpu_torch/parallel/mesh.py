"""Streams split over devices: the port of ``video_stabilizer_tpu.parallel.
mesh``.

The JAX package shards the stream axis of an (S, ...) batch over a 1-D
device mesh and runs each device's streams under ``shard_map``: every
stream's pipeline is independent, so the program has no collective. Torch
has no global array and no SPMD program. Here a ``Mesh`` is an ordered
tuple of devices, and a sharded value is a ``Sharded``: one tensor (or one
``StreamState``) per device, holding a contiguous block of streams, with the
global stream offset of each block. Each call runs the port's unsharded
function once per shard, on the shard's device, on that shard's tensors
only. No operation reads another shard's tensors: that is this port's form
of the zero-collective program.

On the card each shard replays its own card's captured graph: the chunk
program (``chunked._stabilize_chunk_streams_jit``) for a chunk, the clip
program (``batch._stabilize_streams_jit``) for a clip. A program's cache key
holds its tensors' device, so each card captures its own graph once and
replays it; no graph spans two cards. That is the counterpart of the JAX
package's ``_stabilize_sharded_jit`` (mesh.py:51) and its sharded chunk
(mesh.py:119), local programs under ``shard_map`` with zero collectives,
and needs no program of its own.

One host thread issues the shards in turn: a shard costs it one graph
launch and the copies in and out. Whether N cards then run N times as many
streams is not measured; only one card has been.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from video_stabilizer_tpu_torch.config import StabilizerParams
from video_stabilizer_tpu_torch.device import resolve_device
from video_stabilizer_tpu_torch.models.batch import stabilize_streams
from video_stabilizer_tpu_torch.models.chunked import (
    init_stream_state, stabilize_chunk_streams)

STREAM_AXIS = "streams"


class Mesh(NamedTuple):
    """A 1-D mesh: the devices in stream order, and the axis's name."""
    devices: tuple[torch.device, ...]
    axis_name: str = STREAM_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


class Sharded(NamedTuple):
    """A value whose leading stream axis is split over a mesh: ``shards[k]``
    lives on the mesh's k-th device and holds the streams from global index
    ``offsets[k]`` on."""
    shards: tuple
    offsets: tuple[int, ...]


def tensor_leaves(value) -> list:
    """The tensors of a tensor or a nested tuple of them (a ``StreamState``,
    a ``Sharded``), in order."""
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, tuple):
        return [t for v in value for t in tensor_leaves(v)]
    return []


def make_mesh(devices=None, axis_name: str = STREAM_AXIS) -> Mesh:
    """A 1-D mesh over every CUDA device, or over the given devices. Raises
    when no device is given and there is no card: a CPU mesh is built only
    from an explicit list (``[torch.device("cpu")] * n``)."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device is available; pass devices= "
                               "to build a mesh of other devices")
        devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh(tuple(resolve_device(d) for d in devices), axis_name)


def _check_divisible(streams: int, mesh: Mesh) -> int:
    if streams % mesh.size:
        raise ValueError(f"stream count {streams} not divisible by mesh size "
                         f"{mesh.size}")
    return streams // mesh.size


def _on(dev: torch.device):
    """Make ``dev`` the current CUDA device (the kernels launch there)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def shard_streams(batch, mesh: Mesh) -> Sharded:
    """Block-split an (S, ...) array or tensor over the mesh: stream s goes
    to device ``s // (S / n)``. A ``Sharded`` value passes through."""
    if isinstance(batch, Sharded):
        if len(batch.shards) != mesh.size:
            raise ValueError(f"{len(batch.shards)} shards for a mesh of "
                             f"{mesh.size}")
        return batch
    batch = torch.as_tensor(batch)
    per = _check_divisible(batch.shape[0], mesh)
    return Sharded(
        tuple(batch[k * per:(k + 1) * per].to(dev)
              for k, dev in enumerate(mesh.devices)),
        tuple(k * per for k in range(mesh.size)))


def stabilize_streams_sharded(frames_bgr, mesh: Mesh,
                              params: StabilizerParams = StabilizerParams()):
    """Stabilize (S, T, H, W, 3) u8 with S split over ``mesh`` (S divisible
    by the mesh size): the port's ``stabilize_streams`` per shard, which on
    a card replays that card's ``_stabilize_streams_jit`` graph. Returns
    (stabilized, measurements, success), each ``Sharded`` like the input."""
    frames = shard_streams(frames_bgr, mesh)
    results = []
    for dev, shard in zip(mesh.devices, frames.shards):
        with _on(dev):
            results.append(stabilize_streams(shard, params, dev))
    return tuple(Sharded(tuple(r[i] for r in results), frames.offsets)
                 for i in range(3))


def init_sharded_stream_states(n_streams: int, width: int, height: int,
                               params: StabilizerParams, mesh: Mesh,
                               channels: int = 3,
                               model: str = "similarity") -> Sharded:
    """The pre-stream ``StreamState`` of ``n_streams`` streams, one state per
    device for its block of streams; each stays on its device across
    chunks."""
    per = _check_divisible(n_streams, mesh)
    return Sharded(
        tuple(init_stream_state(width, height, params, channels, per, dev,
                                model) for dev in mesh.devices),
        tuple(k * per for k in range(mesh.size)))


def stabilize_chunk_streams_sharded(states: Sharded, frames_bgr, mesh: Mesh,
                                    params: StabilizerParams,
                                    model: str = "similarity"):
    """One serving step for S sharded unbounded streams: an even-length
    (S, Tc, H, W, C) u8 chunk (or its ``Sharded`` form), carrying ``states``
    (from ``init_sharded_stream_states`` or a previous call) across calls.

    Returns (new_states, out, meas, success, out_valid), each ``Sharded``;
    per stream the same as the unsharded ``stabilize_chunk_streams``.
    """
    frames = shard_streams(frames_bgr, mesh)
    if states.offsets != frames.offsets:
        raise ValueError(f"state shards start at streams {states.offsets}, "
                         f"frame shards at {frames.offsets}")
    results = []
    for dev, state, shard in zip(mesh.devices, states.shards, frames.shards):
        with _on(dev):
            results.append(stabilize_chunk_streams(state, shard, params,
                                                   model))
    return tuple(Sharded(tuple(r[i] for r in results), frames.offsets)
                 for i in range(5))
