"""Multi-process scale-out of the stream-split pipeline: the port of
``video_stabilizer_tpu.parallel.multihost``.

Streams stay independent across hosts as across devices, so three things
are all that change, as in the JAX package:

1. **Process bring-up.** ``initialize_multihost`` starts
   ``torch.distributed`` when a coordinator is given (arguments or
   ``MASTER_ADDR``); each process then knows its rank and the world size.
2. **Ingest locality.** Each process feeds only the streams whose shards
   live on its own devices (``local_stream_slice``,
   ``make_global_stream_batch``). Input frames are the only thing that
   moves, once, from the host to its own cards; activations and carried
   state never leave their device, and no collective runs.
3. **Order.** Streams are block-split over the processes in rank order,
   and within a process over its devices in mesh order.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from video_stabilizer_tpu_torch.parallel.mesh import (
    STREAM_AXIS, Mesh, Sharded, make_mesh)

# Set by this module after it started the process group, so that a second
# call is a no-op.
_initialized = False


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None) -> None:
    """Start ``torch.distributed`` when running multi-process: with
    ``coordinator_address`` ("host:port"), or from the ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` environment. A no-op when
    neither is given (one process) and on a second call. ``backend`` is
    ``"nccl"`` (the default) for meshes of CUDA devices and ``"gloo"`` for
    CPU meshes."""
    global _initialized
    if coordinator_address is None and "MASTER_ADDR" not in os.environ:
        return
    if _initialized:
        return
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(backend or "nccl", init_method=init, **kw)
    _initialized = True


def _rank_and_world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_stream_slice(total_streams: int) -> slice:
    """The half-open range of global stream indices this process feeds (the
    whole range when ``torch.distributed`` is not initialized)."""
    rank, world = _rank_and_world()
    per = total_streams // world
    return slice(rank * per, (rank + 1) * per)


def make_global_stream_batch(local_frames, mesh: Mesh,
                             total_streams: int) -> Sharded:
    """This process's (S_local, T, H, W, C) streams, S_local = S_total /
    world size, block-split over its own devices, with their global stream
    offsets."""
    local_frames = np.asarray(local_frames)
    s_local = local_frames.shape[0]
    if s_local % mesh.size:
        raise ValueError(f"local stream count {s_local} not divisible by "
                         f"{mesh.size} local devices")
    mine = local_stream_slice(total_streams)
    if mine.stop - mine.start != s_local:
        raise ValueError(f"this process feeds streams {mine.start}-"
                         f"{mine.stop - 1} of {total_streams}, not "
                         f"{s_local}")
    per = s_local // mesh.size
    return Sharded(
        tuple(torch.from_numpy(local_frames[k * per:(k + 1) * per]).to(dev)
              for k, dev in enumerate(mesh.devices)),
        tuple(mine.start + k * per for k in range(mesh.size)))


def multihost_mesh(devices=None, axis_name: str = STREAM_AXIS) -> Mesh:
    """The mesh of this process's devices: every local CUDA card unless
    given."""
    return make_mesh(devices, axis_name)
