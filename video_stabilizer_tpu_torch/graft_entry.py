"""Entry points of the port for an external harness: a one-device step
and the multi-device dry run (the JAX package's ``__graft_entry__.py``)."""

from __future__ import annotations

import numpy as np
import torch

from video_stabilizer_tpu_torch.config import StabilizerParams
from video_stabilizer_tpu_torch.device import resolve_device


def entry(device=None):
    """The whole clip pipeline (align, smooth, accumulate, warp) on a short
    180x320 BGR clip of 8 frames, on the card unless ``device`` says
    otherwise. Returns (fn, example_args); ``fn(clip)`` gives the stabilized
    (4, 164, 304, 3) u8 frames."""
    from video_stabilizer_tpu_torch.models.batch import stabilize_clip

    dev = resolve_device(device)
    params = StabilizerParams(lag=4, smoother_memory=2, crop_pixels=8)
    t, h, w = 8, 180, 320
    rng = np.random.default_rng(0)
    clip = torch.from_numpy(
        rng.integers(0, 255, size=(t, h, w, 3), dtype=np.uint8)).to(dev)

    def fn(frames):
        out, meas, ok = stabilize_clip(frames, params, dev)
        return out

    return fn, (clip,)


def _expect(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Split an ``n_devices``-stream batch over a mesh of ``n_devices`` and
    run two chunks of the chunked serving path with carried state, then the
    clip path, checking shapes and that each state shard holds exactly its
    own streams on its own device.

    ``devices`` defaults to the first ``n_devices`` CUDA cards and raises
    when there are fewer; a CPU mesh is run only when asked for
    (``devices=[torch.device("cpu")] * n``)."""
    from video_stabilizer_tpu_torch.parallel import (
        init_sharded_stream_states, make_mesh,
        stabilize_chunk_streams_sharded, stabilize_streams_sharded)
    from video_stabilizer_tpu_torch.parallel.mesh import tensor_leaves

    if devices is None:
        have = torch.cuda.device_count()
        if have < n_devices:
            raise RuntimeError(f"need {n_devices} CUDA devices, have {have}; "
                               "pass devices= to run on others")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    _expect(len(devices) == n_devices,
            f"need {n_devices} devices, got {len(devices)}")
    mesh = make_mesh(devices)

    params = StabilizerParams(lag=4, smoother_memory=2, crop_pixels=4)
    s, t, h, w = n_devices, 8, 48, 64
    rng = np.random.default_rng(1)
    clips = rng.integers(0, 255, size=(s, t, h, w, 3), dtype=np.uint8)
    crop = 2 * params.crop_pixels

    # The chunked serving path over two chunks, so that the state carries.
    states = init_sharded_stream_states(s, w, h, params, mesh)
    chunk = t // 2
    for k in range(2):
        states, out_c, meas_c, ok_c, valid_c = stabilize_chunk_streams_sharded(
            states, clips[:, k * chunk:(k + 1) * chunk], mesh, params)
    _expect([tuple(o.shape) for o in out_c.shards]
            == [(1, chunk, h - crop, w - crop, 3)] * s,
            f"chunk output shards {[tuple(o.shape) for o in out_c.shards]}")
    for k, (dev, st) in enumerate(zip(mesh.devices, states.shards)):
        _expect(all(x.device == dev and x.shape[0] == 1
                    for x in tensor_leaves(st)),
                f"state shard {k} holds other streams or lies off {dev}")
    _expect(states.offsets == tuple(range(s)),
            f"state shard offsets {states.offsets}")

    # The clip path on the same mesh.
    out, meas, ok = stabilize_streams_sharded(clips, mesh, params)
    _expect([tuple(o.shape) for o in out.shards]
            == [(1, t - params.lag, h - crop, w - crop, 3)] * s,
            f"clip output shards {[tuple(o.shape) for o in out.shards]}")
    _expect([tuple(m.shape) for m in meas.shards] == [(1, t, 4)] * s,
            f"measurement shards {[tuple(m.shape) for m in meas.shards]}")
    print(f"dryrun_multichip OK: {n_devices} devices "
          f"({', '.join(map(str, mesh.devices))}), chunked-serving out "
          f"{s} x {tuple(out_c.shards[0].shape)}, state shards of 1 stream "
          f"each, clip out {s} x {tuple(out.shards[0].shape)}")
