"""Checkpoint and resume of the streaming stabilizer.

Port of ``video_stabilizer_tpu.utils.checkpoint`` (checkpoint.py:39-125):
the aligner state, the smoother ring, the measurement and frame queues and
the accumulator in one ``.npz``, under the same keys, so that a file the JAX
package's ``save_stabilizer`` wrote loads into the port's
``VideoStabilizer``, and the other way round.

The aligner state is stored as its leaves in the JAX package's pytree order
of ``AlignerState`` (what ``jax.tree.flatten`` gives), 6L + 2 of them for L
pyramid levels:

  - the L pyramid levels, each (2, h, w) u8;
  - per level ``idx_x``, ``idx_y`` (ht, wt) int32, ``coords`` (2, 2, N) and
    ``jac`` (4, 2, N) float32, ``windows`` (P, P, N) u8;
  - ``curr_idx`` and ``frames_seen``, 0-d int32.

The port's keyframe data carries a leading K = 1 axis that the file does
not, and keeps its windows keypoint-major, (N, P, P) (``ops/patches.py``):
the file keeps the JAX package's (P, P, N), so the windows are permuted on
the way out and back in. The JAX package stores bfloat16 windows (its
Pallas GN kernel's operand, aligner.py:126-127) as float32
(checkpoint.py:23-30); they load as u8 and must hold integers.
"""

from __future__ import annotations

import collections
import json

import numpy as np
import torch

from video_stabilizer_tpu_torch.models.aligner import (
    AlignerState, LevelKeyData, init_state)

# LevelKeyData's fields in pytree order.
KEY_FIELDS = LevelKeyData._fields


def _file_field(name: str, x: torch.Tensor) -> torch.Tensor:
    """One keyframe's field as the file holds it: the windows (N, P, P) as
    (P, P, N), every other field as it is."""
    return x.permute(1, 2, 0) if name == "windows" else x


def leaf_shapes(state: AlignerState) -> list[tuple]:
    """The shapes of ``state``'s leaves in the JAX package's pytree
    order."""
    shapes = [tuple(p.shape) for p in state.pyramid]
    for kd in state.key:
        shapes += [tuple(_file_field(f, getattr(kd, f)[0]).shape)
                   for f in KEY_FIELDS]
    return shapes + [(), ()]


def state_leaves(state: AlignerState) -> list[np.ndarray]:
    """``state`` as numpy leaves in the JAX package's pytree order."""
    leaves = [p.cpu().numpy() for p in state.pyramid]
    for kd in state.key:
        leaves += [np.ascontiguousarray(
            _file_field(f, getattr(kd, f)[0]).cpu().numpy())
            for f in KEY_FIELDS]
    return leaves + [np.asarray(state.curr_idx, np.int32),
                     np.asarray(state.frames_seen, np.int32)]


def _to_tensor(arr, like: torch.Tensor, what: str, name: str = ""):
    arr = np.asarray(arr)
    if name == "windows":
        arr = np.moveaxis(arr, -1, 0)        # (P, P, N) -> (N, P, P)
    if like.dtype == torch.uint8 and arr.dtype != np.uint8:
        # bfloat16 windows stored as float32: exact only if integral.
        if not (np.array_equal(arr, np.round(arr))
                and arr.min(initial=0) >= 0 and arr.max(initial=0) <= 255):
            raise ValueError(f"{what}: {arr.dtype} values are not all "
                             "integers in [0, 255]")
        arr = arr.astype(np.uint8)
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(like.dtype)
    return t.reshape(like.shape).to(like.device)


def state_from_leaves(leaves, template: AlignerState) -> AlignerState:
    """An AlignerState from leaves in the JAX package's pytree order, shaped
    and placed as ``template`` (``init_state`` with the same resolution,
    params and device). Raises on a count or shape mismatch."""
    shapes = leaf_shapes(template)
    leaves = list(leaves)
    if len(leaves) != len(shapes):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves; current state wants "
            f"{len(shapes)} (resolution or params mismatch)")
    for i, (leaf, shape) in enumerate(zip(leaves, shapes)):
        if np.shape(leaf) != shape:
            raise ValueError(f"leaf {i} shape {np.shape(leaf)} != {shape}")
    n_levels = len(template.pyramid)
    pyramid = tuple(_to_tensor(leaves[i], p, f"leaf {i}")
                    for i, p in enumerate(template.pyramid))
    key = []
    for lvl, kd in enumerate(template.key):
        base = n_levels + 5 * lvl
        key.append(LevelKeyData(*(
            _to_tensor(leaves[base + j], getattr(kd, f), f"leaf {base + j}",
                       f)
            for j, f in enumerate(KEY_FIELDS))))
    return AlignerState(pyramid=pyramid, key=tuple(key),
                        curr_idx=int(leaves[-2]), frames_seen=int(leaves[-1]))


def save_aligner_state(path: str, state: AlignerState) -> None:
    leaves = state_leaves(state)
    np.savez_compressed(path, n=len(leaves),
                        **{f"leaf_{i}": x for i, x in enumerate(leaves)})


def load_aligner_state(path: str, template_state: AlignerState):
    """Restore into the shapes and device of ``template_state``."""
    with np.load(path) as data:
        leaves = [data[f"leaf_{i}"] for i in range(int(data["n"]))]
    return state_from_leaves(leaves, template_state)


def save_stabilizer(path: str, stab) -> None:
    """Serialize a ``models.stabilizer.VideoStabilizer`` mid-stream."""
    payload = {
        "meta": np.frombuffer(json.dumps({
            "frame_index": stab.frame_index,
            "align_failures": stab.align_failures,
            "smoother_total": stab.smoother._total,
            "smoother_next": stab.smoother._next_to_finalize,
            "aligner_shape": list(stab.aligner._shape or []),
        }).encode(), dtype=np.uint8),
        "accum": stab._accum,
        "meas": np.asarray(list(stab._meas), np.float64).reshape(-1, 4)
        if stab._meas else np.zeros((0, 4)),
        "smoother_buf": stab.smoother._buf,
    }
    for i, f in enumerate(stab._frames):
        payload[f"frame_{i}"] = f.cpu().numpy()
    if stab.aligner._state is not None:
        leaves = state_leaves(stab.aligner._state)
        payload["n_leaves"] = np.asarray(len(leaves))
        for i, x in enumerate(leaves):
            payload[f"leaf_{i}"] = x
    np.savez_compressed(path, **payload)


def load_stabilizer(path: str, params=None, device=None):
    """A ``VideoStabilizer`` on ``device`` (the CUDA card unless given)
    restored from a checkpoint of the port or of the JAX package; it resumes
    mid-stream where the saved one stopped."""
    from video_stabilizer_tpu_torch.config import StabilizerParams
    from video_stabilizer_tpu_torch.models.stabilizer import VideoStabilizer

    stab = VideoStabilizer(params or StabilizerParams(), device)
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        stab.frame_index = meta["frame_index"]
        stab.align_failures = meta["align_failures"]
        stab._accum = np.asarray(data["accum"], np.float64)
        stab._meas = collections.deque(np.asarray(data["meas"], np.float64))
        stab.smoother._total = meta["smoother_total"]
        stab.smoother._next_to_finalize = meta["smoother_next"]
        stab.smoother._buf = np.asarray(data["smoother_buf"], np.float64)
        frames, i = [], 0
        while f"frame_{i}" in data:
            frames.append(torch.from_numpy(data[f"frame_{i}"]).to(
                stab.device))
            i += 1
        stab._frames = collections.deque(frames)
        if "n_leaves" in data and meta["aligner_shape"]:
            h, w = meta["aligner_shape"]
            template = init_state(w, h, stab.params.aligner, stab.device)
            stab.aligner._state = state_from_leaves(
                [data[f"leaf_{k}"] for k in range(int(data["n_leaves"]))],
                template)
            stab.aligner._shape = (h, w)
    return stab
