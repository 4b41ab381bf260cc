"""The port's failure path and rotational content held to the JAX package:
the scene-cut and black-frame clips of tests/test_failure_injection.py and
a clip with rotation 0.003 / zoom 0.002 jitter (tests/test_rotational_e2e.py's
kind), at 96x128, lag 4, memory 2, crop 8, through the streaming path
(``VideoStabilizer``) and the chunked path (8-frame chunks), each against
the JAX package's same path with the same settings, the tile-local output
warp on both sides (JAX's Pallas kernel in interpret mode)."""

import dataclasses

import numpy as np
import pytest
import torch

from video_stabilizer_tpu import config as jcfg
from video_stabilizer_tpu.models import chunked as jchunked
from video_stabilizer_tpu.models import stabilizer as jstabilizer
from video_stabilizer_tpu_torch.config import params_from_jax_dict
from video_stabilizer_tpu_torch.models import chunked, stabilizer
from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

# Torch's CPU threads would contend with the JAX runtime's in this process;
# at these sizes one thread is several times faster.
torch.set_num_threads(1)

H, W = 96, 128
CHUNK = 8
JPARAMS = jcfg.StabilizerParams(lag=4, smoother_memory=2, crop_pixels=8,
                                output_warp="pallas")
PARAMS = params_from_jax_dict(dataclasses.asdict(JPARAMS))
# The measurements' bars on the rotation clip: the GN class of
# test_torch_streaming.py::_assert_meas_close for TX/TY, and 1e-3 for A/B,
# which this clip's A/B (up to 7.8e-3) carries further than the 6e-4 of
# clips with less rotation. Measured: 0.076 px and 6.1e-4.
T_BAR, AB_BAR = 0.1, 1e-3


def scene_cut_clip():
    """tests/test_failure_injection.py::scene_cut_clip: two unrelated
    scenes, the cut at frame 12."""
    a = synth_shaky_clip(12, H, W, seed=301, jitter_px=0.6,
                         pan_px_per_frame=0.2)
    b = synth_shaky_clip(12, H, W, seed=777, jitter_px=0.6,
                         pan_px_per_frame=0.2)
    return np.concatenate([a, b], axis=0)


def black_frame_clip():
    """tests/test_failure_injection.py::black_frame_clip: frames 11-12
    black."""
    frames = synth_shaky_clip(24, H, W, seed=302, jitter_px=0.6,
                              pan_px_per_frame=0.2).copy()
    frames[11:13] = 0
    return frames


def rotation_clip():
    return synth_shaky_clip(24, H, W, seed=61, jitter_px=0.8,
                            pan_px_per_frame=0.2, rot_jitter=0.003,
                            zoom_jitter=0.002)


CLIPS = {"scene_cut": scene_cut_clip, "black_frames": black_frame_clip,
         "rotation": rotation_clip}


def _streaming(stab, frames):
    """(outputs, meas (T, 4), ok (T,), align_failures) of a JAX or port
    VideoStabilizer over ``frames``."""
    align = stab.aligner.align_next_frame
    rec = []

    def recorded(gray):
        t, ok = align(gray)
        rec.append((np.asarray(t.cpu() if torch.is_tensor(t) else t,
                               np.float64), bool(ok)))
        return t, ok

    stab.aligner.align_next_frame = recorded
    outs = []
    for f in frames:
        o = stab.process_frame(f)
        if o is not None:
            outs.append(o.cpu().numpy() if torch.is_tensor(o)
                        else np.asarray(o))
    return (np.stack(outs), np.array([m for m, _ in rec]),
            np.array([k for _, k in rec]), stab.align_failures)


def _check(got, want, name):
    """ok equal, the same failure count, >= 99.9 % of output pixels within
    1 LSB; on the rotation clip TX/TY within T_BAR px and A/B within
    AB_BAR, with the clip's A/B at least 5x that bar."""
    (out, meas, ok, fails), (out_j, meas_j, ok_j, fails_j) = got, want
    np.testing.assert_array_equal(ok, ok_j)
    assert fails == fails_j
    assert out.shape == out_j.shape
    diff = np.abs(out.astype(np.int32) - out_j.astype(np.int32))
    assert np.mean(diff <= 1) >= 0.999, np.mean(diff <= 1)
    if name == "rotation":
        assert ok[1:].all()
        np.testing.assert_allclose(meas[:, 2:], meas_j[:, 2:], atol=T_BAR)
        np.testing.assert_allclose(meas[:, :2], meas_j[:, :2], atol=AB_BAR)
        assert np.abs(meas_j[1:, :2]).max() >= 5 * AB_BAR
    else:
        assert not ok[1:].all() and fails > 0


@pytest.mark.parametrize("name", list(CLIPS))
def test_streaming_matches_jax(name):
    frames = CLIPS[name]()
    want = _streaming(jstabilizer.VideoStabilizer(JPARAMS), frames)
    got = _streaming(stabilizer.VideoStabilizer(PARAMS, device="cpu"),
                     frames)
    _check(got, want, name)


@pytest.mark.parametrize("name", list(CLIPS))
def test_chunked_matches_jax(name):
    frames = CLIPS[name]()
    runs = []
    for fn, params, kw in (
            (jchunked.stabilize_stream_chunked, JPARAMS, {}),
            (chunked.stabilize_stream_chunked, PARAMS, dict(device="cpu"))):
        out, meas, ok = fn(frames, params, CHUNK, **kw)
        ok = np.asarray(ok)
        runs.append((np.asarray(out), np.asarray(meas), ok,
                     int((~ok[1:]).sum())))
    _check(runs[1], runs[0], name)
