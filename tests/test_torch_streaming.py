"""The port's streaming path (VideoAligner, L1SmootherCenter, VideoStabilizer,
checkpoint resume) held to the JAX package's on the same clips, with the
Pallas output warp in interpret mode, and to the port's own clip path."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from video_stabilizer_tpu import config as jcfg
from video_stabilizer_tpu.models import aligner as jaligner
from video_stabilizer_tpu.models import smoother as jsmoother
from video_stabilizer_tpu.models import stabilizer as jstabilizer
from video_stabilizer_tpu.utils import checkpoint as jcheckpoint
from video_stabilizer_tpu_torch.config import params_from_jax_dict
from video_stabilizer_tpu_torch.models import aligner, smoother, stabilizer
from video_stabilizer_tpu_torch.models.batch import align_clip
from video_stabilizer_tpu_torch.utils import checkpoint
from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

# Torch's CPU threads would contend with the JAX runtime's in this process;
# at these sizes one thread is several times faster.
torch.set_num_threads(1)

H, W, N = 96, 128, 20
H2, W2 = 80, 112                  # the second resolution of a stream
HALF = N // 2
JPARAMS = jcfg.StabilizerParams(lag=4, smoother_memory=2, crop_pixels=8,
                                output_warp="pallas")
PARAMS = params_from_jax_dict(dataclasses.asdict(JPARAMS))


def _clip(seed, n=N, h=H, w=W, **kw):
    return synth_shaky_clip(n, h, w, seed=seed, jitter_px=0.8,
                            pan_px_per_frame=0.3, **kw)


def _lsb_diff(a, b):
    return np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))


def _run(stab, frames, record):
    """Feed ``frames`` to a JAX or port VideoStabilizer; returns its outputs
    as numpy, and appends each frame's (meas, ok) to ``record``."""
    align = stab.aligner.align_next_frame

    def recorded(gray):
        t, ok = align(gray)
        record.append((np.asarray(t.cpu() if torch.is_tensor(t) else t,
                                  np.float64), bool(ok)))
        return t, ok

    stab.aligner.align_next_frame = recorded
    outs = []
    for f in frames:
        o = stab.process_frame(f)
        if o is not None:
            outs.append(o.cpu().numpy() if torch.is_tensor(o)
                        else np.asarray(o))
    stab.aligner.align_next_frame = align
    return outs


def _assert_outputs_close(outs, want):
    """Same count and shapes; >= 99 % of pixels within 1 LSB."""
    assert [o.shape for o in outs] == [o.shape for o in want]
    diff = np.concatenate([_lsb_diff(a, b).ravel()
                           for a, b in zip(outs, want)])
    assert np.mean(diff <= 1) >= 0.99, np.mean(diff <= 1)


def _assert_meas_close(rec, want):
    """ok equal on every frame; the measurements within the GN convergence
    class of test_torch_chunked.py::_assert_close_to_jax (TX/TY 0.1 px, A/B
    6e-4): at 96x128 the coarse levels take 8-12 GN iterations, and the
    port rounds its sampling products to bf16 elsewhere than the jitted JAX
    program does on the CPU."""
    assert [ok for _, ok in rec] == [ok for _, ok in want]
    meas = np.array([m for m, _ in rec])
    meas_j = np.array([m for m, _ in want])
    np.testing.assert_allclose(meas[:, 2:], meas_j[:, 2:], atol=0.1)
    np.testing.assert_allclose(meas[:, :2], meas_j[:, :2], atol=6e-4)


# ---------------------------------------------------------------- host algebra

def test_host_algebra_bit_equal():
    r = np.random.default_rng(3)
    for _ in range(20):
        t1 = r.normal(size=4) * np.array([0.01, 0.01, 3.0, 3.0])
        t2 = r.normal(size=4) * np.array([0.01, 0.01, 3.0, 3.0])
        np.testing.assert_array_equal(stabilizer._np_inverse(t1),
                                      jstabilizer._np_inverse(t1))
        np.testing.assert_array_equal(stabilizer._np_compose(t1, t2),
                                      jstabilizer._np_compose(t1, t2))
        assert (stabilizer._np_max_corner_displacement(t1, 1920, 1080)
                == jstabilizer._np_max_corner_displacement(t1, 1920, 1080))
    for disp in (0.0, 30.0, 48.0, 48.5, 56.0, 63.9, 64.0, 64.1, 200.0):
        assert (stabilizer.decay_factor(disp, PARAMS)
                == jstabilizer.decay_factor(disp, JPARAMS))


# -------------------------------------------------------------------- smoother

@pytest.mark.parametrize("jit_smooth,atol", [(False, 1e-12), (True, 1e-5)])
def test_smoother_center_matches_jax(jit_smooth, atol):
    """30 updates: the same None cadence, and the finalized transforms within
    1e-12 (float64 on the host, both) or 1e-5 (float32, both)."""
    r = np.random.default_rng(11)
    meas = r.normal(size=(30, 4)) * np.array([0.01, 0.01, 2.0, 2.0])
    mine = smoother.L1SmootherCenter(4, 2, 4.0, jit_smooth=jit_smooth,
                                     device="cpu")
    ref = jsmoother.L1SmootherCenter(4, 2, 4.0, jit_smooth=jit_smooth)
    n_out = 0
    for m in meas:
        got, want = mine.update(m), ref.update(m)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_allclose(got, want, rtol=0, atol=atol)
            n_out += 1
    assert n_out == 30 - 2


# --------------------------------------------------------------------- aligner

@pytest.fixture(scope="module")
def gray_clip():
    return _clip(seed=62, color=False)


def _align_stream(al, frames):
    out = []
    for f in frames:
        t, ok = al.align_next_frame(f)
        out.append((np.asarray(t.cpu() if torch.is_tensor(t) else t,
                               np.float64), bool(ok)))
    return out


@pytest.fixture(scope="module")
def port_aligns(gray_clip):
    """The port's VideoAligner over the gray clip, once per setting of
    phase_correlate: {phase: [(meas, ok), ...]}."""
    runs = {}
    for phase in (False, True):
        tparams = params_from_jax_dict(dataclasses.asdict(
            jcfg.AlignerParams(phase_correlate=phase)))
        runs[phase] = _align_stream(aligner.VideoAligner(tparams,
                                                         device="cpu"),
                                    gray_clip)
    return runs


@pytest.mark.parametrize("phase", [False, True])
def test_video_aligner_matches_jax(gray_clip, port_aligns, phase):
    jparams = jcfg.AlignerParams(phase_correlate=phase)
    want = _align_stream(jaligner.VideoAligner(jparams), gray_clip)
    got = port_aligns[phase]
    assert not got[0][1] and sum(ok for _, ok in got) >= N - 2
    _assert_meas_close(got, want)


def test_streaming_matches_clip_path(gray_clip, port_aligns):
    """Every align is one independent item in either form
    (test_batch.py:28-43 holds the JAX package's to 1e-5)."""
    assert PARAMS.aligner == params_from_jax_dict(dataclasses.asdict(
        jcfg.AlignerParams(phase_correlate=False)))
    got = port_aligns[False]
    meas, ok = align_clip(gray_clip, PARAMS.aligner, device="cpu")
    np.testing.assert_array_equal([o for _, o in got], ok.numpy())
    np.testing.assert_allclose(np.array([m for m, _ in got]),
                               meas.numpy(), rtol=0, atol=1e-5)


# ------------------------------------------------------------------ stabilizer

@pytest.fixture(scope="module")
def jax_stream(tmp_path_factory):
    """The JAX package's VideoStabilizer over a 20-frame clip, checkpointed
    to a file after 10 frames; and a JAX stabilizer resumed from that file
    over the last 10."""
    frames = _clip(seed=61)
    rec = []
    js = jstabilizer.VideoStabilizer(JPARAMS)
    out = _run(js, frames[:HALF], rec)
    path = str(tmp_path_factory.mktemp("ckpt") / "jax_stab.npz")
    jcheckpoint.save_stabilizer(path, js)
    out += _run(js, frames[HALF:], rec)
    rec_resumed = []
    out_resumed = _run(jcheckpoint.load_stabilizer(path, JPARAMS),
                       frames[HALF:], rec_resumed)
    return dict(frames=frames, out=out, rec=rec, failures=js.align_failures,
                path=path, out_resumed=out_resumed, rec_resumed=rec_resumed)


@pytest.fixture(scope="module")
def port_stream(jax_stream, tmp_path_factory):
    """The port's VideoStabilizer over the same clip, checkpointed to a
    file after 10 frames."""
    frames = jax_stream["frames"]
    rec = []
    stab = stabilizer.VideoStabilizer(PARAMS, device="cpu")
    out = _run(stab, frames[:HALF], rec)
    path = str(tmp_path_factory.mktemp("ckpt") / "port_stab.npz")
    checkpoint.save_stabilizer(path, stab)
    out += _run(stab, frames[HALF:], rec)
    return dict(out=out, rec=rec, stab=stab, path=path)


def test_stabilizer_matches_jax(jax_stream, port_stream):
    out = port_stream["out"]
    assert len(out) == N - PARAMS.lag
    assert out[0].shape == (H - 16, W - 16, 3) and out[0].dtype == np.uint8
    assert port_stream["stab"].align_failures == jax_stream["failures"]
    _assert_meas_close(port_stream["rec"], jax_stream["rec"])
    _assert_outputs_close(out, jax_stream["out"])


def test_resolution_change_matches_jax():
    """10 frames at 96x128, then 10 at 80x112: the aligner re-initializes,
    the queues, the smoother ring and the accumulator carry on, and each
    output is warped at its own frame's size (stabilizer.py:125-196)."""
    frames = list(_clip(seed=63, n=HALF)) + list(_clip(seed=64, n=HALF,
                                                       h=H2, w=W2))
    rec_j, rec = [], []
    js = jstabilizer.VideoStabilizer(JPARAMS)
    want = _run(js, frames, rec_j)
    stab = stabilizer.VideoStabilizer(PARAMS, device="cpu")
    got = _run(stab, frames, rec)
    assert {o.shape for o in got} == {(H - 16, W - 16, 3),
                                      (H2 - 16, W2 - 16, 3)}
    assert stab.align_failures == js.align_failures
    _assert_meas_close(rec, rec_j)
    _assert_outputs_close(got, want)


# ----------------------------------------------------------------- checkpoints

def test_resume_from_jax_checkpoint(jax_stream):
    """The port loads the file the JAX package's save_stabilizer wrote after
    10 frames and carries on as the JAX package does from the same file."""
    stab = checkpoint.load_stabilizer(jax_stream["path"], PARAMS,
                                      device="cpu")
    assert stab.frame_index == HALF and stab.aligner._state.frames_seen == 2
    rec = []
    out = _run(stab, jax_stream["frames"][HALF:], rec)
    assert len(out) == HALF
    _assert_meas_close(rec, jax_stream["rec_resumed"])
    _assert_outputs_close(out, jax_stream["out_resumed"])


def test_jax_resumes_from_port_checkpoint(jax_stream, port_stream):
    """The other way round: the JAX package's load_stabilizer takes the
    file the port wrote after 10 frames and carries on as the port does."""
    rec = []
    out = _run(jcheckpoint.load_stabilizer(port_stream["path"], JPARAMS),
               jax_stream["frames"][HALF:], rec)
    _assert_meas_close(rec, port_stream["rec"][HALF:])
    _assert_outputs_close(out, port_stream["out"][-HALF:])


def test_own_round_trip_bit_identical(jax_stream, port_stream):
    """Saved mid-stream and restored, the port gives the outputs of the
    uninterrupted run bit for bit (as test_checkpoint.py:39)."""
    frames = jax_stream["frames"]
    out = _run(checkpoint.load_stabilizer(port_stream["path"], PARAMS,
                                          device="cpu"), frames[HALF:], [])
    # The outputs of the first 10 frames come from the run before the save.
    out = port_stream["out"][:len(port_stream["out"]) - len(out)] + out
    assert len(out) == len(port_stream["out"])
    for a, b in zip(out, port_stream["out"]):
        np.testing.assert_array_equal(a, b)


def test_leaf_order_is_jax_pytree_order():
    leaves = jax.tree.flatten(jaligner.init_state(W, H, JPARAMS.aligner))[0]
    state = aligner.init_state(W, H, PARAMS.aligner, device="cpu")
    assert len(leaves) == 6 * len(state.pyramid) + 2
    assert checkpoint.leaf_shapes(state) == [tuple(x.shape) for x in leaves]
    mine = checkpoint.state_leaves(state)
    assert [x.dtype for x in mine] == [np.asarray(x).dtype for x in leaves]


def test_jax_checkpoint_loads_and_saves_back_byte_equal(tmp_path):
    """An aligner checkpoint the JAX package wrote (random leaves, its
    (P, P, N) windows) loads into the port, whose windows are keypoint-major
    (N, P, P), and the port saves it back byte-equal, leaf for leaf."""
    jstate = jaligner.init_state(W, H, JPARAMS.aligner)
    leaves, treedef = jax.tree.flatten(jstate)
    r = np.random.default_rng(9)
    leaves = [r.integers(0, 200, np.shape(x)).astype(np.asarray(x).dtype)
              for x in leaves]
    jpath, path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jcheckpoint.save_aligner_state(jpath, jax.tree.unflatten(treedef, leaves))
    template = aligner.init_state(W, H, PARAMS.aligner, device="cpu")
    got = checkpoint.load_aligner_state(jpath, template)
    win = len(got.pyramid) + 4                   # level 0's windows
    np.testing.assert_array_equal(got.key[0].windows[0].numpy(),
                                  np.moveaxis(leaves[win], -1, 0))
    checkpoint.save_aligner_state(path, got)
    with np.load(jpath) as a, np.load(path) as b:
        assert int(a["n"]) == int(b["n"]) == len(leaves)
        for i in range(len(leaves)):
            x, y = a[f"leaf_{i}"], b[f"leaf_{i}"]
            assert (x.dtype, x.shape) == (y.dtype, y.shape), i
            assert x.tobytes() == y.tobytes(), i


def test_float_windows_load_as_u8_and_must_be_integral():
    """Windows that were bf16 in the JAX package's state come as float32."""
    state = aligner.init_state(W, H, PARAMS.aligner, device="cpu")
    leaves = checkpoint.state_leaves(state)
    win = len(state.pyramid) + 4                 # level 0's windows
    r = np.random.default_rng(5)
    leaves[win] = r.integers(0, 256, leaves[win].shape).astype(np.float32)
    got = checkpoint.state_from_leaves(leaves, state)
    assert got.key[0].windows.dtype == torch.uint8
    np.testing.assert_array_equal(                   # file (P, P, N)
        got.key[0].windows[0].permute(1, 2, 0).numpy(), leaves[win])
    leaves[win][0, 0, 0] = 0.5
    with pytest.raises(ValueError, match="not all integers"):
        checkpoint.state_from_leaves(leaves, state)


# ------------------------------------------------------------------- no device

def test_streaming_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: stabilizer.VideoStabilizer(PARAMS),
        lambda: aligner.VideoAligner(PARAMS.aligner),
        lambda: aligner.init_state(W, H, PARAMS.aligner),
        lambda: smoother.L1SmootherCenter(4, 2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
