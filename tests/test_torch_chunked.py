"""The port's chunked serving path: held to its own clip path, to the golden
measurement trace, and to the JAX package's chunked path (Pallas output
warp in interpret mode), including a stream whose state the JAX package
built and the port carries on."""

import dataclasses
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from video_stabilizer_tpu import config as jcfg
from video_stabilizer_tpu.models import chunked as jchunked
from video_stabilizer_tpu.utils.io import synth_shaky_clip as j_synth
from video_stabilizer_tpu_torch.config import params_from_jax_dict
from video_stabilizer_tpu_torch.models import batch, chunked
from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

# Torch's CPU threads would contend with the JAX runtime's in this process;
# at these sizes one thread is several times faster.
torch.set_num_threads(1)

H, W, N = 96, 128, 16
JPARAMS = jcfg.StabilizerParams(lag=4, smoother_memory=2, crop_pixels=8,
                                output_warp="pallas")
PARAMS = params_from_jax_dict(dataclasses.asdict(JPARAMS))
_HERE = os.path.dirname(__file__)


def _clip(seed, n=N, **kw):
    return synth_shaky_clip(n, H, W, seed=seed, jitter_px=0.8,
                            pan_px_per_frame=0.3, **kw)


def _lsb_diff(a, b):
    return np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))


def test_synth_clip_is_the_jax_packages():
    kw = dict(seed=5, jitter_px=0.8, pan_px_per_frame=0.3, rot_jitter=0.002,
              zoom_jitter=0.001)
    np.testing.assert_array_equal(synth_shaky_clip(4, 40, 56, **kw),
                                  j_synth(4, 40, 56, **kw))


def test_synth_clip_translation_path_and_poses():
    """The translation-only path is the JAX package's too, bit for bit, and
    the poses are its window offsets: the seed's normal draws plus the pan,
    on a common margin (chip_smoke.py reads the clip's known motion from
    them)."""
    kw = dict(seed=9, jitter_px=1.5, pan_px_per_frame=0.3, color=False)
    clip, poses = synth_shaky_clip(5, 40, 56, poses=True, **kw)
    np.testing.assert_array_equal(clip, j_synth(5, 40, 56, **kw))
    r = np.random.default_rng(9)
    draws = np.array([[r.normal(0, 1.5), r.normal(0, 1.5)] for _ in range(5)])
    margin = poses[:, 2:] - draws - np.stack([0.3 * np.arange(5),
                                              np.zeros(5)], axis=1)
    np.testing.assert_allclose(margin, margin[0, 0], atol=1e-12)
    assert not poses[:, :2].any()


@pytest.mark.parametrize("chunk_size", [2, N // 2])
def test_chunked_matches_clip_path(chunk_size):
    """Exact: every align of the port is an independent item, so chunking
    changes only how many items share a launch (test_chunked.py:28-50).
    Chunks of 2 frames are shorter than the lag (4): each chunk's delayed
    frames all come from the carried tail, and the new tail is the old
    one shifted, then the chunk."""
    frames = _clip(seed=51)
    out_u, meas_u, ok_u = batch.stabilize_clip(frames, PARAMS, device="cpu")
    out_c, meas_c, ok_c = chunked.stabilize_stream_chunked(
        frames, PARAMS, chunk_size=chunk_size, device="cpu")
    np.testing.assert_array_equal(ok_u.numpy(), ok_c)
    np.testing.assert_allclose(meas_u.numpy(), meas_c, atol=1e-6)
    assert out_c.shape == tuple(out_u.shape) == (N - 4, H - 16, W - 16, 3)
    assert np.mean(_lsb_diff(out_u.numpy(), out_c) <= 1) > 0.999


@pytest.mark.parametrize("tc", [2, 8])
def test_chunk_state_owns_its_frame_tail(tc):
    """``stabilize_chunk_core`` leaves the delayed frames where they lie
    (the carried tail, then the chunk) and copies the new tail: it equals
    positions tc.. of [tail | chunk] (tc < lag shifts the old tail), shares
    no memory with the caller's frames, and a caller that overwrites its
    frame buffer after a call leaves the next chunk's outputs as they
    were."""
    frames = torch.from_numpy(_clip(seed=57, n=3 * tc))[None]
    state = chunked.init_stream_state(W, H, PARAMS, 3, 1, "cpu")
    state = chunked.stabilize_chunk_streams(state, frames[:, :tc],
                                            PARAMS)[0]
    chunk = frames[:, tc:2 * tc].clone()
    new, delayed, *_ = chunked.stabilize_chunk_core(state, chunk, PARAMS, W,
                                                    H)
    joined = torch.cat([state.frame_tail, chunk], dim=1)
    assert torch.equal(new.frame_tail, joined[:, tc:])
    assert torch.equal(delayed.batch(), joined[:, :tc])
    assert delayed.seg0 is state.frame_tail and delayed.seg1 is chunk

    def shares(a, b):
        sa, sb = a.untyped_storage(), b.untyped_storage()
        return (sa.data_ptr() < sb.data_ptr() + sb.nbytes()
                and sb.data_ptr() < sa.data_ptr() + sa.nbytes())
    after = frames[:, 2 * tc:]
    want = chunked.stabilize_chunk_streams(new, after, PARAMS)[1]
    buf = chunk.clone()
    carried = chunked.stabilize_chunk_streams(state, buf, PARAMS)[0]
    assert not shares(new.frame_tail, chunk)
    assert not shares(carried.frame_tail, buf)
    buf.zero_()
    assert torch.equal(chunked.stabilize_chunk_streams(carried, after,
                                                       PARAMS)[1], want)


def test_chunked_stabilizer_class():
    frames = _clip(seed=54)
    stab = chunked.ChunkedStabilizer(PARAMS, device="cpu")
    got = np.concatenate([stab.process_chunk(frames[s:s + 4])[0].numpy()
                          for s in range(0, N, 4)])
    ref = chunked.stabilize_stream_chunked(frames, PARAMS, chunk_size=N,
                                           device="cpu")[0]
    assert got.shape[0] == N - PARAMS.lag
    np.testing.assert_array_equal(got, ref)


def test_golden_trace():
    """The golden measurement trace of the JAX package's align_clip.

    ok must be equal. The golden file's own bars (test_golden_trace.py:
    38-41, TX/TY 2e-3, A/B 2e-5) are bit-level drift bands of one XLA
    program; the port sums in another order and rounds its sampling
    products to bf16 at other places than the jitted JAX program does on
    the CPU (test_torch_ops.py::test_sample_windows_flat_within_bf16_gap),
    so it is held to the GN convergence class instead
    (test_pallas_gn.py:75-76: TX/TY 6e-2, A/B 3e-4). Measured: TX 2.1e-2,
    TY 5.2e-2, A 2.5e-4, B 2.1e-4 at most."""
    spec = importlib.util.spec_from_file_location(
        "make_golden", os.path.join(_HERE, "golden", "make_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    clip = synth_shaky_clip(**mod.CLIP_SPEC)
    meas, ok = batch.align_clip(clip, PARAMS.aligner, device="cpu")
    g = np.load(os.path.join(_HERE, "golden", "meas_trace_v1.npz"))
    np.testing.assert_array_equal(ok.numpy(), g["ok"])
    meas = meas.numpy().astype(np.float64)
    np.testing.assert_allclose(meas[:, 2:], g["meas"][:, 2:], atol=6e-2)
    np.testing.assert_allclose(meas[:, :2], g["meas"][:, :2], atol=3e-4)


@pytest.fixture(scope="module")
def jax_two_chunks():
    """The JAX package's chunked path over two chunks of one stream, with
    its state after chunk 1 as numpy arrays."""
    frames = _clip(seed=61)
    half = N // 2
    # Jitted: eagerly its keyframe precompute compiles op by op (~16 s).
    state = jax.jit(jchunked.init_stream_state, static_argnums=(0, 1, 2, 3))(
        W, H, JPARAMS, 3)
    state, out1, meas1, ok1, valid1 = jchunked._stabilize_chunk_jit(
        state, frames[:half], JPARAMS, W, H)
    state1 = jax.tree.map(np.asarray, state)
    _, out2, meas2, ok2, valid2 = jchunked._stabilize_chunk_jit(
        state, frames[half:], JPARAMS, W, H)
    valid1, valid2 = np.asarray(valid1), np.asarray(valid2)
    out = np.concatenate([np.asarray(out1)[valid1], np.asarray(out2)[valid2]])
    return dict(frames=frames, state1=state1, out=out,
                meas=np.concatenate([meas1, meas2]),
                ok=np.concatenate([ok1, ok2]), out2=np.asarray(out2),
                meas2=np.asarray(meas2), ok2=np.asarray(ok2))


def _assert_close_to_jax(out, meas, ok, want_out, want_meas, want_ok):
    """ok equal; >= 99 % of pixels within 1 LSB. The measurements are held
    to the spread between the JAX package's own two GN loops on clips of
    this size: at 96x128 the coarse levels are 32x24 and 64x48 and take
    8-12 GN iterations, so rounding noise in the sampled intensities moves
    the converged point further than on the larger clips of
    test_pallas_gn.py. Measured on seeds 51/61/71 of this clip: Pallas vs
    XLA loop up to 9.1e-2 px in TX/TY and 5.6e-4 in A/B; the port vs the
    XLA loop up to 8.7e-2 and 4.6e-4. Bars: 0.1 and 6e-4. Measured on
    seed 61 (the clip below): every pixel within 1 LSB, 91.5 % equal over
    both chunks and 97.7 % in the chunk carried from JAX state."""
    np.testing.assert_array_equal(ok, want_ok)
    np.testing.assert_allclose(meas[..., 2:], want_meas[..., 2:], atol=0.1)
    np.testing.assert_allclose(meas[..., :2], want_meas[..., :2], atol=6e-4)
    assert out.shape == want_out.shape
    assert np.mean(_lsb_diff(out, want_out) <= 1) >= 0.99


def test_matches_jax_chunked_with_pallas_warp(jax_two_chunks):
    j = jax_two_chunks
    out, meas, ok = chunked.stabilize_stream_chunked(
        j["frames"], PARAMS, chunk_size=N // 2, device="cpu")
    _assert_close_to_jax(out, meas, ok, j["out"], j["meas"], j["ok"])


def test_state_carried_from_jax(jax_two_chunks):
    """JAX runs chunk 1; its StreamState goes through stream_state_from_numpy
    into the port, and the port's chunk 2 matches the JAX package's."""
    j = jax_two_chunks
    state = chunked.stream_state_from_numpy(j["state1"], device="cpu")
    assert int(state.steps_seen[0]) == N // 2
    assert state.frame_tail.shape == (1, PARAMS.lag, H, W, 3)
    _, out, meas, ok, valid = chunked.stabilize_chunk_impl(
        state, torch.from_numpy(j["frames"][N // 2:]), PARAMS)
    assert bool(valid.all())
    _assert_close_to_jax(out.numpy(), meas.numpy(), ok.numpy(), j["out2"],
                         j["meas2"], j["ok2"])
