"""The port's homography serving path (8-DOF aligner, phase-correlation
init, Lanczos2 output warp) held to its own clip path and to the JAX
package's chunked path, with the Pallas output warp in interpret mode,
including a stream whose state the JAX package built and the port carries
on; and the similarity model's phase-correlation init held to the JAX
package's.

The clips are 96x128, whose coarsest level is 32x24. At that size the
default GN threshold (0.02 px of corner movement per step) lies below the
step noise that the bf16 sampling products leave in an 8-parameter solve:
whether an align converges within 64 iterations then turns on rounding,
and the JAX package itself aligns 6 of the 15 alignable frames of the
clip below (the port 4 of them). With a 0.1 px threshold
every align of both converges, so the comparison measures the port and not
the rounding. The 4K path runs the default threshold (chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilizer_tpu import config as jcfg
from video_stabilizer_tpu import homography as JH
from video_stabilizer_tpu.models import aligner as jaligner
from video_stabilizer_tpu.models import chunked as jchunked
from video_stabilizer_tpu_torch.config import params_from_jax_dict
from video_stabilizer_tpu_torch.models import aligner, batch, chunked
from video_stabilizer_tpu_torch.ops.pyr_down import build_pyramid
from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

# Torch's CPU threads would contend with the JAX runtime's in this process;
# at these sizes one thread is several times faster.
torch.set_num_threads(1)

H, W, N = 96, 128, 16
JPARAMS = jcfg.StabilizerParams(
    lag=4, smoother_memory=2, crop_pixels=8, output_interp="lanczos2",
    output_warp="pallas",
    aligner=jcfg.AlignerParams(phase_correlate=True, threshold=0.1))
PARAMS = params_from_jax_dict(dataclasses.asdict(JPARAMS))
MODEL = "homography"


def _clip(seed=61):
    return synth_shaky_clip(N, H, W, seed=seed, jitter_px=0.8,
                            pan_px_per_frame=0.3)


def _lsb_diff(a, b):
    return np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))


def _corner_err(p_a, p_b):
    """Max distance between the frame corners ((w-1, h-1) extent) warped by
    two (..., 8) homographies, per leading index (px)."""
    corners = jnp.asarray([[0.0, 0.0], [W - 1.0, 0.0], [0.0, H - 1.0],
                           [W - 1.0, H - 1.0]])
    a = np.asarray(JH.warp_points(jnp.asarray(p_a)[..., None, :], corners,
                                  W, H))
    b = np.asarray(JH.warp_points(jnp.asarray(p_b)[..., None, :], corners,
                                  W, H))
    return np.hypot(*np.moveaxis(a - b, -1, 0)).max(axis=-1)


@pytest.fixture(scope="module")
def port_chunked():
    frames = _clip()
    out, meas, ok = chunked.stabilize_stream_chunked(
        frames, PARAMS, chunk_size=N // 2, model=MODEL, device="cpu")
    return dict(frames=frames, out=out, meas=meas, ok=ok)


def test_chunked_matches_clip_path(port_chunked):
    """As tests/test_chunked.py:78-92 for the homography family: ok equal,
    meas within 1e-6, >= 99.9 % of pixels within 1 LSB. Every align is an
    independent item whose init reads only frames, so chunking changes how
    many items share a launch (measured: exact)."""
    c = port_chunked
    out_u, meas_u, ok_u = batch.stabilize_clip(c["frames"], PARAMS,
                                               device="cpu", model=MODEL)
    np.testing.assert_array_equal(ok_u.numpy(), c["ok"])
    np.testing.assert_allclose(meas_u.numpy(), c["meas"], atol=1e-6)
    assert c["out"].shape == tuple(out_u.shape) == (N - 4, H - 16, W - 16, 3)
    assert np.mean(_lsb_diff(out_u.numpy(), c["out"]) <= 1) >= 0.999


def test_chunked_stabilizer_class(port_chunked):
    """The stateful wrapper gives the function's outputs, bit for bit."""
    c = port_chunked
    stab = chunked.ChunkedStabilizer(PARAMS, model=MODEL, device="cpu")
    got = [stab.process_chunk(c["frames"][s:s + N // 2])
           for s in range(0, N, N // 2)]
    np.testing.assert_array_equal(
        np.concatenate([g[0].numpy() for g in got]), c["out"])
    assert got[0][1].shape == (N // 2, 8)


@pytest.fixture(scope="module")
def jax_two_chunks():
    """The JAX package's chunked homography path over two chunks of one
    stream, with its state after chunk 1 as numpy arrays."""
    frames = _clip()
    half = N // 2
    state = jax.jit(jchunked.init_stream_state,
                    static_argnums=(0, 1, 2, 3, 4))(W, H, JPARAMS, 3, MODEL)
    state, out1, meas1, ok1, valid1 = jchunked._stabilize_chunk_jit(
        state, frames[:half], JPARAMS, W, H, MODEL)
    state1 = jax.tree.map(np.asarray, state)
    _, out2, meas2, ok2, valid2 = jchunked._stabilize_chunk_jit(
        state, frames[half:], JPARAMS, W, H, MODEL)
    valid1, valid2 = np.asarray(valid1), np.asarray(valid2)
    out = np.concatenate([np.asarray(out1)[valid1], np.asarray(out2)[valid2]])
    return dict(frames=frames, state1=state1, out=out,
                meas=np.concatenate([meas1, meas2]),
                ok=np.concatenate([ok1, ok2]), out2=np.asarray(out2),
                meas2=np.asarray(meas2), ok2=np.asarray(ok2))


def _assert_close_to_jax(out, meas, ok, want_out, want_meas, want_ok):
    """ok equal, every align converged; the measurements within the GN
    convergence class of a 0.1 px threshold: two converged loops may stop
    a step apart, so the warped frame corners may differ by about that
    step, here 0.25 px at most; >= 99 % of pixels within 1 LSB. Measured
    over both chunks: 0.148 px, every pixel within 1 LSB, 94.6 % equal; in
    the chunk carried from JAX state: 0.090 px, every pixel, 98.3 %."""
    np.testing.assert_array_equal(ok, want_ok)
    assert ok[1:].all()
    assert _corner_err(meas, want_meas)[ok].max() <= 0.25
    assert out.shape == want_out.shape
    assert np.mean(_lsb_diff(out, want_out) <= 1) >= 0.99


def test_matches_jax_chunked_homography(jax_two_chunks, port_chunked):
    j, c = jax_two_chunks, port_chunked
    np.testing.assert_array_equal(j["frames"], c["frames"])
    _assert_close_to_jax(c["out"], c["meas"], c["ok"], j["out"], j["meas"],
                         j["ok"])


def test_state_carried_from_jax(jax_two_chunks):
    """JAX runs chunk 1; its homography StreamState (LevelKeyDataH leaves,
    (tail, 8) meas_tail, (8,) accum) goes through stream_state_from_numpy
    into the port, and the port's chunk 2 matches the JAX package's."""
    j = jax_two_chunks
    state = chunked.stream_state_from_numpy(j["state1"], model=MODEL,
                                            device="cpu")
    assert int(state.steps_seen[0]) == N // 2
    assert state.accum.shape == (1, 8) and state.meas_tail.shape == (1, 6, 8)
    assert state.pair.key[0].jac.shape[1] == 8
    with pytest.raises(ValueError):
        chunked.stream_state_from_numpy(j["state1"], device="cpu")
    _, out, meas, ok, valid = chunked.stabilize_chunk_impl(
        state, torch.from_numpy(j["frames"][N // 2:]), PARAMS, MODEL)
    assert bool(valid.all())
    _assert_close_to_jax(out.numpy(), meas.numpy(), ok.numpy(), j["out2"],
                         j["meas2"], j["ok2"])


def test_similarity_phase_init_matches_jax():
    """``phase_correlate=True`` means the same for the similarity model as
    in the JAX package (aligner.py:455-474, batch.py:146-153): frame i is
    correlated against frame i - 1 at the phase level (the carried keyframe
    for i = 0), scaled by 2^2 / 2^levels, sign-flipped on keyframes, and
    dropped below the response threshold. Same inits within 1e-3 px (the
    FFTs' rounding at 24x32, see test_torch_homography.py; measured
    3.0e-7)."""
    params = PARAMS.aligner
    frames = synth_shaky_clip(N, H, W, seed=61, jitter_px=2.0,
                              pan_px_per_frame=1.0, color=False)
    specs = aligner.level_specs(W, H, params)
    levels = len(specs)
    # The port's pyramid is bit-exact with the JAX package's
    # (test_torch_ops.py::test_pyramid_bit_exact).
    pyr = [x.numpy() for x in build_pyramid(torch.from_numpy(frames), levels)]
    lvl = min(aligner.PHASE_LEVEL, levels - 1)
    carry = batch.init_pair_carry(specs, 1, "cpu")
    got = batch._phase_inits([torch.from_numpy(x)[None] for x in pyr], carry,
                             specs, params, batch.model_ops("similarity"))[0]
    j_init = jax.jit(lambda a, b, key: jaligner.phase_init_pair(
        a, b, levels, JPARAMS.aligner, jnp.float32, key))
    prev = np.zeros_like(pyr[lvl][0])
    for i in range(N):
        want = j_init(prev, pyr[lvl][i], i % 2 == 1)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   atol=1e-3)
        prev = pyr[lvl][i]
    assert not got[0].any() and float(got[1:, 2:].abs().min()) > 0
