"""The port's output warps and gather oracles held to the JAX package and
to each other on the CPU: the global-base FIR warp (``ops/fast_warp.py``)
against JAX's FIR and against the port's own gather oracle
(``ops/warp.py``) at tests/test_fast_warp_oracle.py's bars; the oracles,
the sparse LK chain (``ops/sparse.py``), Lanczos2, the Jacobi
eigensolver, the tile-grid windows and the transform helpers against the
JAX functions; the package exports; and kernel A's plain version against
the port's oracle, with no JAX in the loop."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import video_stabilizer_tpu as jpkg
import video_stabilizer_tpu.ops as jops
import video_stabilizer_tpu_torch as tpkg
import video_stabilizer_tpu_torch.ops as tops
from video_stabilizer_tpu import config as jcfg
from video_stabilizer_tpu import transforms as JT
from video_stabilizer_tpu.models import batch as jbatch
from video_stabilizer_tpu.models import homography_aligner as jha
from video_stabilizer_tpu.ops import fast_warp as jfast
from video_stabilizer_tpu.ops import lanczos as jlanczos
from video_stabilizer_tpu.ops import linalg as jlinalg
from video_stabilizer_tpu.ops import patches as jpatches
from video_stabilizer_tpu.ops import sparse as jsparse
from video_stabilizer_tpu.ops import warp as jwarp
from video_stabilizer_tpu_torch import config
from video_stabilizer_tpu_torch import homography as Hm
from video_stabilizer_tpu_torch import transforms as T
from video_stabilizer_tpu_torch.config import params_from_jax_dict
from video_stabilizer_tpu_torch.models import batch, chunked, stabilizer
from video_stabilizer_tpu_torch.ops import (
    fast_warp, lanczos, linalg, patches, sparse, warp)
from video_stabilizer_tpu_torch.ops.warp_kernel import (
    FrameSegments, warp_frame_segments, warp_frames_plain)
from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip
from conftest import natural_image

# Torch's CPU threads would contend with the JAX runtime's in this process;
# at these sizes one thread is several times faster.
torch.set_num_threads(1)

H, W = 144, 192     # radius 120: m = 4 covers |A,B| <= 0.025


def _color(seed):
    return np.stack([natural_image(H, W, seed=seed + k) for k in range(3)],
                    axis=-1)


def _i32(x):
    return np.asarray(x.numpy() if torch.is_tensor(x) else x, np.int32)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


# ----------------------------------------------------------------- FIR warp

# (model, interp, sampling transform): the similarity ones origin-based,
# the homography ones normalized, with p6/p7 != 0.
FIR_CASES = [
    ("similarity", "bilinear", [0.0, 0.0, -40.0, 25.0]),
    ("similarity", "bilinear", [0.0, 0.0, 13.37, -7.61]),
    ("similarity", "bilinear", [0.012, -0.009, 6.2, -3.4]),
    ("similarity", "lanczos2", [0.004, -0.006, 5.3, -2.7]),
    ("homography", "bilinear", [2e-3, -3e-3, 0.02, 1e-3, 2e-3, -0.015,
                                1.5e-3, -1e-3]),
    ("homography", "lanczos2", [-2e-3, 1e-3, -0.01, 2e-3, -1e-3, 0.02,
                                -1e-3, 2e-3]),
]


def _fir_both(model, interp, t, img, bound=4):
    """(port FIR, JAX FIR) of one frame, as int32 numpy."""
    jfn = jfast.warp_image_fast if model == "similarity" \
        else jfast.warp_homography_fast
    tfn = fast_warp.warp_image_fast if model == "similarity" \
        else fast_warp.warp_homography_fast
    got = tfn(torch.tensor(img), _t(t), interp=interp, residual_bound=bound)
    want = jfn(jnp.asarray(img), jnp.asarray(t, jnp.float32), interp=interp,
               residual_bound=bound)
    return _i32(got), _i32(want)


@pytest.mark.parametrize("case", range(len(FIR_CASES)))
def test_fir_matches_jax_fir(case):
    """Max 1 LSB, >= 99.9 % of pixels equal."""
    model, interp, t = FIR_CASES[case]
    got, want = _fir_both(model, interp, t, _color(7 + case))
    diff = np.abs(got - want)
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999, \
        (diff.max(), np.mean(diff == 0))


def _fir_and_oracle(img, t, interp="bilinear", bound=4):
    img, t = torch.tensor(img), _t(t)
    fast = fast_warp.warp_image_fast(img, t, interp=interp,
                                     residual_bound=bound)
    exact = warp.warp_image_bgr(img, t, interp=interp, border="zero")
    return _i32(fast), _i32(exact)


def test_fir_against_oracle_at_jax_bars():
    """tests/test_fast_warp_oracle.py's cases, with its images and draws,
    on the port alone (its FIR against its gather oracle): integer
    translation bit-exact, subpixel translation <= 1 LSB, rotation / zoom
    within the envelope <= 2 LSB on > 99.9 % of pixels and at most 8,
    Lanczos2 <= 2 LSB on > 99.9 %, and a homography without perspective
    against the similarity oracle. (The y pass weighs each pixel at the
    column it reads: other draws near |A,B| = 0.015 leave up to 0.3 % of
    pixels beyond 2 LSB, in the JAX package's FIR as in the port's.)"""
    img = _color(7)
    for tx, ty in [(0, 0), (3, -7), (-40, 25), (150, -150)]:
        fast, exact = _fir_and_oracle(img, [0.0, 0.0, tx, ty])
        np.testing.assert_array_equal(fast, exact)
    img, rng = _color(11), np.random.default_rng(0)
    for _ in range(5):
        fast, exact = _fir_and_oracle(img, [0.0, 0.0,
                                            *rng.uniform(-30, 30, 2)])
        assert np.abs(fast - exact).max() <= 1
    img, rng = _color(13), np.random.default_rng(1)
    for _ in range(5):
        a = rng.uniform(-0.015, 0.015)
        b = rng.uniform(-0.015, 0.015)
        fast, exact = _fir_and_oracle(img, [a, b, *rng.uniform(-10, 10, 2)])
        diff = np.abs(fast - exact)
        assert np.mean(diff <= 2) > 0.999 and diff.max() <= 8, (a, b)
    fast, exact = _fir_and_oracle(_color(17), [0.004, -0.006, 5.3, -2.7],
                                  "lanczos2")
    assert np.mean(np.abs(fast - exact) <= 2) > 0.999
    img = torch.tensor(_color(31))
    t_center = torch.tensor([0.005, -0.008, 4.0, -6.0])
    p = Hm.sim_to_homography(t_center, W, H)
    fast = _i32(fast_warp.warp_homography_fast(img, p))
    exact = _i32(warp.warp_image_bgr(img, T.center_to_ul(t_center, W, H),
                                     border="zero"))
    assert np.mean(np.abs(fast - exact) <= 2) > 0.999


def test_fir_batched_frames_equal_one_by_one():
    """Frames on a leading axis, each with its own bulk shift, give what
    each gives alone (the chunked path warps them so)."""
    frames = torch.tensor(np.stack([_color(3), _color(4)]))
    ts = _t([[0.003, 0.0, 60.2, -3.1], [-0.002, 0.001, -80.7, 9.9]])
    batch = fast_warp.warp_image_fast(frames, ts, residual_bound=4)
    for i in range(2):
        assert torch.equal(batch[i], fast_warp.warp_image_fast(
            frames[i], ts[i], residual_bound=4))


# The FIR warp where the pipelines call it: the chunked and clip paths'
# ``warp_delayed`` (both models) and the streaming ``output_warp``.
JPARAMS_FIR = jcfg.StabilizerParams(lag=4, smoother_memory=2, crop_pixels=8,
                                    output_warp="fir")
PARAMS_FIR = params_from_jax_dict(dataclasses.asdict(JPARAMS_FIR))


def _corrections(model, n, seed):
    r = np.random.default_rng(seed)
    if model == "similarity":
        scale = [2e-3, 2e-3, 4.0, 4.0]
    else:
        scale = [2e-3, 2e-3, 0.02, 2e-3, 2e-3, 0.02, 1e-3, 1e-3]
    return (r.uniform(-1, 1, (n, len(scale))) * scale).astype(np.float32)


@pytest.mark.parametrize("model", ["similarity", "homography"])
def test_warp_delayed_fir_matches_jax(model):
    """(S, T) delayed frames warped by their corrections and cropped: max
    1 LSB, >= 99.9 % equal to the JAX package's FIR."""
    delayed = np.stack([_color(40 + k) for k in range(4)]).reshape(
        (2, 2, H, W, 3))
    accums = _corrections(model, 4, 1).reshape(2, 2, -1)
    if model == "similarity":
        want = jbatch.warp_delayed(jnp.asarray(delayed), jnp.asarray(accums),
                                   JPARAMS_FIR, W, H)
    else:
        want = jha.warp_delayed_homography(
            jnp.asarray(delayed), jnp.asarray(accums), JPARAMS_FIR, W, H)
    got = batch.warp_delayed(torch.tensor(delayed), torch.tensor(accums),
                             PARAMS_FIR, W, H, model)
    assert tuple(got.shape) == (2, 2, H - 16, W - 16, 3)
    diff = np.abs(_i32(got) - _i32(want))
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999


def test_streaming_output_warp_fir_matches_jax():
    """One frame by its origin-based correction; JAX's uncropped output is
    cropped by the stabilizer (stabilizer.py:193-195), the port's in
    ``output_warp``."""
    frame = _color(44)
    t_ul = _corrections("similarity", 1, 2)[0]
    want = np.asarray(jbatch.output_warp(jnp.asarray(frame),
                                         jnp.asarray(t_ul), JPARAMS_FIR,
                                         W, H))[8:-8, 8:-8]
    got = batch.output_warp(torch.tensor(frame), torch.tensor(t_ul),
                            PARAMS_FIR)
    diff = np.abs(_i32(got) - _i32(want))
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999


@pytest.mark.parametrize("model", ["similarity", "homography"])
def test_fir_through_the_entry_points(model):
    """``output_warp="fir"`` through the chunked and streaming entry points:
    the same measurements as the tile-local warp's run, outputs other than
    its and within 2 LSB of them on > 99.9 % of pixels; the streaming
    path's FIR outputs within 1 LSB of the chunked path's on >= 99.5 %
    (the JAX package's streaming-vs-clip bar, test_batch.py:28-83)."""
    frames = synth_shaky_clip(16, 96, 128, seed=81, jitter_px=0.8,
                              pan_px_per_frame=0.3, rot_jitter=0.002)
    params = dataclasses.replace(
        PARAMS_FIR, aligner=config.AlignerParams(threshold=0.1))
    tile = dataclasses.replace(params, output_warp="auto")
    out, meas, ok = chunked.stabilize_stream_chunked(
        frames, params, 8, device="cpu", model=model)
    out_t, meas_t, ok_t = chunked.stabilize_stream_chunked(
        frames, tile, 8, device="cpu", model=model)
    np.testing.assert_array_equal(meas, meas_t)
    np.testing.assert_array_equal(ok, ok_t)
    diff = np.abs(out.astype(np.int32) - out_t)
    assert diff.any() and np.mean(diff <= 2) > 0.999
    if model == "similarity":
        stab = stabilizer.VideoStabilizer(params, device="cpu")
        outs = [o for o in map(stab.process_frame, frames) if o is not None]
        diff = np.abs(torch.stack(outs).numpy().astype(np.int32) - out)
        assert np.mean(diff <= 1) >= 0.995


# ------------------------------------------------------------- gather oracles

@pytest.mark.parametrize("interp,border", [
    ("bilinear", "zero"), ("bilinear", "edge"), ("lanczos2", "zero"),
    ("lanczos2", "edge")])
def test_warp_image_bgr_matches_jax(interp, border):
    img = _color(21)
    t = [0.011, -0.007, 9.3, -14.6]
    got = warp.warp_image_bgr(torch.tensor(img), _t(t), interp=interp,
                              border=border)
    want = jwarp.warp_image_bgr(jnp.asarray(img), jnp.asarray(t, jnp.float32),
                                interp=interp, border=border)
    diff = np.abs(_i32(got) - _i32(want))
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999
    gray = warp.warp_image_bgr(torch.tensor(img[..., 1]), _t(t),
                               interp=interp, border=border)
    assert torch.equal(gray, got[..., 1])


def test_image_warp_and_similarity_transform_match_jax():
    img = natural_image(H, W, seed=5)
    t_center = [0.006, 0.004, -3.25, 7.5]
    got = warp.image_warp(torch.tensor(img), _t(t_center)).numpy()
    want = np.asarray(jwarp.image_warp(jnp.asarray(img),
                                       jnp.asarray(t_center, jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    t_ul = T.center_to_ul(_t(t_center), W, H, minus_one=True)
    np.testing.assert_array_equal(
        warp.image_warp_ul(torch.tensor(img), t_ul).numpy(), got)
    got = warp.warp_by_similarity_transform(torch.tensor(_color(6)),
                                            _t(t_center), interp="lanczos2")
    want = jwarp.warp_by_similarity_transform(
        jnp.asarray(_color(6)), jnp.asarray(t_center, jnp.float32),
        interp="lanczos2")
    diff = np.abs(_i32(got) - _i32(want))
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999


def test_kernel_a_plain_within_two_lsb_of_oracle_under_rotation():
    """Kernel A's plain version against the port's own oracle, no JAX:
    zero border, rotation and zoom near the stabilizer's envelope, both
    interpolations, crop 0; <= 2 LSB on > 99.9 % of pixels."""
    frames = torch.tensor(np.stack([_color(31), _color(32)]))
    ts = _t([[0.0025, -0.002, 3.7, -5.2], [-0.002, 0.0027, -6.1, 2.4]])
    for interp in ("bilinear", "lanczos2"):
        got = _i32(warp_frames_plain(frames, ts, 0, interp=interp))
        want = _i32(warp.warp_image_bgr(frames, ts, interp=interp,
                                        border="zero"))
        diff = np.abs(got - want)
        assert np.mean(diff <= 2) > 0.999, (interp, np.mean(diff <= 2))


# ------------------------------------------------ kernel A's segment form

SEG_H, SEG_W, SEG_CROP = 24, 40, 2
SEG_CASES = {   # (n0, n1, n_out)
    "n_out>=n0": (4, 6, 8),
    "n_out<n0": (6, 4, 3),
    "one_strided_segment": (10, 0, 6),
}


def _segments(streams, n0, n1, seed, channels=3):
    """Random u8 segments of ``streams`` streams; the first is a strided
    view (its stream stride two frames longer than its frames), as a
    clip's ``frames[:, :T - lag]`` is."""
    r = np.random.default_rng(seed)

    def frames(n):
        return torch.from_numpy(r.integers(
            0, 256, (streams, n, SEG_H, SEG_W, channels), dtype=np.uint8))
    return frames(n0 + 2)[:, :n0], frames(n1) if n1 else None


def _seg_transforms(n, model, seed):
    r = np.random.default_rng(seed)
    if model == "similarity":
        scale = [0.01, 0.01, 3.0, 3.0]
    else:
        scale = [0.01, 0.01, 3.0 / SEG_W, 0.01, 0.01, 3.0 / SEG_W, 4e-3,
                 4e-3]
    return _t(r.uniform(-1, 1, (n, len(scale))) * scale)


@pytest.mark.parametrize("case", list(SEG_CASES))
@pytest.mark.parametrize("streams", [1, 3])
@pytest.mark.parametrize("interp", ["bilinear", "lanczos2"])
@pytest.mark.parametrize("model", ["similarity", "homography"])
def test_warp_frame_segments_plain_equals_the_batch(model, interp, streams,
                                                    case):
    """Kernel A's segment form on the CPU (its plain version) gives the
    bytes of ``warp_frames_plain`` on the frames copied into one batch:
    output j of stream s warps [seg0 | seg1][s, j], stream-major."""
    n0, n1, n_out = SEG_CASES[case]
    seg0, seg1 = _segments(streams, n0, n1, seed=70 + n_out)
    ts = _seg_transforms(streams * n_out, model, seed=80 + streams)
    parts = [seg0] + ([seg1] if seg1 is not None else [])
    batch_ = torch.cat(parts, dim=1)[:, :n_out]
    assert torch.equal(
        FrameSegments(seg0, seg1, n_out).batch(), batch_)
    got = warp_frame_segments(
        seg0, seg1, n_out, ts, SEG_CROP, interp=interp, model=model)
    want = warp_frames_plain(batch_.reshape(-1, SEG_H, SEG_W, 3), ts,
                             SEG_CROP, interp=interp, model=model)
    assert got.shape == (streams * n_out, SEG_H - 2 * SEG_CROP,
                         SEG_W - 2 * SEG_CROP, 3)
    assert torch.equal(got, want)


def _bad_segments(what):
    seg0, seg1 = _segments(2, 4, 6, seed=90)
    n_out = 8
    if what == "rows":
        seg1 = seg1[:, :, 1:]
    elif what == "columns":
        seg1 = seg1[:, :, :, 1:].contiguous()
    elif what == "channels":
        seg1 = _segments(2, 6, 0, seed=91, channels=4)[0]
    elif what == "frame_interior":
        seg0, seg1 = seg0[..., :2], seg1[..., :2]
    elif what == "too_few_frames":
        n_out = 11
    return seg0, seg1, n_out


@pytest.mark.parametrize("what", ["rows", "columns", "channels",
                                  "frame_interior", "too_few_frames"])
def test_warp_frame_segments_raises(what):
    """Segments that differ in H, W or C, frames whose (H, W, C) is not
    contiguous, or fewer frames than outputs: the wrapper raises."""
    seg0, seg1, n_out = _bad_segments(what)
    ts = _seg_transforms(2 * n_out, "similarity", seed=92)
    with pytest.raises(ValueError):
        warp_frame_segments(seg0, seg1, n_out, ts)


# ------------------------------------------------------------- sparse chain

def _keypoints(seed, ht=9, wt=12, tile=8):
    r = np.random.default_rng(seed)
    ox = np.arange(wt)[None, :] * tile + r.integers(0, tile, (ht, wt))
    oy = np.arange(ht)[:, None] * tile + r.integers(0, tile, (ht, wt))
    return np.stack([ox, oy], axis=-1).astype(np.int32)


def test_sparse_chain_matches_jax():
    key = natural_image(72, 96, seed=8)
    cx_, cy_ = _keypoints(1), _keypoints(2)
    r = np.random.default_rng(3)
    gx, gy = (r.normal(0, 20, cx_.shape[:2]).astype(np.float32)
              for _ in range(2))
    tv_x, tv_y = (r.uniform(0, 255, cx_.shape[:2]).astype(np.float32)
                  for _ in range(2))
    mx, my = ((r.uniform(size=cx_.shape[:2]) < 0.8).astype(np.float32)
              for _ in range(2))
    t_ul = [0.004, -0.003, 1.3, -0.8]
    jx, jy = sparse.sparse_jacobian(_t(gx), _t(gy), torch.tensor(cx_),
                                    torch.tensor(cy_), 96, 72)
    wjx, wjy = jsparse.sparse_jacobian(gx, gy, cx_, cy_, 96, 72)
    np.testing.assert_allclose(jx.numpy(), np.asarray(wjx), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(jy.numpy(), np.asarray(wjy), rtol=1e-6,
                               atol=1e-6)
    got = sparse.sparse_warp_sample(torch.tensor(key), torch.tensor(cx_),
                                    _t(t_ul)).numpy()
    want = np.asarray(jsparse.sparse_warp_sample(key, cx_,
                                                 jnp.asarray(t_ul)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    got = sparse.sparse_warpdiff(_t(tv_x), torch.tensor(key),
                                 torch.tensor(cx_), _t(t_ul)).numpy()
    want = np.asarray(jsparse.sparse_warpdiff(tv_x, key, cx_,
                                              jnp.asarray(t_ul)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    args = (tv_x, tv_y, key, cx_, cy_, wjx, wjy, mx, my)
    got = sparse.sparse_ica(*(torch.tensor(np.asarray(a)) for a in args),
                            _t(t_ul)).numpy()
    want = np.asarray(jsparse.sparse_ica(*args, jnp.asarray(t_ul)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)


def test_sparse_window_forms_match_jax_and_the_gather_forms():
    """The window samplers against JAX's, and against the gather forms
    where the warped 5x5 patch stays inside the image (away from the
    border the two sample the same pixels)."""
    key = natural_image(72, 96, seed=9)
    tile, margin = 8, 4
    wins = patches.extract_tile_windows(torch.tensor(key), tile, margin)
    jwins = jpatches.extract_tile_windows(jnp.asarray(key), tile, margin)
    np.testing.assert_array_equal(wins.float().numpy(),
                                  np.asarray(jwins, np.float32))
    ox, oy = patches.window_origins(9, 12, tile, margin)
    jox, joy = jpatches.window_origins(9, 12, tile, margin)
    np.testing.assert_array_equal(ox.numpy(), np.asarray(jox))
    np.testing.assert_array_equal(oy.numpy(), np.asarray(joy))
    coords = _keypoints(4)
    t_ul = [0.002, 0.001, 0.7, -1.2]
    r = np.random.default_rng(6)
    tv = r.uniform(0, 255, coords.shape[:2]).astype(np.float32)
    got = sparse.sparse_warpdiff_windows(_t(tv), wins, torch.tensor(coords),
                                         _t(t_ul), ox, oy).numpy()
    want = np.asarray(jsparse.sparse_warpdiff_windows(
        tv, jwins, coords, jnp.asarray(t_ul), jox, joy))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    gather = sparse.sparse_warpdiff(_t(tv), torch.tensor(key),
                                    torch.tensor(coords), _t(t_ul)).numpy()
    inner = (slice(1, -1), slice(1, -1))
    np.testing.assert_allclose(got[inner], gather[inner], rtol=0, atol=1e-3)
    jac = r.normal(0, 1, coords.shape[:2] + (4,)).astype(np.float32)
    mask = (r.uniform(size=coords.shape[:2]) < 0.8).astype(np.float32)
    got = sparse.sparse_ica_windows(
        _t(tv), _t(tv), wins, torch.tensor(coords), torch.tensor(coords),
        _t(jac), _t(jac), _t(mask), _t(mask), _t(t_ul), ox, oy).numpy()
    want = np.asarray(jsparse.sparse_ica_windows(
        tv, tv, jwins, coords, coords, jac, jac, mask, mask,
        jnp.asarray(t_ul), jox, joy))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)


# ------------------------------------------------------- small helpers

def test_lanczos2_exact_and_5tap_weights():
    x = np.linspace(-2.5, 2.5, 1001, dtype=np.float32)
    np.testing.assert_allclose(lanczos.lanczos2_exact(torch.tensor(x)).numpy(),
                               np.asarray(jlanczos.lanczos2_exact(x)),
                               rtol=0, atol=1e-6)
    # The polynomial fit's published error (lanczos.py:1-8).
    assert np.abs(lanczos.lanczos2(torch.tensor(x)).numpy()
                  - lanczos.lanczos2_exact(torch.tensor(x)).numpy()
                  ).max() < 4e-4
    frac = np.random.default_rng(0).uniform(0, 1, 257).astype(np.float32)
    got = lanczos.lanczos2_weights_5tap(torch.tensor(frac)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jlanczos.lanczos2_weights_5tap(frac)))
    assert got.shape == (257, 5)


@pytest.mark.parametrize("n", [4, 8])
def test_eigh_sym_matches_jax(n):
    r = np.random.default_rng(n)
    a = r.normal(size=(6, n, n)).astype(np.float32)
    a = a @ a.transpose(0, 2, 1)
    w, v = linalg.eigh_sym(torch.tensor(a))
    for i in range(6):
        jw, jv = jlinalg.eigh_sym(jnp.asarray(a[i]))
        np.testing.assert_allclose(w[i].numpy(), np.asarray(jw), rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(np.abs(v[i].numpy()), np.abs(np.asarray(
            jv)), rtol=0, atol=2e-3)
    rebuilt = (v * w[:, None, :]) @ v.transpose(1, 2)
    np.testing.assert_allclose(rebuilt.numpy(), a, rtol=1e-4, atol=1e-3)
    if n == 4:
        w4, v4 = linalg.eigh_sym4(torch.tensor(a))
        assert torch.equal(w4, w) and torch.equal(v4, v)


def test_transform_helpers_match_jax():
    r = np.random.default_rng(4)
    t = (r.normal(size=(5, 4)) * [0.01, 0.01, 3, 3]).astype(np.float32)
    xy = r.uniform(0, 100, (5, 2)).astype(np.float32)
    np.testing.assert_allclose(T.warp_points(_t(t), _t(xy)).numpy(),
                               np.asarray(JT.warp_points(t, xy)), rtol=1e-6)
    for kw in (dict(), dict(width=W, height=H),
               dict(width=W, height=H, minus_one=False)):
        np.testing.assert_allclose(T.to_affine_matrix(_t(t), **kw).numpy(),
                                   np.asarray(JT.to_affine_matrix(t, **kw)),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(T.corner_points(W, H).numpy(),
                                  np.asarray(JT.corner_points(W, H)))
    np.testing.assert_array_equal(T.make(0.1, -0.2, 3.0, 4.5).numpy(),
                                  np.asarray(JT.make(0.1, -0.2, 3.0, 4.5)))


def test_exports_match_jax():
    assert tpkg.__all__ == jpkg.__all__
    assert tops.__all__ == jops.__all__
    for name in tops.__all__:
        assert callable(getattr(tops, name)), name
