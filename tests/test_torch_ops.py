"""The PyTorch port's ops held to the JAX package's on the same numpy inputs
(CPU). Integer-valued ops must be bit-exact; float ops carry the tolerance
stated beside each assertion. At the end: the port stands alone (no module
of it, and not chip_smoke.py, imports jax or the JAX package), and an entry
point left on its default device (the CUDA card) raises when there is no
card instead of running on the CPU."""

import ast
import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilizer_tpu import config as jcfg
from video_stabilizer_tpu import transforms as JT
from video_stabilizer_tpu.models.stabilizer import bgr_to_gray as j_gray
from video_stabilizer_tpu.ops import argmax as jargmax
from video_stabilizer_tpu.ops import grad as jgrad
from video_stabilizer_tpu.ops import lanczos as jlanczos
from video_stabilizer_tpu.ops import linalg as jlinalg
from video_stabilizer_tpu.ops import patches as jpatches
from video_stabilizer_tpu.ops import select as jselect
from video_stabilizer_tpu.ops.pyr_down import build_pyramid as j_build_pyramid
from video_stabilizer_tpu_torch import config as tcfg
from video_stabilizer_tpu_torch import transforms as TT
from video_stabilizer_tpu_torch.models import batch, chunked
from video_stabilizer_tpu_torch.models.stabilizer import bgr_to_gray
from video_stabilizer_tpu_torch.ops import argmax, grad, lanczos, linalg
from video_stabilizer_tpu_torch.ops import patches, select
from video_stabilizer_tpu_torch.ops.pyr_down import build_pyramid

# Torch's CPU threads would contend with the JAX runtime's in this process;
# at these sizes one thread is several times faster.
torch.set_num_threads(1)


# The JAX side runs jitted where that compiles faster than the many tiny
# programs of eager mode (not the unrolled Jacobi, which compiles slowly).
_j_pyramid = jax.jit(j_build_pyramid, static_argnums=1)
_j_grad_argmax = jax.jit(jargmax.grad_argmax, static_argnums=2)
_j_take = jax.jit(jargmax.take_at_tile_argmax, static_argnums=2)
_j_windows = jax.jit(jpatches.extract_tile_windows_flat, static_argnums=(1, 2))


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30))


@pytest.mark.parametrize("shape", [(96, 128), (2, 37, 51)])
def test_pyramid_bit_exact(shape):
    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    want = _j_pyramid(jnp.asarray(img), 3)
    got = build_pyramid(_t(img), 3)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_grad_xy_bit_exact():
    img = np.random.default_rng(2).integers(0, 256, (2, 40, 56),
                                            dtype=np.uint8)
    jx, jy = jgrad.grad_xy(jnp.asarray(img))
    gx, gy = grad.grad_xy(_t(img))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(jy))


def test_grad_argmax_bit_exact_with_ties():
    # Gradients quantized to a few levels: most tiles hold several maxima,
    # so the tie order (first maximum, rows slowest) decides the result.
    rng = np.random.default_rng(3)
    gx = rng.integers(0, 3, (42, 61)).astype(np.float32) * 0.5
    gy = -rng.integers(0, 2, (42, 61)).astype(np.float32)
    t = 6
    want = _j_grad_argmax(jnp.asarray(gx), jnp.asarray(gy), t)
    got = argmax.grad_argmax(_t(gx), _t(gy), t)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # torch.argmax returns the FIRST maximal index (row-major in the tile).
    tile = torch.zeros((1, 1, t, t))
    tile[0, 0, 2, 4] = tile[0, 0, 2, 1] = tile[0, 0, 5, 0] = 7.0
    idx = argmax.grad_argmax(tile[0, 0], tile[0, 0], t)[0]
    assert int(idx[0, 0]) == 2 * t + 1


def test_take_at_tile_argmax_bit_exact():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (2, 36, 50), dtype=np.uint8)
    idx = rng.integers(0, 16, (2, 9, 12)).astype(np.int32)
    want = _j_take(jnp.asarray(img), jnp.asarray(idx), 4)
    got = argmax.take_at_tile_argmax(_t(img), _t(idx), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tile,margin", [(6, 3), (4, 12)])
def test_extract_tile_windows_flat_bit_exact(tile, margin):
    """The port's keypoint-major (N, P, P) windows are the JAX package's
    (P, P, N) ones with the tile axis moved first, bit for bit."""
    img = np.random.default_rng(5).integers(0, 256, (38, 53), dtype=np.uint8)
    want = _j_windows(jnp.asarray(img), tile, margin)
    got = patches.extract_tile_windows_flat(_t(img), tile, margin)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  np.moveaxis(np.asarray(want), -1, 0))


def test_bgr_to_gray_bit_exact():
    bgr = np.random.default_rng(6).integers(0, 256, (3, 64, 96, 3),
                                            dtype=np.uint8)
    np.testing.assert_array_equal(bgr_to_gray(_t(bgr)).numpy(),
                                  np.asarray(j_gray(jnp.asarray(bgr))))


def test_histogram_mask_equal():
    rng = np.random.default_rng(7)
    # Integer-heavy diffs (many ties at bin edges) plus an overflow tail.
    wd = np.concatenate([rng.integers(0, 40, 300).astype(np.float32),
                         rng.uniform(0, 400, 211).astype(np.float32)])
    rows = np.stack([wd, rng.permutation(wd), np.zeros_like(wd)])
    got = select.histogram_mask(_t(rows), 0.8).numpy()
    for row, g in zip(rows, got):
        want = jselect.histogram_mask(jnp.asarray(row), jnp.float32(0.8))
        np.testing.assert_array_equal(g, np.asarray(want))


def test_transforms_match():
    """<= 1e-6 relative: the same f32 expressions, evaluated elementwise."""
    rng = np.random.default_rng(8)
    t1 = rng.normal(0, [0.01, 0.01, 5, 5], (16, 4)).astype(np.float32)
    t2 = rng.normal(0, [0.01, 0.01, 5, 5], (16, 4)).astype(np.float32)
    xy = rng.uniform(0, 200, (16, 2)).astype(np.float32)
    pairs = [
        (TT.compose(_t(t1), _t(t2)), JT.compose(t1, t2)),
        (TT.inverse(_t(t1)), JT.inverse(t1)),
        (TT.warp_points_center(_t(t1), _t(xy), 64.0, 48.0),
         JT.warp_points_center(t1, xy, 64.0, 48.0)),
        (TT.max_corner_displacement(_t(t1), 128, 96),
         JT.max_corner_displacement(jnp.asarray(t1), 128, 96)),
        (TT.identity((3,)), JT.identity(batch_shape=(3,))),
    ]
    for mo in (False, True):
        pairs.append((TT.center_to_ul(_t(t1), 128, 96, minus_one=mo),
                      JT.center_to_ul(t1, 128, 96, minus_one=mo)))
    for got, want in pairs:
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)


def test_lanczos2_match():
    x = np.linspace(-2.5, 2.5, 1001).astype(np.float32)
    got = lanczos.lanczos2(_t(x)).numpy()
    want = np.asarray(jlanczos.lanczos2(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.all(got[np.abs(x) >= 2] == 0)


def test_regularized_pinv_sym4_match():
    """Same cyclic rotation order; <= 1e-5 relative on well-conditioned
    Hessians (atan2/sin/cos may differ in the last ulp between the two
    libraries), and on one that takes the Tikhonov branch (cond > 1e6)."""
    rng = np.random.default_rng(9)
    mats = []
    for _ in range(6):
        q, _ = np.linalg.qr(rng.normal(size=(4, 4)))
        mats.append((q * rng.uniform(1.0, 50.0, 4)) @ q.T)
    good = np.stack(mats).astype(np.float32)
    got = linalg.regularized_pinv_sym4(_t(good)).numpy()
    want = np.stack([np.asarray(jlinalg.regularized_pinv_sym4(m))
                     for m in good])
    assert _rel_err(got, want) <= 1e-5
    # cond = 1e7: the near-null direction is decoupled, so its f32
    # eigenvalue is exact in both and the regularized inverse well defined.
    q3, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    ill = np.zeros((4, 4))
    ill[0, 0] = 1e-4
    ill[1:, 1:] = (q3 * np.array([1.0, 30.0, 1e3])) @ q3.T
    ill = ill.astype(np.float32)
    got = linalg.regularized_pinv_sym4(_t(ill[None])).numpy()[0]
    want = np.asarray(jlinalg.regularized_pinv_sym4(ill))
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


def test_sample_windows_flat_within_bf16_gap():
    """Products in bf16, sums in f32. Eager JAX rounds each product to bf16
    as torch does: only the f32 summation order differs (measured max
    3.1e-5; bar 1e-4). Under jit, as the aligner runs it, XLA on the CPU
    keeps the products in f32: measured max 0.57 and mean 0.12 intensity;
    bars 1.0 and 0.2."""
    rng = np.random.default_rng(10)
    img = rng.integers(0, 256, (60, 80), dtype=np.uint8)
    wins = _j_windows(jnp.asarray(img), 8, 6)
    p, n = wins.shape[0], wins.shape[-1]
    hi = np.float32(p - 3.0 - 1e-3)
    rel_x = np.clip(rng.uniform(1.0, p - 2.0, (2, n)), 2.0, hi)
    rel_y = np.clip(rng.uniform(1.0, p - 2.0, (2, n)), 2.0, hi)
    rel_x, rel_y = rel_x.astype(np.float32), rel_y.astype(np.float32)
    got = patches.sample_windows_flat(
        _t(np.moveaxis(np.asarray(wins), -1, 0)), _t(rel_x),
        _t(rel_y)).numpy()
    eager = np.asarray(jpatches.sample_windows_flat(wins, rel_x, rel_y))
    assert np.max(np.abs(got - eager)) <= 1e-4
    jitted = np.asarray(
        jax.jit(jpatches.sample_windows_flat)(wins, rel_x, rel_y))
    assert np.max(np.abs(got - jitted)) <= 1.0
    assert np.mean(np.abs(got - jitted)) <= 0.2


def test_keypoint_major_windows_and_stacked_sample_match_jax():
    """The port's (K, N, P, P) windows are the JAX package's tile-grid
    ``extract_tile_windows`` (Ht, Wt, P, P) with (Ht, Wt) flattened, bit
    for bit; ``sample_windows_flat`` on them, each row of positions through
    ``key_index``, is the JAX package's eager sampler on that key's (P, P, N)
    windows within the sum-order bar of the test above (1e-4). The shapes
    are the test above's, whose eager JAX operations are compiled."""
    rng = np.random.default_rng(12)
    imgs = rng.integers(0, 256, (3, 60, 80), dtype=np.uint8)
    got = patches.extract_tile_windows_flat(_t(imgs), 8, 6)
    grid = np.asarray(jax.jit(jax.vmap(functools.partial(
        jpatches.extract_tile_windows, tile=8, margin=6,
        out_dtype=jnp.uint8)))(jnp.asarray(imgs)))
    p, n = grid.shape[-1], grid.shape[1] * grid.shape[2]
    assert got.shape == (3, n, p, p)
    np.testing.assert_array_equal(got.numpy(), grid.reshape(3, n, p, p))
    kidx = np.array([2, 0])
    hi = np.float32(p - 3.0 - 1e-3)
    rel_x = np.clip(rng.uniform(1.0, p - 2.0, (2, 2, n)), 2.0, hi)
    rel_y = np.clip(rng.uniform(1.0, p - 2.0, (2, 2, n)), 2.0, hi)
    rel_x, rel_y = rel_x.astype(np.float32), rel_y.astype(np.float32)
    sample = patches.sample_windows_flat(got, _t(rel_x), _t(rel_y),
                                         key_index=_t(kidx)).numpy()
    for i, k in enumerate(kidx):
        want = np.asarray(jpatches.sample_windows_flat(
            jnp.asarray(np.moveaxis(got[k].numpy(), 0, -1)), rel_x[i],
            rel_y[i]))
        assert np.max(np.abs(sample[i] - want)) <= 1e-4


def test_config_mirrors_jax():
    for jcls, tcls in [(jcfg.AlignerParams, tcfg.AlignerParams),
                       (jcfg.StabilizerParams, tcfg.StabilizerParams)]:
        jf = {f.name: f.default for f in dataclasses.fields(jcls)}
        tf = {f.name: f.default for f in dataclasses.fields(tcls)}
        assert list(jf) == list(tf)
        for name in jf:
            if name != "aligner":
                assert jf[name] == tf[name], name
    jp = jcfg.StabilizerParams(lag=4, smoother_memory=2, crop_pixels=8,
                               aligner=jcfg.AlignerParams(threshold=0.03))
    tp = tcfg.params_from_jax_dict(dataclasses.asdict(jp))
    assert tp.lag == 4 and tp.crop_pixels == 8
    assert tp.aligner.threshold == 0.03
    assert tcfg.pyramid_shapes(1920, 1080, tp.aligner) == \
        jcfg.pyramid_shapes(1920, 1080, jp.aligner)
    for w, h in [(1920, 1080), (128, 96), (3840, 2160)]:
        assert tcfg.tile_size_for(w, h) == jcfg.tile_size_for(w, h)
        assert tcfg.default_residual_bound(w, h) == \
            jcfg.default_residual_bound(w, h)
    assert tcfg.resolve_residual_bound(tp, 1920, 1080) == \
        jcfg.resolve_residual_bound(jp, 1920, 1080)


@pytest.mark.parametrize("kwargs", [dict(dtype="bfloat16")])
def test_unported_settings_raise(kwargs):
    """The one aligner setting the port does not take: kernels B and C run
    float32 operands."""
    with pytest.raises(NotImplementedError):
        tcfg.AlignerParams(**kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(selection="topk"), dict(fixed_iters=4), dict(merge_coarse=2),
    dict(pair_vmap=True)])
def test_aligner_settings_construct_and_convert(kwargs):
    """Settings that once raised are ported: each constructs, and converts
    from the JAX package's params."""
    tp = tcfg.AlignerParams(**kwargs)
    conv = tcfg.params_from_jax_dict(
        dataclasses.asdict(jcfg.AlignerParams(**kwargs)))
    for name, value in kwargs.items():
        assert getattr(tp, name) == getattr(conv, name) == value


def test_unported_output_interp_raises():
    """An interpolation neither package has is refused; the global-base FIR
    output warp is ported: it constructs and converts from the JAX
    package's params."""
    with pytest.raises(ValueError):
        tcfg.StabilizerParams(output_interp="bicubic")
    assert tcfg.StabilizerParams(output_warp="fir").output_warp == "fir"
    tp = tcfg.params_from_jax_dict(dataclasses.asdict(
        jcfg.StabilizerParams(output_warp="fir")))
    assert tp.output_warp == "fir"


def test_ported_settings_accepted():
    """Phase-correlation init and the Lanczos2 output warp are ported, and
    their params convert from the JAX package's."""
    jp = jcfg.StabilizerParams(output_interp="lanczos2",
                               aligner=jcfg.AlignerParams(
                                   phase_correlate=True))
    tp = tcfg.params_from_jax_dict(dataclasses.asdict(jp))
    assert tp.output_interp == "lanczos2" and tp.aligner.phase_correlate


ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "video_stabilizer_tpu")


def _sources():
    files = sorted((ROOT / "video_stabilizer_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_import(path):
    assert path.exists(), path
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = tcfg.StabilizerParams(lag=2, smoother_memory=1, crop_pixels=2)
    frames = np.zeros((4, 40, 48, 3), np.uint8)
    calls = [
        lambda: chunked.init_stream_state(48, 40, params),
        lambda: chunked.ChunkedStabilizer(params),
        lambda: chunked.stabilize_stream_chunked(frames, params, 4),
        lambda: batch.stabilize_clip(frames, params),
        lambda: batch.align_clip(frames, params.aligner),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
