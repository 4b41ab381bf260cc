"""The port's homography slice held to the JAX package on the CPU, module by
module: the 8-DOF algebra, the 8x8 round-robin pseudo-inverse, phase
correlation, the homography keyframe, kernel C's plain version level by
level against the XLA GN loop of ``_align_level_h``, and kernel A's new
forms against the Pallas output warp in interpret mode. Each bar is stated
with its reason and the gap measured here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilizer_tpu import homography as JH
from video_stabilizer_tpu.config import AlignerParams as JAlignerParams
from video_stabilizer_tpu.models import aligner as jaligner
from video_stabilizer_tpu.models import homography_aligner as jha
from video_stabilizer_tpu.ops import linalg as jlinalg
from video_stabilizer_tpu.ops.pallas_warp import warp_frames_pallas
from video_stabilizer_tpu.ops.phase_corr import phase_correlate as j_phase
from video_stabilizer_tpu.ops.pyr_down import build_pyramid as j_pyramid
from video_stabilizer_tpu_torch import homography as TH
from video_stabilizer_tpu_torch.config import AlignerParams
from video_stabilizer_tpu_torch.models import aligner
from video_stabilizer_tpu_torch.models import homography_aligner as ha
from video_stabilizer_tpu_torch.ops import linalg
from video_stabilizer_tpu_torch.ops.gn8_solve import (
    gn8_solve, gn8_solve_plain)
from video_stabilizer_tpu_torch.ops.phase_corr import phase_correlate
from video_stabilizer_tpu_torch.ops.warp_kernel import (
    warp_frames, warp_frames_plain)
from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip
from conftest import natural_image

# Torch's CPU threads would contend with the JAX runtime's in this process;
# at these sizes one thread is several times faster.
torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _params(n, seed):
    """(n, 8) homographies of the size the stabilizer meets: linear part and
    normalized translation ~1e-2, perspective ~2e-3."""
    return np.random.default_rng(seed).normal(
        0, [0.01, 0.01, 0.01, 0.01, 0.01, 0.01, 0.002, 0.002],
        (n, 8)).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30))


# --------------------------------------------------------------------------
# Algebra, pseudo-inverse, phase correlation, keyframe
# --------------------------------------------------------------------------

def test_homography_algebra_matches_jax():
    """Compose within 1e-6 and inverse within 1e-5, relative to the largest
    entry of H = to_matrix(p) (about 1): p0 and p4 are H00 - 1 and H11 - 1,
    and an entry such as H21 of a product is a sum of terms that cancel,
    so an element-wise relative bar would measure the cancellation, not
    the port. The products round in another order than XLA's 3x3 dot and
    LU inverse. Measured: compose 1.2e-7, inverse 1.2e-7. The rest is
    element-wise within 1e-6 relative (measured: exact)."""
    p1, p2 = _params(16, 1), _params(16, 2)
    xy = np.random.default_rng(3).uniform(0, 200, (16, 2)).astype(np.float32)
    sim = np.random.default_rng(4).normal(0, [0.01, 0.01, 5, 5],
                                          (16, 4)).astype(np.float32)

    def mat(p):
        return np.asarray(JH.to_matrix(jnp.asarray(np.asarray(p))))

    for got, want, bar in [
            (TH.compose(_t(p1), _t(p2)), JH.compose(p1, p2), 1e-6),
            (TH.inverse(_t(p1)), JH.inverse(p1), 1e-5)]:
        gap = np.abs(mat(got) - mat(want)).max(axis=(-2, -1))
        assert np.all(gap <= bar * np.abs(mat(want)).max(axis=(-2, -1)))
    exact = [
        (TH.to_matrix(_t(p1)), JH.to_matrix(p1)),
        (TH.from_matrix(TH.to_matrix(_t(p1)) * 1.5),
         JH.from_matrix(JH.to_matrix(p1) * 1.5)),
        (TH.warp_norm(_t(p1), _t(xy) / 200.0), JH.warp_norm(p1, xy / 200.0)),
        (TH.warp_points(_t(p1), _t(xy), 128, 96),
         JH.warp_points(p1, xy, 128, 96)),
        (TH.norm_coords(_t(xy), 128, 96), JH.norm_coords(xy, 128, 96)),
        (TH.denorm_coords(_t(xy), 128, 96), JH.denorm_coords(xy, 128, 96)),
        (TH.max_corner_displacement(_t(p1), 128, 96),
         JH.max_corner_displacement(jnp.asarray(p1), 128, 96)),
        (TH.sim_to_homography(_t(sim), 128, 96),
         JH.sim_to_homography(sim, 128, 96)),
        (TH.identity((3,)), JH.identity(batch_shape=(3,))),
    ]
    exact += list(zip(TH.jacobian_rows(_t(xy[:, 0]), _t(xy[:, 1])),
                      JH.jacobian_rows(xy[:, 0], xy[:, 1])))
    for got, want in exact:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=0)


def test_inverse_needs_no_linalg_and_round_trips():
    """The adjugate inverse composes back to the identity within f32
    rounding (measured 2.4e-7)."""
    p = _t(_params(32, 5))
    assert float(TH.compose(p, TH.inverse(p)).abs().max()) <= 1e-6


def test_regularized_pinv_8x8_matches_jax():
    """The same round-robin rotation order; well-conditioned Hessians agree
    within 1e-5 of the largest entry of the inverse (measured 4.1e-7;
    atan2/sin/cos and XLA's dot may round in the last ulp). The 4x4 path
    still takes the cyclic order: bit-equal to ``eigh_sym4_cyclic``."""
    rng = np.random.default_rng(9)
    mats = []
    for _ in range(4):
        q, _ = np.linalg.qr(rng.normal(size=(8, 8)))
        mats.append((q * rng.uniform(1.0, 50.0, 8)) @ q.T)
    good = np.stack(mats).astype(np.float32)
    got = linalg.regularized_pinv_sym4(_t(good)).numpy()
    want = np.stack([np.asarray(jlinalg.regularized_pinv_sym4(m))
                     for m in good])
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))
    assert [r for r in linalg._round_robin_rounds(8)] == \
        [r for r in jlinalg._round_robin_rounds(8)]
    q4, _ = np.linalg.qr(rng.normal(size=(4, 4)))
    h4 = _t(((q4 * rng.uniform(1.0, 50.0, 4)) @ q4.T).astype(np.float32))
    w4, v4 = linalg.eigh_sym4_cyclic(h4)
    vs = v4 * torch.where(w4 > 0, 1.0 / w4, 0.0)[None, :]
    direct = (vs[:, :, None] * v4.T[None, :, :]).sum(-2)
    torch.testing.assert_close(linalg.regularized_pinv_sym4(h4), direct,
                               rtol=0, atol=0)


@pytest.mark.parametrize("h,w,seed,shift_bar,resp_bar", [
    (60, 80, 5, 1e-3, 1e-4), (24, 32, 3, 2e-2, 5e-3)])
def test_phase_correlate_matches_jax(h, w, seed, shift_bar, resp_bar):
    """Consecutive frames of a shaky clip (sub-pixel shifts), batched: the
    first-maximum peaks are equal, so the shifts and responses agree
    within the FFT libraries' rounding. The cross-power spectrum is divided
    by its magnitude bin by bin, so a bin with little energy passes that
    rounding on at full weight, most at small sizes. At 60x80 the bars are
    1e-3 px and 1e-4 relative (measured 4.8e-6 px, 2.8e-6); at 24x32, the
    phase level of a 96x128 frame, 2e-2 px and 5e-3 (measured 8.1e-3 px,
    1.4e-3). A zero image gives response 0 and shift 0, no NaN."""
    clip = synth_shaky_clip(8, h, w, seed=seed, jitter_px=1.5,
                            pan_px_per_frame=0.7, color=False)
    prev = np.concatenate([np.zeros_like(clip[:1]), clip[:-1]])
    shift, resp = phase_correlate(_t(prev), _t(clip))
    assert shift.shape == (8, 2) and resp.shape == (8,)
    j_phase_jit = jax.jit(j_phase)
    for i in range(8):
        js, jr = j_phase_jit(jnp.asarray(prev[i], jnp.float32),
                             jnp.asarray(clip[i], jnp.float32))
        np.testing.assert_allclose(shift[i].numpy(), np.asarray(js),
                                   atol=shift_bar)
        np.testing.assert_allclose(float(resp[i]), float(jr), rtol=resp_bar,
                                   atol=1e-12)
    assert float(resp[0]) == 0.0 and not shift[0].any()
    assert bool(torch.isfinite(shift).all()) and float(resp[1:].min()) > 0.5


H, W = 96, 128
JPARAMS = JAlignerParams()
PARAMS = AlignerParams()
_j_pyramid = jax.jit(j_pyramid, static_argnums=1)
_j_keyframe = jax.jit(jha._compute_keyframe_h,
                      static_argnames=("specs", "params"))
_j_align_level = jax.jit(jha._align_level_h,
                         static_argnames=("spec", "params"))
# Injected homographies with perspective terms (test_pallas_gn8.py:37-48).
MOTIONS = [np.array([0.002, -0.004, 1.5 / W, 0.003, 0.001, -1.0 / W, 0.004,
                     -0.003], np.float32),
           np.array([-0.003, 0.002, -2.0 / W, -0.002, 0.003, 1.2 / W,
                     -0.003, 0.004], np.float32)]


def _levels(img, n):
    return [np.asarray(x) for x in _j_pyramid(jnp.asarray(img), n)]


def test_compute_keyframe_h_matches_jax():
    """Indices, coordinates and windows bit-exact; the Jacobian within 1e-6
    of its largest entry (the same f32 expressions; measured: exact)."""
    specs = jaligner.level_specs(W, H, JPARAMS)
    pyr = _levels(natural_image(H, W, seed=7), len(specs))
    want = _j_keyframe(tuple(jnp.asarray(x) for x in pyr), specs, JPARAMS)
    got = ha._compute_keyframe_h([_t(x)[None] for x in pyr],
                                 aligner.level_specs(W, H, PARAMS))
    for g, w in zip(got, want):
        for name in ("idx_x", "idx_y", "coords"):
            np.testing.assert_array_equal(getattr(g, name)[0].numpy(),
                                          np.asarray(getattr(w, name)))
        np.testing.assert_array_equal(                   # (N, P, P) here
            g.windows[0].numpy(), np.moveaxis(np.asarray(w.windows), -1, 0))
        assert g.jac.shape == (1,) + w.jac.shape
        jac_w = np.asarray(w.jac)
        assert np.max(np.abs(g.jac[0].numpy() - jac_w)) <= \
            1e-6 * np.max(np.abs(jac_w))


@pytest.mark.parametrize("motion", range(len(MOTIONS)))
def test_gn8_level_by_level_matches_xla_loop(motion):
    """Kernel C's plain version, through the port's ``_align_level_h``,
    against the JAX package's XLA GN loop on the same keyframe and template
    with the same incoming p: the converged (failed) flags equal and the
    corner error below 0.08 px, the convergence class of
    test_pallas_gn8.py (the loops differ in f32 summation order and in
    where the products round to bf16). Measured: at most 0.037 px."""
    specs = jaligner.level_specs(W, H, JPARAMS)
    tspecs = aligner.level_specs(W, H, PARAMS)
    key = natural_image(H, W, seed=50)
    # The template samples the keyframe through the motion (kernel A's
    # homography form, plain version), as test_pallas_gn8.py makes it.
    moved = warp_frames_plain(
        _t(key)[None, ..., None], _t(MOTIONS[motion])[None], interp="lanczos2",
        model="homography")[0, ..., 0].numpy()
    key_pyr, tmpl_pyr = _levels(key, len(specs)), _levels(moved, len(specs))
    jkey = _j_keyframe(tuple(jnp.asarray(x) for x in key_pyr), specs,
                       JPARAMS)
    tkey = ha._compute_keyframe_h([_t(x)[None] for x in key_pyr], tspecs)
    dyn = jaligner.make_dyn_params(JPARAMS)
    zero = torch.zeros(1, dtype=torch.int64)
    p = jnp.zeros(8, jnp.float32)
    for lvl in range(len(specs) - 1, -1, -1):
        w, h = specs[lvl].width, specs[lvl].height
        p_j, failed_j = _j_align_level(specs[lvl], jkey[lvl],
                                       jnp.asarray(tmpl_pyr[lvl]), p,
                                       JPARAMS, dyn)
        p_t, failed_t, _ = ha._align_level_h(
            tspecs[lvl], tkey[lvl], zero, _t(tmpl_pyr[lvl])[None], zero,
            _t(np.asarray(p))[None], PARAMS)
        assert bool(failed_t[0]) == bool(failed_j)
        assert not bool(failed_j)
        corners = jnp.asarray([[0.0, 0.0], [w - 1.0, 0.0], [0.0, h - 1.0],
                               [w - 1.0, h - 1.0]])
        err = np.hypot(*(np.asarray(JH.warp_points(p_j, corners, w, h))
                         - np.asarray(JH.warp_points(
                             jnp.asarray(p_t[0].numpy()), corners, w,
                             h))).T)
        assert err.max() < 0.08, (lvl, err.max())
        p = p_j
    # The perspective terms were recovered, not left at 0.
    assert np.abs(np.asarray(p)[6:]).min() > 1e-3


def test_gn8_solve_dispatches_cpu_to_plain():
    """On a CPU tensor the wrapper is the plain version (no launch)."""
    p, n, k, b = 9, 6, 1, 2
    rng = np.random.default_rng(0)
    args = (_t(rng.integers(0, 256, (k, n, p, p), dtype=np.uint8)),
            torch.zeros(b, dtype=torch.int64),
            _t(rng.uniform(0, 255, (b, 2, n)).astype(np.float32)),
            _t(rng.normal(size=(b, 8, 2, n)).astype(np.float32)),
            torch.eye(8).expand(b, 8, 8).contiguous() * 1e-6,
            _t(rng.uniform(-0.4, 0.4, (k, 2, n)).astype(np.float32)),
            _t(rng.uniform(-0.3, 0.3, (k, 2, n)).astype(np.float32)),
            torch.zeros(n), torch.zeros(n), torch.zeros(b, 8))
    kw = dict(threshold=0.02, width=32, height=24, max_iters=5)
    before = gn8_solve.launches
    for got, want in zip(gn8_solve(*args, **kw),
                         gn8_solve_plain(*args, **kw)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert gn8_solve.launches == before
    with pytest.raises(ValueError):
        gn8_solve(*args[:4], args[4][:, :4, :4].contiguous(), *args[5:], **kw)


# --------------------------------------------------------------------------
# Kernel A: the homography and Lanczos2 forms
# --------------------------------------------------------------------------

WH, WW = 232, 600


def _warp_frames(seed):
    return np.stack([natural_image(WH, WW, seed=seed + k)
                     for k in range(3)], axis=-1)[None]


def _form_transform(model, seed):
    rng = np.random.default_rng(seed)
    if model == "similarity":
        return np.concatenate([rng.uniform(-0.008, 0.008, 2),
                               rng.uniform(-25, 25, 2)])[None]
    p = rng.uniform(-4e-3, 4e-3, 8)
    p[[2, 5]] = rng.uniform(-25, 25, 2) / WW
    return p[None]


@pytest.mark.parametrize("model,interp", [
    ("homography", "lanczos2"), ("similarity", "lanczos2"),
    ("homography", "bilinear")])
def test_plain_warp_forms_match_pallas_interpret(model, interp):
    """>= 99.9 % of pixels bit-equal, max 1 LSB: the same f32 arithmetic
    (a .5 rounding boundary can move a pixel where XLA on the CPU rounds a
    product or division otherwise). 2x2 of the 216x512 tiles, |p6|, |p7|
    up to 4e-3, and the zero border inside the frame (a Lanczos2 tap there
    reads 0 and keeps its weight in the normalizer). Measured: max 1 LSB;
    99.997 %, 99.997 % and 99.996 % equal."""
    frames = _warp_frames(seed=17)
    ts = _form_transform(model, seed=23).astype(np.float32)
    want = np.asarray(warp_frames_pallas(
        jnp.asarray(frames), jnp.asarray(ts), interp=interp, model=model,
        interpret=True, qy_mode="taps"), np.int32)
    got = warp_frames_plain(_t(frames), _t(ts), interp=interp,
                            model=model).numpy().astype(np.int32)
    assert (want == 0).any(axis=-1).mean() > 0.001     # the border shows
    diff = np.abs(got - want)
    assert diff.max() <= 1, diff.max()
    assert np.mean(diff == 0) >= 0.999, np.mean(diff == 0)


def test_warp_form_checks_and_crop():
    """The crop of every form is a slice of its uncropped warp; a transform
    of the wrong width for its model is refused; a CPU tensor counts no
    launch."""
    frames = _t(_warp_frames(seed=40)[:, :48, :64])
    p = _t(np.array([[0.002, -0.001, 0.03, 0.001, 0.002, -0.02, 0.003,
                      -0.002]], np.float32))
    before = warp_frames.launches
    for interp in ("bilinear", "lanczos2"):
        full = warp_frames(frames, p, interp=interp, model="homography")
        cropped = warp_frames(frames, p, 8, interp=interp,
                              model="homography")
        torch.testing.assert_close(cropped, full[:, 8:-8, 8:-8], rtol=0,
                                   atol=0)
    assert warp_frames.launches == before
    with pytest.raises(ValueError):
        warp_frames(frames, p[:, :4].contiguous(), model="homography")
    with pytest.raises(ValueError):
        warp_frames(frames, p[:, :4].contiguous(), interp="bicubic")
