"""The plain PyTorch versions of the port's two kernels held to the JAX
package on the CPU.

Kernel B (GN solve): its plain version, through the port's ``_align_level``,
level by level against the JAX package's XLA GN loop (``gn_kernel="xla"``)
on the same keyframe and template, with the same incoming transform.

Kernel A (output warp): its plain version against the Pallas output warp it
replaces, run in Pallas interpret mode with the ``taps`` row mechanism.
232x600 frames span 2x2 of the 216x512 tiles, so the per-tile integer bases
differ across the frame."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilizer_tpu import transforms as JT
from video_stabilizer_tpu.config import AlignerParams as JAlignerParams
from video_stabilizer_tpu.models import aligner as jaligner
from video_stabilizer_tpu.ops.pallas_warp import warp_frames_pallas
from video_stabilizer_tpu.ops.pyr_down import build_pyramid as j_pyramid
from video_stabilizer_tpu.ops.warp import warp_image_bgr
from video_stabilizer_tpu_torch.config import AlignerParams
from video_stabilizer_tpu_torch.models import aligner
from video_stabilizer_tpu_torch.ops.gn_solve import gn_solve, gn_solve_plain
from video_stabilizer_tpu_torch.ops.warp_kernel import (
    warp_frames, warp_frames_plain)
from conftest import natural_image

# Torch's CPU threads would contend with the JAX runtime's in this process;
# at these sizes one thread is several times faster.
torch.set_num_threads(1)


# --------------------------------------------------------------------------
# Kernel B: per-level GN solve
# --------------------------------------------------------------------------

H, W = 96, 128
JPARAMS = JAlignerParams(gn_kernel="xla")
PARAMS = AlignerParams()
MOTIONS = [np.array([0.002, -0.003, 1.7, -2.4], np.float32),
           np.array([-0.004, 0.002, -2.6, 1.1], np.float32)]


# The JAX side runs jitted: eagerly it compiles hundreds of tiny programs.
_j_align_level = jax.jit(jaligner._align_level,
                         static_argnames=("spec", "params"))
_j_keyframe = jax.jit(jaligner._compute_keyframe,
                      static_argnames=("specs", "params"))
_j_pyramid = jax.jit(j_pyramid, static_argnums=1)


@jax.jit
def _j_move(img, t_center):
    t_ul = JT.center_to_ul(t_center, W, H)
    return warp_image_bgr(img, JT.inverse(t_ul), interp="lanczos2",
                          border="edge")


def _pair(t_center, seed=11):
    key = natural_image(H, W, seed=seed)
    return key, np.asarray(_j_move(jnp.asarray(key), jnp.asarray(t_center)))


def _levels(img):
    return [np.asarray(x) for x in _j_pyramid(jnp.asarray(img), 3)]


@pytest.mark.parametrize("motion", range(len(MOTIONS)))
def test_level_by_level_matches_xla_loop(motion):
    """The GN convergence class of tests/test_pallas_gn.py:36-38: converged
    equal, A/B within 3e-4, TX/TY within 6e-2 (the loops differ in f32
    summation order and in where the products round to bf16, and a 0.02 px
    step threshold turns that into up to one step of difference, so the
    iteration counts may differ by one). Measured here: A/B 1.2e-4 and
    TX/TY 1.3e-2 at most, iterations equal but once (4 vs 5)."""
    key, moved = _pair(MOTIONS[motion])
    specs = jaligner.level_specs(W, H, JPARAMS)
    tspecs = aligner.level_specs(W, H, PARAMS)
    assert [tuple(vars(s).values()) for s in tspecs] == \
        [tuple(vars(s).values()) for s in specs]
    key_pyr, tmpl_pyr = _levels(key), _levels(moved)
    jkey = _j_keyframe(
        tuple(jnp.asarray(x) for x in key_pyr), specs, JPARAMS)
    tkey = aligner._compute_keyframe(
        [torch.tensor(x)[None] for x in key_pyr], tspecs)
    dyn = jaligner.make_dyn_params(JPARAMS)
    transform = jnp.zeros(4, jnp.float32)
    for lvl in range(len(specs) - 1, -1, -1):
        t_raw, t_up, failed, iters = _j_align_level(
            specs[lvl], jkey[lvl], jnp.asarray(tmpl_pyr[lvl]), transform,
            JPARAMS, dyn)
        g_raw, g_up, g_failed, g_iters = aligner._align_level(
            tspecs[lvl], tkey[lvl], torch.zeros(1, dtype=torch.int64),
            torch.tensor(tmpl_pyr[lvl])[None],
            torch.zeros(1, dtype=torch.int64),
            torch.tensor(np.asarray(transform))[None], PARAMS)
        # disp01 is far below max_displacement here, so failed == not
        # converged on both sides.
        assert bool(g_failed[0]) == bool(failed)
        assert not bool(failed)
        np.testing.assert_allclose(g_raw[0, :2].numpy(),
                                   np.asarray(t_raw)[:2], atol=3e-4)
        np.testing.assert_allclose(g_raw[0, 2:].numpy(),
                                   np.asarray(t_raw)[2:], atol=6e-2)
        assert abs(int(g_iters[0]) - int(iters)) <= 1
        transform = t_up if lvl > 0 else t_raw


def test_batched_items_match_single_items():
    """Items in one launch are independent: two keyframes, three items
    (one keyframe shared) give what each item gives alone."""
    pairs = [_pair(m, seed=s) for m, s in zip(MOTIONS, (11, 12))]
    spec = aligner.level_specs(W, H, PARAMS)[-1]
    lvl = len(aligner.level_specs(W, H, PARAMS)) - 1
    keys = torch.stack([torch.tensor(_levels(k)[lvl]) for k, _ in pairs])
    tmpls = torch.stack([torch.tensor(_levels(m)[lvl]) for _, m in pairs])
    kd = aligner._compute_keyframe([keys], [spec])[0]
    key_index = torch.tensor([1, 0, 1])
    tmpl_index = torch.tensor([1, 0, 0])
    t0 = torch.tensor([[0.0] * 4, [0.0] * 4, [0.001, 0.0, 0.3, -0.2]])
    batch = aligner._align_level(spec, kd, key_index, tmpls, tmpl_index, t0,
                                 PARAMS)
    for i in range(3):
        one = aligner._align_level(spec, kd, key_index[i:i + 1], tmpls,
                                   tmpl_index[i:i + 1], t0[i:i + 1], PARAMS)
        for b, o in zip(batch, one):
            torch.testing.assert_close(b[i:i + 1], o, rtol=0, atol=1e-6)


def test_gn_solve_dispatches_cpu_to_plain():
    """On a CPU tensor the wrapper is the plain version (no launch)."""
    p, n, k, b = 9, 6, 1, 2
    rng = np.random.default_rng(0)
    args = (torch.from_numpy(rng.integers(0, 256, (k, n, p, p),
                                          dtype=np.uint8)),
            torch.zeros(b, dtype=torch.int64),
            torch.from_numpy(rng.uniform(0, 255, (b, 2, n)).astype(
                np.float32)),
            torch.from_numpy(rng.normal(size=(b, 4, 2, n)).astype(
                np.float32)),
            torch.eye(4).expand(b, 4, 4).contiguous() * 1e-4,
            torch.full((k, 2, n), 4.0), torch.full((k, 2, n), 4.0),
            torch.zeros(n), torch.zeros(n), torch.zeros(b, 4))
    kw = dict(threshold=0.02, width=32, height=24, max_iters=5)
    before = gn_solve.launches
    for got, want in zip(gn_solve(*args, **kw), gn_solve_plain(*args, **kw)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert gn_solve.launches == before


# --------------------------------------------------------------------------
# Kernel A: output warp
# --------------------------------------------------------------------------

WH, WW = 232, 600


def _warp_frames(seed):
    return np.stack([
        np.stack([natural_image(WH, WW, seed=seed + 3 * f + k)
                  for k in range(3)], axis=-1) for f in range(2)])


def _cases():
    rng = np.random.default_rng(21)
    return [
        # Integer and sub-pixel translations, one bulk shift past a tile.
        np.array([[0.0, 0.0, 5.0, -9.0], [0.0, 0.0, 0.5, 0.25]]),
        np.array([[0.0, 0.0, -3.37, 7.81], [0.0, 0.0, 230.6, -14.5]]),
        # Rotations and zooms up to |B| = 0.008.
        np.array([[0.004, -0.008, 2.2, -1.3], [-0.003, 0.008, -6.1, 4.4]]),
        np.concatenate([rng.uniform(-0.008, 0.008, (2, 2)),
                        rng.uniform(-25, 25, (2, 2))], axis=1),
    ]


def _one_channel_count(frames, ts, channels, seed):
    """One frame of ``channels`` channels: the first three of the RGB
    frame, then one more natural image."""
    extra = natural_image(WH, WW, seed=seed)[None, ..., None]
    return (np.concatenate([frames[:1], extra], axis=-1)[..., :channels],
            ts[:1])


@pytest.mark.parametrize("case", range(6))
def test_plain_warp_matches_pallas_interpret(case):
    """>= 99.9 % of pixels bit-equal, max 1 LSB: the same f32 arithmetic,
    so only a .5 rounding boundary can move a pixel. Cases 0-3: 2 frames of
    3 channels; cases 4 and 5: one frame of 1 and of 4 channels under the
    rotation cases (the card check holds the kernel to this plain version
    at those counts too). Measured: 100 %, 99.992 %, 99.997 %, 99.999 %,
    99.9986 % and 99.9987 % equal, max 1 LSB."""
    frames = _warp_frames(seed=5 * case)
    ts = _cases()[case if case < 4 else case - 2].astype(np.float32)
    if case >= 4:
        frames, ts = _one_channel_count(frames, ts, (1, 4)[case - 4],
                                        seed=90 + case)
    want = np.asarray(warp_frames_pallas(
        jnp.asarray(frames), jnp.asarray(ts), interpret=True,
        qy_mode="taps"), np.int32)
    got = warp_frames_plain(torch.from_numpy(frames),
                            torch.from_numpy(ts)).numpy().astype(np.int32)
    diff = np.abs(got - want)
    assert diff.max() <= 1, diff.max()
    assert np.mean(diff == 0) >= 0.999, np.mean(diff == 0)


def test_crop_is_a_slice_of_the_uncropped_warp():
    frames = torch.from_numpy(_warp_frames(seed=40)[:, :48, :64])
    ts = torch.tensor([[0.002, -0.003, 4.6, -2.2]] * 2)
    full = warp_frames(frames, ts)
    cropped = warp_frames(frames, ts, crop=8)
    assert cropped.shape == (2, 48 - 16, 64 - 16, 3)
    torch.testing.assert_close(cropped, full[:, 8:-8, 8:-8], rtol=0, atol=0)


def test_wrapper_dispatches_on_device():
    """A CPU tensor runs the plain version and counts no launch; a tensor
    on any other device than cpu/cuda is refused."""
    frames = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    ts = torch.zeros((1, 4))
    before = warp_frames.launches
    torch.testing.assert_close(warp_frames(frames, ts),
                               warp_frames_plain(frames, ts))
    assert warp_frames.launches == before
    with pytest.raises(ValueError):
        warp_frames(frames.to("meta"), ts.to("meta"))
