"""The aligner settings of the JAX package that the port takes as they are:
exact top-k selection, the fixed-iteration GN mode of kernel B, the merged
coarse levels and the 2-lane pair step, each held to the JAX package run
with the same settings on the same clip (96x128)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilizer_tpu import config as jcfg
from video_stabilizer_tpu.models import aligner as jaligner
from video_stabilizer_tpu.models import batch as jbatch
from video_stabilizer_tpu.ops import select as jselect
from video_stabilizer_tpu.ops.pyr_down import build_pyramid as j_pyramid
from video_stabilizer_tpu_torch import config as tcfg
from video_stabilizer_tpu_torch import transforms as T
from video_stabilizer_tpu_torch.models import aligner, batch
from video_stabilizer_tpu_torch.ops import select
from video_stabilizer_tpu_torch.ops.gn_solve import gn_corners, gn_solve_plain
from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

# Torch's CPU threads would contend with the JAX runtime's in this process;
# at these sizes one thread is several times faster.
torch.set_num_threads(1)

H, W, N = 96, 128, 12


def _port(jparams):
    return tcfg.params_from_jax_dict(dataclasses.asdict(jparams))


@pytest.fixture(scope="module")
def gray_clip():
    return synth_shaky_clip(N, H, W, seed=71, jitter_px=0.8,
                            pan_px_per_frame=0.3, rot_jitter=0.002,
                            color=False)


def _assert_meas_close(meas, ok, meas_j, ok_j):
    """ok equal; TX/TY within 0.1 px and A/B within 6e-4: the GN
    convergence class of test_torch_streaming.py::_assert_meas_close."""
    np.testing.assert_array_equal(ok, ok_j)
    np.testing.assert_allclose(meas[:, 2:], meas_j[:, 2:], atol=0.1)
    np.testing.assert_allclose(meas[:, :2], meas_j[:, :2], atol=6e-4)


def _clip_pair(clip, jparams):
    meas_j, ok_j = jbatch.align_clip(clip, jparams)
    meas, ok = batch.align_clip(clip, _port(jparams), device="cpu")
    return meas.numpy(), ok.numpy(), np.asarray(meas_j), np.asarray(ok_j)


# -------------------------------------------------------------- top-k mask

@pytest.mark.parametrize("fraction", [0.8, 0.5, 0.001])
def test_topk_mask_bit_equal_with_ties(fraction):
    """Warp diffs with many forced ties (integers, and runs of one value):
    ``jax.lax.top_k`` keeps the lower index among equal values, and so must
    the port."""
    r = np.random.default_rng(5)
    wd = np.floor(r.uniform(0, 6, (3, 2, 97))).astype(np.float32)
    wd[1, 0] = 2.0                       # one value everywhere
    wd[2, 1, 40:] = 0.5
    got = select.topk_mask(torch.tensor(wd), fraction).numpy()
    want = np.stack([[np.asarray(jselect.topk_mask(jnp.asarray(row),
                                                   fraction))
                      for row in item] for item in wd])
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    k = max(int(97 * fraction), 1)
    assert (got.sum(-1) == k).all()


def test_align_clip_topk_matches_jax(gray_clip):
    meas, ok, meas_j, ok_j = _clip_pair(
        gray_clip, jcfg.AlignerParams(selection="topk"))
    assert ok[1:].all()
    _assert_meas_close(meas, ok, meas_j, ok_j)


# ----------------------------------------------------- fixed-iteration GN

_j_align_level = jax.jit(jaligner._align_level,
                         static_argnames=("spec", "params"))
_j_keyframe = jax.jit(jaligner._compute_keyframe,
                      static_argnames=("specs", "params"))


def _near_threshold(spec, key, tmpl, transform, t_k, k: int) -> bool:
    """Whether the port's last step at K iterations (its corners at K - 1
    against K) lies within 10 % of the GN threshold."""
    if k == 0:
        return False
    zero = torch.zeros(1, dtype=torch.int64)
    t_prev = aligner._align_level(
        spec, key, zero, torch.tensor(tmpl)[None], zero,
        torch.tensor(np.asarray(transform))[None],
        tcfg.AlignerParams(fixed_iters=k - 1))[0]
    corners = gn_corners(spec.width, spec.height)
    cx, cy = spec.width * 0.5, spec.height * 0.5
    step = (T.warp_points_center(t_k[:, None], corners, cx, cy)
            - T.warp_points_center(t_prev[:, None], corners, cx, cy))
    threshold = tcfg.AlignerParams().threshold
    return abs(float(step.norm(dim=-1).max()) - threshold) < 0.1 * threshold


@pytest.mark.parametrize("k", [0, 1, 4])
def test_fixed_iters_level_by_level_matches_jax(gray_clip, k):
    """Kernel B's plain version in its fixed mode against the JAX package's
    unrolled fixed-iteration loop, level by level on the same keyframe,
    template and incoming transform: iters == K, the transforms within the
    GN class of test_torch_kernels.py::test_level_by_level_matches_xla_loop
    (A/B 3e-4, TX/TY 6e-2 px), and converged equal wherever the last step
    is not within 10 % of the 0.02 px threshold. Within that band the flag
    follows the rounding: the two loops' steps differ by up to some 1e-3 px
    (bf16 products rounded in other places), and at K = 4 the last L0 step
    of this pair is 0.02003 px in the port."""
    jparams = jcfg.AlignerParams(fixed_iters=k)
    params = _port(jparams)
    specs = jaligner.level_specs(W, H, jparams)
    tspecs = aligner.level_specs(W, H, params)
    key_pyr = [np.asarray(x) for x in j_pyramid(jnp.asarray(gray_clip[5]),
                                                len(specs))]
    tmpl_pyr = [np.asarray(x) for x in j_pyramid(jnp.asarray(gray_clip[4]),
                                                 len(specs))]
    jkey = _j_keyframe(tuple(jnp.asarray(x) for x in key_pyr), specs,
                       jparams)
    tkey = aligner._compute_keyframe([torch.tensor(x)[None]
                                      for x in key_pyr], tspecs)
    dyn = jaligner.make_dyn_params(jparams)
    zero = torch.zeros(1, dtype=torch.int64)
    transform = jnp.zeros(4, jnp.float32)
    for lvl in range(len(specs) - 1, -1, -1):
        t_raw, t_up, failed, iters = _j_align_level(
            specs[lvl], jkey[lvl], jnp.asarray(tmpl_pyr[lvl]), transform,
            jparams, dyn)
        g_raw, _, g_failed, g_iters = aligner._align_level(
            tspecs[lvl], tkey[lvl], zero, torch.tensor(tmpl_pyr[lvl])[None],
            zero, torch.tensor(np.asarray(transform))[None], params)
        assert int(g_iters[0]) == int(iters) == k
        if not _near_threshold(tspecs[lvl], tkey[lvl], tmpl_pyr[lvl],
                               transform, g_raw, k):
            assert bool(g_failed[0]) == bool(failed)
        np.testing.assert_allclose(g_raw[0, :2].numpy(),
                                   np.asarray(t_raw)[:2], atol=3e-4)
        np.testing.assert_allclose(g_raw[0, 2:].numpy(),
                                   np.asarray(t_raw)[2:], atol=6e-2)
        transform = t_up if lvl > 0 else t_raw


def test_fixed_iters_zero_and_converging_forms():
    """K = 0 leaves the transform, reports converged (no step moved a
    corner), disp01 0 and iters 0, as JAX's empty unrolled loop does; and
    at K = the converging loop's own count the two forms agree."""
    r = np.random.default_rng(2)
    p, n, bsz = 12, 40, 3
    args = (torch.tensor(r.integers(0, 256, (2, n, p, p)), dtype=torch.uint8),
            torch.tensor([0, 1, 1]),
            torch.tensor(r.uniform(0, 255, (bsz, 2, n)), dtype=torch.float32),
            torch.tensor(r.normal(0, 2e-3, (bsz, 4, 2, n)),
                         dtype=torch.float32),
            torch.eye(4).repeat(bsz, 1, 1) * 2.0,
            torch.tensor(r.uniform(20, 40, (2, 2, n)), dtype=torch.float32),
            torch.tensor(r.uniform(20, 40, (2, 2, n)), dtype=torch.float32),
            torch.full((n,), 22.0), torch.full((n,), 22.0),
            torch.tensor([[0.001, 0.0, 0.3, -0.2]] * bsz))
    kw = dict(threshold=0.02, width=64, height=48, max_iters=9)
    t, conv, d01, iters = gn_solve_plain(*args, fixed_iters=0, **kw)
    torch.testing.assert_close(t, args[-1], rtol=0, atol=0)
    assert conv.all() and (d01 == 0).all() and (iters == 0).all()
    _, conv0, _, _ = gn_solve_plain(*args, fixed_iters=0,
                                    **dict(kw, threshold=0.0))
    assert not conv0.any()
    t_conv, c_conv, d_conv, i_conv = gn_solve_plain(*args, **kw)
    for i in range(bsz):
        one = [a[i:i + 1] if a.shape[0] == bsz else a for a in args]
        one[1] = args[1][i:i + 1]
        t_k, c_k, d_k, i_k = gn_solve_plain(
            *one, fixed_iters=int(i_conv[i]), **kw)
        torch.testing.assert_close(t_k[0], t_conv[i], rtol=0, atol=0)
        assert bool(c_k[0]) == bool(c_conv[i])
        assert float(d_k[0]) == float(d_conv[i])


def test_video_aligner_fixed_iters_matches_jax(gray_clip):
    jparams = jcfg.AlignerParams(fixed_iters=4)
    jal = jaligner.VideoAligner(jparams)
    tal = aligner.VideoAligner(_port(jparams), device="cpu")
    rows = []
    for f in gray_clip:
        tj, okj = jal.align_next_frame(f)
        tt, okt = tal.align_next_frame(f)
        rows.append((tt.numpy(), bool(okt), np.asarray(tj), bool(okj)))
    meas, ok, meas_j, ok_j = (np.array(c) for c in zip(*rows))
    _assert_meas_close(meas, ok, meas_j, ok_j)


# ------------------------------------------ program-shape options of JAX

@pytest.mark.parametrize("jparams", [
    jcfg.AlignerParams(merge_coarse=2), jcfg.AlignerParams(pair_vmap=True)],
    ids=["merge_coarse=2", "pair_vmap"])
def test_program_shape_options_match_jax(gray_clip, jparams):
    """The port runs the unmerged level loop and one batch of all of a
    clip's aligns whatever these say; JAX's merged loop and 2-lane pair
    step give its own results with the same settings."""
    meas, ok, meas_j, ok_j = _clip_pair(gray_clip, jparams)
    assert ok[1:].all()
    _assert_meas_close(meas, ok, meas_j, ok_j)


def test_homography_ignores_fixed_iters(gray_clip):
    """The 8-DOF aligner runs its converging loop whatever fixed_iters
    says, as in the JAX package (homography_aligner.py:126-215)."""
    clip = gray_clip[:6]
    meas, ok = batch.align_clip(clip, tcfg.AlignerParams(threshold=0.1),
                                device="cpu", model="homography")
    meas_f, ok_f = batch.align_clip(
        clip, tcfg.AlignerParams(threshold=0.1, fixed_iters=2),
        device="cpu", model="homography")
    torch.testing.assert_close(meas_f, meas, rtol=0, atol=0)
    assert torch.equal(ok_f, ok)


# ------------------------------------------------------------ refusals

@pytest.mark.parametrize("kwargs, match", [
    (dict(selection="topk"), "selection='mask'"),
    (dict(fixed_iters=4), "fixed_iters"),
    (dict(gn_kernel="pallas"), "pallas"),
])
def test_merge_coarse_refuses_as_jax(kwargs, match):
    """tests/test_config_validation.py:35-44, mirrored: the same
    combinations raise the same ValueError."""
    with pytest.raises(ValueError, match=match):
        jcfg.AlignerParams(merge_coarse=2, **kwargs)
    with pytest.raises(ValueError, match=match):
        tcfg.AlignerParams(merge_coarse=2, **kwargs)


def test_merge_coarse_valid_combos_construct():
    for kw in (dict(), dict(gn_kernel="auto"), dict(gn_kernel="xla")):
        tcfg.AlignerParams(merge_coarse=2, **kw)
    tcfg.AlignerParams(merge_coarse=1, selection="topk")


def test_bfloat16_refused_because_jax_cannot_run_it():
    """``dtype="bfloat16"`` is the one AlignerParams value the port refuses
    (NotImplementedError at construction). The JAX package constructs it
    but cannot run it: its ``stabilize_clip`` fails while tracing the GN
    ``while_loop``, whose carried transform comes back float32, so there is
    no bf16 run for the port to be held to. The smallest clip that reaches
    the loop: 4 frames of 48x64, lag 2."""
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tcfg.AlignerParams(dtype="bfloat16")
    jp = jcfg.StabilizerParams(aligner=jcfg.AlignerParams(dtype="bfloat16"),
                               lag=2, smoother_memory=1, crop_pixels=2)
    clip = synth_shaky_clip(4, 48, 64, seed=1)
    with pytest.raises(TypeError, match=r"while_loop body function carry "
                       r"input and carry output must have equal types"):
        jbatch.stabilize_clip(clip, jp)
