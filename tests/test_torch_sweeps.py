"""The port's traced-parameter sweeps held to the JAX package on the CPU:
``DynAlignParams`` through the batched aligner (``align_clip_impl`` with
(C,) fields against JAX's ``jax.lax.map`` over combos,
apps/grid_search_align.py:103-121), the per-item threshold of kernels B
and C (plain versions), the per-row keep fraction of the histogram
selection, ``dyn`` through the homography aligner, and the smoother
sweep's per-combo lambda and decay. 96x128, 12 frames, 4 combos."""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilizer_tpu import config as jcfg
from video_stabilizer_tpu.models import aligner as jaligner
from video_stabilizer_tpu.models import batch as jbatch
from video_stabilizer_tpu.models import homography_aligner as jha
from video_stabilizer_tpu.ops import select as jselect
from video_stabilizer_tpu.ops.pyr_down import build_pyramid as j_pyramid
from video_stabilizer_tpu_torch import config as tcfg
from video_stabilizer_tpu_torch import homography as TH
from video_stabilizer_tpu_torch.models import aligner, batch
from video_stabilizer_tpu_torch.models import homography_aligner as ha
from video_stabilizer_tpu_torch.ops import gn8_solve as gn8_mod
from video_stabilizer_tpu_torch.ops import gn_solve as gn_mod
from video_stabilizer_tpu_torch.ops import select
from video_stabilizer_tpu_torch.ops.warp_kernel import warp_frames_plain
from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip
from conftest import natural_image

# Torch's CPU threads would contend with the JAX runtime's in this process;
# at these sizes one thread is several times faster.
torch.set_num_threads(1)

H, W, N = 96, 128, 12
# Three combos of the reference's grid (grid_search_align.cpp:135-146) and
# one whose failure bound fails nearly every frame at the coarsest level:
# the bound acts per combo.
COMBOS = np.asarray([(0.01, 0.7, 5.0), (0.02, 0.8, 10.0),
                     (0.04, 0.9, 20.0), (0.02, 0.9, 0.05)], np.float32)
# The GN convergence class of tests/test_torch_chunked.py: the JAX
# package's own two GN loops differ by this much on such 96x128 clips.
T_BAR, AB_BAR = 0.1, 6e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _dyn_t(combos):
    return aligner.DynAlignParams(*(_t(combos[:, i]) for i in range(3)))


def _dyn_j(combos):
    return jaligner.DynAlignParams(*(jnp.asarray(combos[:, i])
                                     for i in range(3)))


@pytest.fixture(scope="module")
def gray_clip():
    return synth_shaky_clip(N, H, W, seed=3, jitter_px=1.0,
                            pan_px_per_frame=0.3, color=False)


@pytest.mark.parametrize("selection", ["mask", "topk"])
def test_align_clip_sweep_matches_jax(gray_clip, selection):
    """All combos in one level loop against the JAX package's lax.map over
    ``align_clip_impl(..., dyn=d)``: ok equal on every frame of every combo
    (the 0.05 px bound fails all frames but at most two, the others none),
    measurements
    within the GN class. With topk the fraction is the static
    ``smallest_fraction`` in both packages (aligner.py:211-212). Measured:
    mask A/B 4.7e-4, TX/TY 0.057 px; topk 3.5e-4, 0.050 px."""
    jp = jcfg.AlignerParams(selection=selection)
    tp = tcfg.AlignerParams(selection=selection)
    run = jax.jit(lambda g, d: jax.lax.map(
        lambda x: jbatch.align_clip_impl(g, jp, W, H, dyn=x), d))
    meas_j, ok_j = (np.asarray(a) for a in run(jnp.asarray(gray_clip),
                                                 _dyn_j(COMBOS)))
    meas, ok = batch.align_clip_impl(_t(gray_clip), tp, W, H,
                                     dyn=_dyn_t(COMBOS))
    assert meas.shape == (len(COMBOS), N, 4) and ok.shape == (len(COMBOS), N)
    meas, ok = meas.numpy(), ok.numpy()
    np.testing.assert_array_equal(ok, ok_j)
    assert ok[:3, 1:].all() and ok[3].sum() <= 2
    both = ok & ok_j
    assert np.abs(meas[..., :2] - meas_j[..., :2])[both].max() <= AB_BAR
    assert np.abs(meas[..., 2:] - meas_j[..., 2:])[both].max() <= T_BAR


def test_dyn_with_scalar_fields_is_params(gray_clip):
    """0-d fields from ``make_dyn_params`` give the run without ``dyn``
    bit for bit; (C,) fields of different lengths and per-item fields of
    the wrong length are refused."""
    tp = tcfg.AlignerParams()
    clip = _t(gray_clip[:6])
    want = batch.align_clip_impl(clip, tp, W, H)
    got = batch.align_clip_impl(clip, tp, W, H,
                                dyn=aligner.make_dyn_params(tp,
                                                            device="cpu"))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    bad = aligner.DynAlignParams(torch.ones(3), torch.ones(2), torch.ones(3))
    with pytest.raises(ValueError, match="one length"):
        batch.align_clip_impl(clip, tp, W, H, dyn=bad)
    with pytest.raises(ValueError, match="dyn.threshold"):
        aligner.per_item_params(
            aligner.DynAlignParams(torch.ones(3), torch.ones(()),
                                   torch.ones(())), tp, 4, "cpu")


def _captured_items(solve_name, module, clip, params, model):
    """Each level's (args, kwargs) of kernel B or C on a clip's aligns."""
    calls = []
    real = getattr(module, solve_name)

    def spy(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    with mock.patch.object(module, solve_name, spy):
        batch.align_clip(clip, params, device="cpu", model=model)
    return calls


@pytest.fixture(scope="module")
def captured_items(gray_clip):
    """Kernel B's and C's (args, kwargs) at every level of 8 frames'
    aligns, each captured once: {"B": ..., "C": ...}."""
    clip = gray_clip[:8]
    return {"B": _captured_items("gn_solve", aligner, clip,
                                 tcfg.AlignerParams(), "similarity"),
            "C": _captured_items("gn8_solve", ha, clip,
                                 tcfg.AlignerParams(threshold=0.1),
                                 "homography")}


@pytest.mark.parametrize("kernel", ["B", "B fixed 3", "C"])
def test_plain_per_item_threshold_equals_items_alone(captured_items, kernel):
    """Kernel B's and C's plain versions with one threshold per item give,
    for every item, the bits of that item run alone with its threshold as
    a scalar, at every level of 8 frames' aligns (threshold 0 stops no
    loop, 0.5 px stops most after a step or two)."""
    calls = captured_items[kernel[0]]
    solve = (gn8_mod.gn8_solve_plain if kernel == "C"
             else gn_mod.gn_solve_plain)
    # The per-item operands: key_index, tmpl, jac_masked, hinv, t_init.
    per_item = (1, 2, 3, 4, 9)
    extra = dict(fixed_iters=3) if kernel == "B fixed 3" else {}
    assert len(calls) == 3
    for args, kw in calls:
        items = args[9].shape[0]
        thr = torch.linspace(0.0, 0.5, items)
        full = solve(*args, **dict(kw, threshold=thr, **extra))
        for i in range(items):
            one = [x[i:i + 1] if j in per_item else x
                   for j, x in enumerate(args)]
            alone = solve(*one, **dict(kw, threshold=float(thr[i]), **extra))
            for f, a in zip(full, alone):
                assert torch.equal(f[i:i + 1], a), (kw["width"], i)


def test_histogram_mask_per_row_fraction_matches_jax():
    """One keep fraction per row, floor(N * fraction) in float32 as
    select.py:50 forms it: bit-equal to the JAX package's traced fraction
    under vmap. The top-k selection keeps its static fraction whatever the
    per-item one (aligner.py:211-212)."""
    rng = np.random.default_rng(5)
    wd = rng.uniform(0, 300, (6, 2, 517)).astype(np.float32)
    wd[:, :, ::7] = np.floor(wd[:, :, ::7])          # ties at bin edges
    frac = rng.uniform(0.5, 0.95, 6).astype(np.float32)
    want = jax.vmap(lambda w, f: jax.vmap(
        lambda r: jselect.histogram_mask(r, f))(w))(jnp.asarray(wd),
                                                    jnp.asarray(frac))
    got = aligner.selection_mask(_t(wd), tcfg.AlignerParams(), _t(frac))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    topk = tcfg.AlignerParams(selection="topk")
    np.testing.assert_array_equal(
        aligner.selection_mask(_t(wd), topk, _t(frac)).numpy(),
        select.topk_mask(_t(wd), topk.smallest_fraction).numpy())


def test_homography_dyn_matches_jax():
    """``dyn`` through the 8-DOF level loop: four combos as four items of
    one ``align_all_levels_h`` against the JAX package's vmap over
    ``align_all_levels_h(..., dyn=d)`` on a pair moved by a homography with
    perspective (test_torch_homography.py's first motion): failed flags
    equal, corners within 0.1 px, the last combo's 0.05 px bound failing.
    Thresholds of 0.04-0.08 px: two loops that stop one step apart differ
    by up to the threshold (at 0.1 px the gap reached 0.113 px), and at
    96x128 the 8-DOF loop's convergence at 0.02 px turns on bf16 rounding
    (ROADMAP queue 3). Measured: 0.053 px."""
    combos = np.asarray([(0.05, 0.8, 10.0), (0.04, 0.7, 5.0),
                         (0.08, 0.9, 20.0), (0.05, 0.8, 0.05)], np.float32)
    jp, tp = jcfg.AlignerParams(), tcfg.AlignerParams()
    motion = np.array([0.002, -0.004, 1.5 / W, 0.003, 0.001, -1.0 / W,
                       0.004, -0.003], np.float32)
    key = natural_image(H, W, seed=50)
    moved = warp_frames_plain(_t(key)[None, ..., None], _t(motion)[None],
                              interp="lanczos2",
                              model="homography")[0, ..., 0].numpy()
    specs = jaligner.level_specs(W, H, jp)
    pyr = jax.jit(j_pyramid, static_argnums=1)
    key_pyr = [np.asarray(x) for x in pyr(jnp.asarray(key), len(specs))]
    tmpl_pyr = [np.asarray(x) for x in pyr(jnp.asarray(moved), len(specs))]

    @jax.jit
    def run_j(tmpl, keyp, dyn):
        kd = jha._compute_keyframe_h(keyp, specs, jp)
        return jax.vmap(lambda d: jha.align_all_levels_h(
            tmpl, kd, specs, jp, jnp.zeros(8, jnp.float32), d))(dyn)

    p_j, failed_j = run_j(tuple(jnp.asarray(x) for x in tmpl_pyr),
                          tuple(jnp.asarray(x) for x in key_pyr),
                          _dyn_j(combos))
    tspecs = aligner.level_specs(W, H, tp)
    tkey = ha._compute_keyframe_h([_t(x)[None] for x in key_pyr], tspecs)
    zeros = torch.zeros(len(combos), dtype=torch.int64)
    p_t, failed_t = ha.align_all_levels_h(
        [_t(x)[None] for x in tmpl_pyr], zeros, tkey, zeros, tspecs, tp,
        torch.zeros(len(combos), 8), _dyn_t(combos))
    np.testing.assert_array_equal(failed_t.numpy(), np.asarray(failed_j))
    assert not failed_t[:3].any() and bool(failed_t[3])
    corners = torch.tensor([[0.0, 0.0], [W - 1.0, 0.0], [0.0, H - 1.0],
                            [W - 1.0, H - 1.0]])
    err = (TH.warp_points(p_t[:, None], corners, W, H)
           - TH.warp_points(_t(np.asarray(p_j))[:, None], corners, W, H))
    assert float(err.norm(dim=-1)[:3].max()) < 0.1


def test_smoother_sweep_matches_jax_per_combo():
    """The smoother sweep's batch: a per-combo lambda in
    ``smooth_trajectory`` and a per-combo (min_disp, max_disp, min_decay,
    max_decay) in ``accumulate_corrections``, against the JAX package's
    functions run once per combo with those values in its params. Float32
    and the same expressions, rounded in other places by the two
    compilers: smoothed within 1e-5; the corrections, which fold 24
    compositions, A/B within 1e-6 and TX/TY within 5e-5 px (a few float32
    steps at 10 px). Measured: smoothed 9.5e-7, A/B 3.4e-7, TX/TY 1.1e-5
    px."""
    rng = np.random.default_rng(9)
    t_n = 30
    meas = rng.normal(0, [2e-3, 2e-3, 6.0, 6.0], (t_n, 4)).astype(np.float32)
    ok = rng.uniform(size=t_n) > 0.1
    lams = np.asarray([1.0, 2.0, 4.0, 8.0], np.float32)
    decays = np.asarray([(48.0, 64.0, 0.9, 0.7), (32.0, 48.0, 0.95, 0.8),
                         (64.0, 96.0, 0.85, 0.6), (4.0, 8.0, 0.9, 0.5)],
                        np.float32)
    tp = tcfg.StabilizerParams(lag=6, smoother_memory=3)
    c_n = len(lams)
    meas_c = _t(meas).expand(c_n, t_n, 4)
    sm = batch.smooth_trajectory(meas_c, tp, lam=_t(lams))
    acc = batch.accumulate_corrections(meas_c, _t(ok).expand(c_n, t_n), sm,
                                       tp, W, H, decay=_t(decays))
    for c in range(c_n):
        jp = jcfg.StabilizerParams(
            lag=6, smoother_memory=3, lambda_=float(lams[c]),
            min_disp=float(decays[c, 0]), max_disp=float(decays[c, 1]),
            min_decay=float(decays[c, 2]), max_decay=float(decays[c, 3]))
        sm_j = jax.jit(jbatch.smooth_trajectory,
                       static_argnums=1)(jnp.asarray(meas), jp)
        acc_j = jbatch.accumulate_corrections(jnp.asarray(meas),
                                              jnp.asarray(ok), sm_j, jp, W, H)
        gap = np.abs(acc[c].numpy() - np.asarray(acc_j))
        np.testing.assert_allclose(sm[c].numpy(), np.asarray(sm_j),
                                   rtol=0, atol=1e-5)
        assert gap[:, :2].max() <= 1e-6 and gap[:, 2:].max() <= 5e-5
    # One combo's values given as the params' own equal the params' run.
    sp = dataclasses.replace(tp, lambda_=float(lams[1]))
    assert torch.equal(batch.smooth_trajectory(meas_c[1], sp), sm[1])
