"""Kernel J (select's warp-diff prelude, ``ops/prelude.py``) around its
plain version: the plain version against the JAX package's own steps
(aligner.py:316-345, homography_aligner.py:130-149) at two levels of a
96x128 pyramid, two keyframes and a flat and an overflowing one, four
items, both models, the keep fraction as a float and per item; the
dispatch by device; the wrapper's refusals; and a numpy model of
``csrc/prelude.cu``'s design (the CTA slices of a cluster, the histogram
merge in rank order, the threshold scan, the fixed-order Hessian sum; the
exact-count mode's radix rounds over the float bits and its rank-ordered
tie cut) against the plain version. The kernel runs only on the card
(``chip_smoke.py`` phase SEL), where it is held to the plain version."""

import functools
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilizer_tpu import transforms as JT
from video_stabilizer_tpu.config import AlignerParams as JAlignerParams
from video_stabilizer_tpu.models import aligner as jaligner
from video_stabilizer_tpu.models import homography_aligner as jha
from video_stabilizer_tpu.ops.argmax import take_at_tile_argmax
from video_stabilizer_tpu.ops.patches import (
    sample_windows_flat, warp_rel_positions_flat, window_origins_flat)
from video_stabilizer_tpu.ops.select import histogram_mask
from video_stabilizer_tpu.ops.select import topk_mask as jtopk_mask
from video_stabilizer_tpu_torch.config import AlignerParams
from video_stabilizer_tpu_torch.models import aligner
from video_stabilizer_tpu_torch.ops import cuda_build, prelude
from video_stabilizer_tpu_torch.ops import gn8_solve, patches
from video_stabilizer_tpu_torch.ops import select as tselect
from video_stabilizer_tpu_torch.ops.keyframe import (
    LevelKeyData, keyframe_level_plain)
from video_stabilizer_tpu_torch.ops.pyr_down import build_pyramid
from video_stabilizer_tpu_torch import transforms as T
from conftest import natural_image

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "video_stabilizer_tpu_torch"

H, W = 96, 128
PARAMS = AlignerParams()
JPARAMS = JAlignerParams()
SPECS = aligner.level_specs(W, H, PARAMS)
J_SPECS = jaligner.level_specs(W, H, JPARAMS)
MODELS = ("similarity", "homography")
# Two of the pyramid's three levels: the finest (margin 6, N = 3072) and
# the coarsest (margin 12, N = 192). Each level costs the JAX package's
# eager operations a compile of their own.
LEVELS = (0, 2)
# Items: (key, template frame). Key 2 has all-zero windows and item 1 a
# flat template of 7 there: every warp diff of its rows is 7 (ties in
# one bin). Key 3's windows put 255 under each positive Lanczos2 tap
# weight and 0 under each negative one at item 2's positions, whose
# template is 0: diffs of 256 and more (the overflow bin).
KEY_INDEX = np.array([0, 2, 3, 1])
TEMPLATE_INDEX = np.array([1, 2, 3, 0])
FRACTIONS = np.array([0.8, 0.5, 0.3, 1.0], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _transforms(model):
    """Item 2's transform moves its keypoints by half a pixel each way
    (a tap pattern of fixed signs); the others are small random motions."""
    rng = np.random.default_rng(40)
    if model == "similarity":
        t = rng.normal(0, [1e-3, 1e-3, 0.8, 0.8], (4, 4))
        t[2] = (0.0, 0.0, 0.5, 0.5)
    else:
        t = rng.normal(0, [1e-3, 1e-3, 6e-3, 1e-3, 1e-3, 6e-3, 1e-3, 1e-3],
                       (4, 8))
        t[2] = (0.0, 0.0, 0.5 / W, 0.0, 0.0, 0.5 / W, 0.0, 0.0)
    return t.astype(np.float32)


def _lobe_windows(key, spec, model, transform):
    """(N, P, P) u8 windows with 255 under the taps of positive 2-D weight
    and 0 under the others, at ``transform``'s positions of key 0 of
    ``key``, both sets (the Y set's pattern where they overlap)."""
    p = key.windows.shape[-1]
    ox, oy = patches.window_origins_flat(spec.ht, spec.wt, spec.tile,
                                         spec.margin)
    if model == "similarity":
        t_ul = T.center_to_ul(_t(transform)[None], spec.width,
                              spec.height)[:, None, None, :]
        rx, ry = patches.warp_rel_positions_flat(
            key.coords[:1, 0], key.coords[:1, 1], t_ul, ox, oy, p)
    else:
        u, v = gn8_solve.normalized_keypoints(key, spec)
        rx, ry = gn8_solve.warp_rel_positions_h(
            _t(transform)[None, None, None, :], u[:1], v[:1], spec.width,
            spec.height, ox, oy, p)
    win = np.zeros((spec.ht * spec.wt, p, p), np.uint8)
    sign = np.array([-1, 1, 1, -1])
    for s in range(2):
        x0 = np.floor(rx[0, s].numpy()).astype(int) - 1
        y0 = np.floor(ry[0, s].numpy()).astype(int) - 1
        for a in range(4):
            for b in range(4):
                n = np.arange(win.shape[0])
                win[n, y0 + a, x0 + b] = 255 if sign[a] * sign[b] > 0 else 0
    return _t(win)


@pytest.fixture(scope="module")
def levels():
    """Per level and model: the keyframe set (two keyframes of natural
    images, the zero and the lobe windows), the template frames and the
    items' transforms."""
    imgs = np.stack([natural_image(H, W, seed=s) for s in (31, 32, 33, 34)])
    pyr = build_pyramid(_t(imgs), len(SPECS))
    out = {}
    for lvl in LEVELS:
        spec = SPECS[lvl]
        tmpl = pyr[lvl].clone()
        tmpl[2] = 7
        tmpl[3] = 0
        for model in MODELS:
            base = keyframe_level_plain(pyr[lvl][:2].contiguous(), spec,
                                        model)
            transform = _transforms(model)
            flat = LevelKeyData(*(f[:1] for f in base))
            lobes = _lobe_windows(flat, spec, model, transform[2])
            key = LevelKeyData(
                *(torch.cat([f, f[:1], f[:1]]) for f in base[:4]),
                torch.cat([base.windows, torch.zeros_like(base.windows[:1]),
                           lobes[None]]))
            out[lvl, model] = (key, tmpl, transform)
    return out


@functools.lru_cache(maxsize=None)
def _jax_fns(lvl, model):
    """The JAX package's steps of one level: the template read and the
    window origins (integers) jitted and mapped over the items; the
    positions eager, item by item (under jit XLA on the CPU contracts
    ``(1 + a) * fx - b * fy + tx`` into FMAs, and a last-bit move of a
    position moves a bf16-rounded tap weight, and so the sample, by up to
    half an intensity); the selection and the Hessian jitted and
    mapped."""
    spec_j = J_SPECS[lvl]
    n = spec_j.ht * spec_j.wt
    p = spec_j.tile + 2 * spec_j.margin

    def read(frame, idx):
        tm = take_at_tile_argmax(frame, idx, spec_j.tile).reshape(2, n)
        return tm.astype(jnp.float32)

    origins = jax.jit(lambda: window_origins_flat(
        spec_j.ht, spec_j.wt, spec_j.tile, spec_j.margin))

    def positions(coords, t):
        ox, oy = origins()
        if model == "similarity":
            t_ul0 = JT.center_to_ul(t, spec_j.width, spec_j.height,
                                    minus_one=False)
            return warp_rel_positions_flat(coords[0], coords[1], t_ul0, ox,
                                           oy, p)
        return jha._warp_rel_h(t, coords[0], coords[1], spec_j, ox, oy, p)

    def select(wd, jac, f):
        mask = jnp.stack([histogram_mask(wd[0], f),
                          histogram_mask(wd[1], f)]).astype(jnp.float32)
        jm = jac * mask
        hess = jnp.sum(jm[:, None] * jac[None, :], axis=(2, 3))
        jac_masked = jac * (mask * 0.5) if model == "similarity" else jm
        return mask, jac_masked, hess

    return jax.jit(jax.vmap(read)), positions, jax.jit(jax.vmap(select))


def _jax_reads(lvl, key, tmpl, transform, model):
    """The JAX package's steps of one level up to the warp diffs, which do
    not depend on the keep fraction: the template read, the warped
    positions and the sample (eager too, item by item: under jit XLA on
    the CPU keeps the bf16 products in float32, tests/test_torch_ops.py).
    Returns jax (tmpl, wd)."""
    read, positions, _ = _jax_fns(lvl, model)
    kidx = KEY_INDEX
    idx = jnp.stack([jnp.asarray(key.idx_x.numpy()[kidx]),
                     jnp.asarray(key.idx_y.numpy()[kidx])], axis=1)
    tm = read(jnp.asarray(tmpl.numpy()[TEMPLATE_INDEX]), idx)
    coords = key.coords.numpy()[kidx]
    windows = np.moveaxis(key.windows.numpy()[kidx], 1, -1)   # (B, P, P, N)
    wd = []
    for i in range(len(kidx)):
        rx, ry = positions(jnp.asarray(coords[i]), jnp.asarray(transform[i]))
        sample = sample_windows_flat(jnp.asarray(windows[i]), rx, ry)
        wd.append(jnp.abs(sample - tm[i]))
    return tm, jnp.stack(wd)


@pytest.fixture(scope="module")
def jax_reads(levels):
    """``_jax_reads`` per level and model, once for every keep fraction."""
    return {(lvl, model): _jax_reads(lvl, key, tmpl, transform, model)
            for (lvl, model), (key, tmpl, transform) in levels.items()}


def _jax_steps(lvl, key, reads, fraction, model):
    """The JAX package's steps for each item, in its level's order: the
    template read and warp diffs of ``reads``, then the two sets'
    histogram masks and the Hessian. Returns numpy (tmpl, wd, mask,
    jac_masked, H)."""
    _, _, select = _jax_fns(lvl, model)
    tm, wd = reads
    frac = jnp.broadcast_to(jnp.asarray(fraction, jnp.float32), (4,))
    mask, jac_masked, hess = select(
        wd, jnp.asarray(key.jac.numpy()[KEY_INDEX]), frac)
    return tuple(np.asarray(x) for x in (tm, wd, mask, jac_masked, hess))


@pytest.mark.parametrize("per_item", [False, True],
                         ids=["one fraction", "per-item fraction"])
def test_plain_matches_jax_steps(levels, jax_reads, per_item):
    """Every level, both models. Bars: tmpl exact (bytes read as float);
    the masks equal; jac_masked exact (the same 0/1 and 0.5 products);
    the Hessian within 1e-5 of the JAX package's largest entry of the item
    (the two sum 2N products in other orders: torch on the CPU in double,
    XLA in float32). The fixture's edge rows hold: item 1's diffs all
    equal, item 2's partly at or above 256."""
    fraction = FRACTIONS if per_item else np.float32(PARAMS.smallest_fraction)
    for (lvl, model), (key, tmpl, transform) in levels.items():
        got = prelude.level_prelude_plain(
            SPECS[lvl], key, _t(KEY_INDEX), tmpl, _t(TEMPLATE_INDEX),
            _t(transform), PARAMS, _t(fraction) if per_item else
            float(fraction), model, return_wd=True)
        tm_j, wd_j, mask_j, jm_j, hess_j = _jax_steps(
            lvl, key, jax_reads[lvl, model], fraction, model)
        tm, jm, hess, wd = (x.numpy() for x in got)
        where = f"level {lvl} {model}"
        np.testing.assert_array_equal(tm, tm_j, err_msg=where)
        mask = prelude.selection_mask(
            got[3], PARAMS, _t(fraction) if per_item else float(fraction))
        np.testing.assert_array_equal(mask.numpy(), mask_j, err_msg=where)
        np.testing.assert_array_equal(jm, jm_j, err_msg=where)
        scale = np.abs(hess_j).max(axis=(1, 2), keepdims=True)
        assert (np.abs(hess - hess_j) <= 1e-5 * scale).all(), where
        assert (wd[1] == 7.0).all(), where
        assert (wd[2] >= 256).any(), where
        assert np.abs(wd - wd_j).max() < 1e-3, where


def test_cpu_tensors_take_the_plain_version(levels, monkeypatch):
    """On CPU tensors ``level_prelude`` is the plain version, bit for bit,
    with no build and no launch; the aligners' preludes go through it."""
    def refuse(name):
        raise AssertionError(f"cuda_build.load({name!r}) on the CPU path")
    monkeypatch.setattr(cuda_build, "load", refuse)
    before = prelude.level_prelude_kernel.launches
    for (lvl, model), (key, tmpl, transform) in levels.items():
        args = (SPECS[lvl], key, _t(KEY_INDEX), tmpl, _t(TEMPLATE_INDEX),
                _t(transform), PARAMS, _t(FRACTIONS))
        got = prelude.level_prelude(*args, model)
        want = prelude.level_prelude_plain(*args, model)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert prelude.level_prelude_kernel.launches == before


def test_topk_takes_the_plain_version_by_setting(levels, monkeypatch):
    """Off the CPU (meta tensors here) both selections go to kernel J,
    ``selection="topk"`` too, never to the plain version; CPU tensors take
    the plain version under either."""
    calls = []

    def plain(*args, **kw):
        calls.append("plain")
        return "plain"

    def kernel(*args, **kw):
        calls.append("kernel")
        return "kernel"

    monkeypatch.setattr(prelude, "level_prelude_plain", plain)
    monkeypatch.setattr(prelude, "level_prelude_kernel", kernel)
    key, tmpl, transform = levels[2, "homography"]
    meta = LevelKeyData(*(f.to("meta") for f in key))
    for params, dev_key, want in (
            (AlignerParams(selection="topk"), meta, "kernel"),
            (AlignerParams(selection="topk"), key, "plain"),
            (PARAMS, meta, "kernel"), (PARAMS, key, "plain")):
        got = prelude.level_prelude(
            SPECS[2], dev_key, _t(KEY_INDEX), tmpl, _t(TEMPLATE_INDEX),
            _t(transform), params, 0.5, "homography")
        assert got == want, (params.selection, dev_key.windows.device)
    assert calls == ["kernel", "plain", "kernel", "plain"]


def test_kernel_wrapper_refuses(levels):
    """A selection other than the histogram and the exact count, the mask
    output outside the exact-count mode, a plan of the other mode, another
    dtype, shape or layout, the CPU and meta devices: the wrapper raises
    before any build or launch, no fallback."""
    before = prelude.level_prelude_kernel.launches
    key, tmpl, transform = levels[2, "similarity"]
    spec = SPECS[2]
    kidx, tidx, tr = _t(KEY_INDEX), _t(TEMPLATE_INDEX), _t(transform)

    def call(key=key, tmpl=tmpl, tr=tr, params=PARAMS, model="similarity"):
        return prelude.level_prelude_kernel(spec, key, kidx, tmpl, tidx, tr,
                                            params, None, model)

    topk = AlignerParams(selection="topk")
    with pytest.raises(ValueError, match="selection 'mask' or 'topk'"):
        call(params=types.SimpleNamespace(selection="nth_element",
                                          smallest_fraction=0.8))
    with pytest.raises(ValueError, match="exact-count mode only"):
        prelude.level_prelude_kernel(spec, key, kidx, tmpl, tidx, tr, PARAMS,
                                     None, "similarity", return_mask=True)
    n = spec.ht * spec.wt
    for params, plan in ((topk, prelude.launch_plan(4, n)),
                         (PARAMS, prelude.launch_plan(4, n, exact=True)),
                         (topk, prelude.launch_plan(3, n, exact=True))):
        with pytest.raises(ValueError, match="does not fit"):
            prelude.level_prelude_kernel(spec, key, kidx, tmpl, tidx, tr,
                                         params, None, "similarity",
                                         plan=plan)
    with pytest.raises(ValueError, match="jac wants"):
        call(model="homography")
    with pytest.raises(ValueError, match="coords wants"):
        call(key=key._replace(coords=key.coords.double()))
    with pytest.raises(ValueError, match="transform wants"):
        call(tr=tr[:, :3])
    with pytest.raises(ValueError, match="templates wants"):
        call(tmpl=tmpl[0])
    with pytest.raises(ValueError, match="contiguous rows"):
        call(tmpl=tmpl.repeat_interleave(2, dim=2)[:, :, ::2])
    with pytest.raises(ValueError, match="contiguous keyframe"):
        call(key=key._replace(jac=key.jac.transpose(0, 1).contiguous()
                              .transpose(0, 1)))
    with pytest.raises(ValueError, match="unknown motion model"):
        call(model="affine")
    for params in (PARAMS, topk):
        with pytest.raises(ValueError, match="kernel J runs on cuda"):
            call(params=params)
        with pytest.raises(ValueError, match="kernel J runs on cuda"):
            call(key=LevelKeyData(*(f.to("meta") for f in key)),
                 tmpl=tmpl.to("meta"), tr=tr.to("meta"), params=params)
    assert prelude.level_prelude_kernel.launches == before


def test_source_listed_and_scanned():
    """The build names the source, and the package glob that
    tests/test_torch_ops.py's import scan reads finds the module."""
    assert "prelude" in cuda_build.SOURCES
    assert (cuda_build.CSRC_DIR / "prelude.cu").exists()
    assert PKG / "ops" / "prelude.py" in set(PKG.rglob("*.py"))


# --------------------------------------------------------------------------
# A numpy model of csrc/prelude.cu's design
# --------------------------------------------------------------------------

THREADS, BINS, PER_LANE = prelude.THREADS, tselect.DEFAULT_BINS, 9
RADIX = 256


def _threshold_scan(counts, k):
    """The kernel's scan of one set's merged counts: lane l holds bins
    [9 l, 9 l + 9), an exclusive prefix of the lane totals, the first bin
    whose running count reaches k, the lowest lane with one; else 257.
    Returns (that bin, the count in the bins below it)."""
    own = np.zeros((32, PER_LANE), np.int64)
    flat = own.reshape(-1)
    flat[:BINS] = counts
    excl = np.concatenate([[0], np.cumsum(own.sum(axis=1))[:-1]])
    for lane in range(32):
        run = excl[lane] + np.cumsum(own[lane])
        for j in range(PER_LANE):
            b = lane * PER_LANE + j
            if b < BINS and np.float32(run[j]) >= k:
                return b, int(run[j] - own[lane, j])
    return BINS, int(flat.sum())


def _bin_histograms(bins, plan):
    """Pass 1's histograms of each CTA's slice of both sets, merged in rank
    order."""
    merged = np.zeros((2, BINS), np.int64)
    for lo, hi in plan.slices():
        merged += np.stack([np.bincount(bins[s, lo:hi], minlength=BINS)
                            for s in range(2)])
    return merged


def exact_mask_model(wd, k, cluster):
    """The exact-count mode's selection for one item's wd (2, N): the bin
    holding the k-th value from the merged histograms' scan; radix rounds
    of 8 bits over the candidates' float32 bits (a candidate's bits within
    its set's range), from the highest byte in which either set's range
    differs, each CTA's digit histograms merged in rank order and scanned
    for the digit that reaches the count still needed; then each CTA keeps
    its entries below the k-th value v and, of those equal to v, the first
    (still needed - the lower ranks' equal count, from the last round's
    histograms) in keypoint order. Returns mask (2, N)."""
    n = wd.shape[1]
    plan = prelude.launch_plan(1, n, cluster, exact=True)
    bits = np.ascontiguousarray(wd, np.float32).view(np.uint32).astype(
        np.int64)
    bins = np.minimum(np.floor(wd), BINS - 1).astype(np.int64)
    merged = _bin_histograms(bins, plan)
    lo_b, hi_b, need = [], [], []
    for s in range(2):
        t, below = _threshold_scan(merged[s], k)
        lo_b.append(int(np.float32(t).view(np.uint32)))
        hi_b.append(0xFFFFFFFF if t == BINS - 1 else
                    int(np.float32(t + 1).view(np.uint32)) - 1)
        need.append(k - below)
    r0 = min(32 - (a ^ b).bit_length() for a, b in zip(lo_b, hi_b)) // 8
    for r in range(r0, 4):
        sh = 24 - 8 * r
        hists = []
        for lo, hi in plan.slices():
            h = np.zeros((2, RADIX), np.int64)
            for s in range(2):
                x = bits[s, lo:hi]
                x = x[(x >= lo_b[s]) & (x <= hi_b[s])]
                h[s] = np.bincount((x >> sh) & (RADIX - 1), minlength=RADIX)
            hists.append(h)
        total = np.zeros((2, RADIX), np.int64)
        for h in hists:
            total += h
        digit = []
        for s in range(2):
            cum = np.cumsum(total[s])
            d = int(np.argmax(cum >= need[s]))
            at = (lo_b[s] >> (sh + 8) << (sh + 8)) | (d << sh)
            lo_b[s] = max(lo_b[s], at)
            hi_b[s] = min(hi_b[s], at | ((1 << sh) - 1))
            need[s] -= int(cum[d] - total[s, d])
            digit.append(d)
    mask = np.zeros(wd.shape, np.float32)
    for rank, (lo, hi) in enumerate(plan.slices()):
        for s in range(2):
            v = lo_b[s]
            keep = need[s] - sum(h[s, digit[s]] for h in hists[:rank])
            own = hists[rank][s, digit[s]]
            x = bits[s, lo:hi]
            cut = (0 if keep <= 0 else hi - lo if keep >= own else
                   np.flatnonzero(x == v)[keep - 1] + 1)
            mask[s, lo:hi] = (x < v) | ((x == v) & (np.arange(hi - lo) < cut))
    return mask


def kernel_model(wd, jac, fraction, cluster, model, exact=False):
    """csrc/prelude.cu's steps after the sample for one item: wd (2, N),
    jac (R, 2, N) float32; the histogram mode, or with ``exact`` the
    exact-count mode (``exact_mask_model``, k from ``fraction`` as the
    wrapper forms it). Returns (mask (2, N), jac_masked, hess)."""
    n = wd.shape[1]
    rows = jac.shape[0]
    plan = prelude.launch_plan(1, n, cluster, exact=exact)
    if exact:
        mask = exact_mask_model(
            wd, min(tselect.topk_count(n, fraction), n), cluster)
    else:
        bins = np.minimum(np.floor(wd), BINS - 1).astype(np.int64)
        # Pass 1's histograms, merged in rank order, then one scan a set.
        merged = _bin_histograms(bins, plan)
        k = np.floor(np.float32(n) * np.float32(fraction))
        thresh = [_threshold_scan(merged[s], k)[0] for s in range(2)]
        mask = (bins <= np.array(thresh)[:, None]).astype(np.float32)
    scale = np.float32(0.5) if model == "similarity" else np.float32(1.0)
    jac_masked = (jac * (mask * scale)[None]).astype(np.float32)
    # Pass 2: entry e of a CTA is set e >= cnt, keypoint lo + e % cnt; a
    # round stages THREADS entries, and thread (group g, entry q) adds the
    # float32 product q of the round's entries g, g + GROUPS, ... in
    # order to its float64 sum; the CTA sums its groups in order.
    pairs = [(a, b) for a in range(rows) for b in range(a, rows)]
    pa, pb = (np.array(x) for x in zip(*pairs))
    groups = THREADS // len(pairs)
    ctas = []
    for lo, hi in plan.slices():
        cnt = hi - lo
        acc = np.zeros((groups, len(pairs)), np.float64)
        for e0 in range(0, 2 * cnt, THREADS):
            e = np.arange(e0, min(e0 + THREADS, 2 * cnt))
            s = (e >= cnt).astype(int)
            nn = lo + np.where(s == 1, e - cnt, e)
            jv = jac[:, s, nn]                                   # (R, E)
            term = ((jv * mask[s, nn])[pa] * jv[pb]).T           # (E, NH)
            for i0 in range(0, len(e), groups):
                part = term[i0:i0 + groups].astype(np.float64)
                acc[:len(part)] = acc[:len(part)] + part
        cta = np.zeros(len(pairs), np.float64)
        for g in range(groups):
            cta = cta + acc[g]
        ctas.append(cta)
    total = np.zeros(len(pairs), np.float64)
    for c in ctas:
        total = total + c
    total = total.astype(np.float32)
    hess = np.zeros((rows, rows), np.float32)
    for q, (a, b) in enumerate(pairs):
        hess[a, b] = hess[b, a] = total[q]
    return mask, jac_masked, hess


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("model", MODELS)
def test_kernel_design_model_matches_plain(levels, cluster, model):
    """The numpy model of the kernel's slicing, merge, scan and Hessian
    order on the plain version's own warp diffs, at level 0 (N = 3072:
    slices of 3072, 1536, 768 and 384) and on a ragged row of N = 1037
    with ties and overflow: mask and jac_masked bit-equal to the plain
    version's, the Hessian within 1e-5 of its largest entry (the plain
    version sums in another order), symmetric, and the same bits at every
    cluster size (float64 sums of the float32 products, rounded once)."""
    key, tmpl, transform = levels[0, model]
    got = prelude.level_prelude_plain(
        SPECS[0], key, _t(KEY_INDEX), tmpl, _t(TEMPLATE_INDEX),
        _t(transform), PARAMS, _t(FRACTIONS), model, return_wd=True)
    jac = key.jac[_t(KEY_INDEX)].numpy()
    rng = np.random.default_rng(cluster)
    rows = jac.shape[1]
    ragged_wd = np.floor(rng.uniform(0, 300, (2, 1037))).astype(np.float32)
    ragged_wd[:, ::5] += rng.uniform(0, 1, (2, 208)).astype(np.float32)
    ragged_jac = rng.normal(0, 3, (rows, 2, 1037)).astype(np.float32)
    cases = [(got[3].numpy()[i], jac[i], FRACTIONS[i]) for i in range(4)]
    cases.append((ragged_wd, ragged_jac, np.float32(0.37)))
    for i, (wd, jc, f) in enumerate(cases):
        mask, jm, hess = kernel_model(wd, jc, f, cluster, model)
        want_mask = tselect.histogram_mask(_t(wd), float(f)).numpy()
        np.testing.assert_array_equal(mask, want_mask, err_msg=str(i))
        scale = 0.5 if model == "similarity" else 1.0
        want_jm = (_t(jc) * (_t(want_mask) * scale)[None]).numpy()
        np.testing.assert_array_equal(jm.view(np.int32),
                                      want_jm.view(np.int32), err_msg=str(i))
        if i < 4:
            np.testing.assert_array_equal(jm, got[1].numpy()[i])
            want_h = got[2].numpy()[i]
        else:
            jmask = _t(jc) * _t(want_mask)[None]
            want_h = (jmask[:, None] * _t(jc)[None]).sum(dim=(2, 3)).numpy()
        bound = 1e-5 * np.abs(want_h).max()
        assert np.abs(hess - want_h).max() <= bound, (i, cluster)
        assert np.array_equal(hess, hess.T)
        one_cta = kernel_model(wd, jc, f, 1, model)[2]
        assert np.array_equal(hess.view(np.int32), one_cta.view(np.int32))


def _tie_rows(n=1037):
    """Two ragged rows of warp diffs with long runs of equal values, zeros
    and values in the overflow bin (256 and above); the default count cuts
    row 0 inside a run of 200.25 and row 1 inside a run of 300.0 (the
    overflow bin), and both rows have runs that straddle CTA slices."""
    rng = np.random.default_rng(23)
    rows = []
    for parts in ([np.zeros(200), np.full(150, 3.0),
                   rng.uniform(0, 256, 200), np.full(400, 200.25),
                   rng.uniform(256, 1e4, 86), [256.0]],
                  [np.zeros(100), rng.uniform(0, 256, 300),
                   np.full(500, 300.0), np.full(136, 512.75),
                   [np.float32(256) - np.float32(2 ** -15)]]):
        row = np.concatenate(parts).astype(np.float32)
        assert row.size == n
        rows.append(row[rng.permutation(n)])
    return np.stack(rows)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("model", MODELS)
def test_kernel_design_model_exact_matches_topk(levels, cluster, model):
    """The numpy model of the exact-count mode (its bucket from the merged
    histograms, the radix rounds over the float bits in rank order, the
    rank-ordered tie cut) against ``topk_mask`` bit for bit: on the plain
    ``topk`` prelude's own warp diffs at level 0 (N = 3072: item 1 all 7s,
    item 2 partly in the overflow bin), and on two ragged rows of N = 1037
    (``_tie_rows``) at the default count, k = 1 (fraction 0), k = N
    (fraction 1) and k > N (fraction 1.5); every row keeps exactly
    min(k, N); jac_masked = jac x mask (x 0.5, similarity) bit for bit, and
    the plain prelude's at level 0; the Hessian within 1e-5 of the largest
    entry of a float32 sum and the same bits at every cluster size. One
    ragged row also against the JAX package's own ``topk_mask``."""
    key, tmpl, transform = levels[0, model]
    topk = AlignerParams(selection="topk")
    got = prelude.level_prelude_plain(
        SPECS[0], key, _t(KEY_INDEX), tmpl, _t(TEMPLATE_INDEX),
        _t(transform), topk, _t(FRACTIONS), model, return_wd=True)
    jac = key.jac[_t(KEY_INDEX)].numpy()
    rows = jac.shape[1]
    ties = _tie_rows()
    ties_jac = np.random.default_rng(cluster).normal(
        0, 3, (rows, 2, ties.shape[1])).astype(np.float32)
    f0 = topk.smallest_fraction
    k0 = tselect.topk_count(ties.shape[1], f0)
    ordered = np.sort(ties, axis=1)
    assert (ordered[:, k0 - 1] == ordered[:, k0]).all()
    assert (ordered[:, k0 - 1] == [200.25, 300.0]).all()
    cases = [(got[3].numpy()[i], jac[i], f0) for i in range(4)]
    cases += [(ties, ties_jac, f) for f in (f0, 0.0, 1.0, 1.5)]
    scale = 0.5 if model == "similarity" else 1.0
    for i, (wd, jc, f) in enumerate(cases):
        where = f"case {i}, fraction {f}, cluster {cluster}"
        mask, jm, hess = kernel_model(wd, jc, f, cluster, model, exact=True)
        want = tselect.topk_mask(_t(wd), f).numpy()
        np.testing.assert_array_equal(mask, want, err_msg=where)
        n = wd.shape[1]
        assert (mask.sum(axis=1) == min(tselect.topk_count(n, f), n)).all()
        want_jm = (_t(jc) * (_t(want) * scale)[None]).numpy()
        np.testing.assert_array_equal(jm.view(np.int32),
                                      want_jm.view(np.int32), err_msg=where)
        if i < 4:
            np.testing.assert_array_equal(jm, got[1].numpy()[i],
                                          err_msg=where)
            want_h = got[2].numpy()[i]
        else:
            jmask = _t(jc) * _t(want)[None]
            want_h = (jmask[:, None] * _t(jc)[None]).sum(dim=(2, 3)).numpy()
        assert np.abs(hess - want_h).max() <= 1e-5 * np.abs(want_h).max()
        one_cta = kernel_model(wd, jc, f, 1, model, exact=True)[2]
        assert np.array_equal(hess.view(np.int32), one_cta.view(np.int32))
        if i == 4:
            jax_row = np.asarray(jtopk_mask(jnp.asarray(wd[0]), f))
            np.testing.assert_array_equal(mask[0], jax_row, err_msg=where)


def test_launch_plan():
    """Clusters doubled while the level's CTAs number under TARGET_CTAS
    and each CTA keeps MIN_SLICE keypoints, at the cells' shapes (the
    1080p chunk's 128 items, the 4K chunk's 32, a streaming item, G1's
    864); slices cover [0, N) once."""
    for items, n, want in ((128, 5184, 2), (128, 480, 2), (32, 20736, 8),
                           (32, 5184, 8), (32, 1296, 8), (32, 1980, 8),
                           (32, 480, 4), (1, 5184, 8), (1, 1296, 8),
                           (864, 5184, 1), (1, 1, 1)):
        plan = prelude.launch_plan(items, n)
        assert plan.cluster == want, (items, n)
        cover = [i for lo, hi in plan.slices() for i in range(lo, hi)]
        assert cover == list(range(n))
        assert plan.smem == 4 * plan.slice
        # The exact-count mode: the same plan, but where a slice would pass
        # EXACT_MAX_SLICE (G1's 864 items of 5184: 2 CTAs an item).
        exact = prelude.launch_plan(items, n, exact=True)
        assert exact.cluster == (2 if (items, n) == (864, 5184) else want)
        assert exact.slice <= prelude.EXACT_MAX_SLICE
        assert exact.smem == 8 * exact.slice and exact.exact
    with pytest.raises(ValueError, match="cluster size"):
        prelude.launch_plan(1, 10, 3)


def test_profile_names_every_hand_kernel():
    """``apps/profile_chunk.py``'s ``HAND_KERNELS`` names every
    ``__global__`` function of ``csrc/`` once, kernel J's among them, and
    charges a per-kernel table's rows to their letters."""
    import re
    from video_stabilizer_tpu_torch.apps import profile_chunk
    symbols = [s for syms in profile_chunk.HAND_KERNELS.values()
               for s in syms]
    found = {m for path in cuda_build.CSRC_DIR.glob("*.cu")
             for m in re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                                 r"\([^)]*\)\s+)?(\w+)", path.read_text())}
    assert sorted(symbols) == sorted(found)
    assert profile_chunk.HAND_KERNELS["J"] == ("prelude_kernel",)
    totals = {"void (anonymous namespace)::prelude_kernel<4>(Level)":
              (12.0, 6), "gn_solve_kernel(...)": (5.0, 6),
              "aten::add": (1.0, 3)}
    assert profile_chunk.hand_kernel_totals(totals) == {
        "B": (5.0, 6), "J": (12.0, 6)}
