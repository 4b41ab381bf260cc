"""Kernel I (one pyramid level's keyframe precompute, ``ops/keyframe.py``)
around its plain version: the plain version, through the port's
``_compute_keyframe`` and ``_compute_keyframe_h``, against the JAX
package's jitted functions on a tie-heavy and a textured keyframe of a
ragged size; the dispatch by device; the wrapper's refusals; and a numpy
model of ``csrc/keyframe.cu``'s design (its shared-memory layout, packed
argmax keys and window piece stores) against the plain version. The
kernel runs only on the card (``chip_smoke.py`` phase I), where it is held
to the plain version bit for bit."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilizer_tpu.config import AlignerParams as JAlignerParams
from video_stabilizer_tpu.models import aligner as jaligner
from video_stabilizer_tpu.models import homography_aligner as jha
from video_stabilizer_tpu_torch.config import AlignerParams
from video_stabilizer_tpu_torch.models import aligner
from video_stabilizer_tpu_torch.models import homography_aligner as ha
from video_stabilizer_tpu_torch.ops import cuda_build, keyframe
from video_stabilizer_tpu_torch.ops.pyr_down import build_pyramid
from conftest import natural_image

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "video_stabilizer_tpu_torch"

# 135x241: tile 4 at level 0, 2 below, and every level crops a tile
# remainder on both axes (135 = 33 x 4 + 3, 241 = 60 x 4 + 1; 67 = 33 x 2
# + 1).
H, W = 135, 241
JPARAMS = JAlignerParams()
SPECS = aligner.level_specs(W, H, AlignerParams())
_J_KEYFRAME = {"similarity": jax.jit(jaligner._compute_keyframe,
                                     static_argnames=("specs", "params")),
               "homography": jax.jit(jha._compute_keyframe_h,
                                     static_argnames=("specs", "params"))}
_PORT_KEYFRAME = {"similarity": aligner._compute_keyframe,
                  "homography": ha._compute_keyframe_h}


def _tie_heavy(h, w):
    """Flat left third, 1 px stripes in the middle, a checkerboard on the
    right: every tile ties, in rows, columns or both."""
    y, x = np.mgrid[:h, :w]
    img = np.full((h, w), 128, np.int32)
    mid = (x >= w // 3) & (x < 2 * w // 3)
    img[mid] = np.where(x[mid] % 3 == 0, 200, 60)
    right = x >= 2 * w // 3
    img[right] = ((x[right] + y[right]) % 2) * 255
    return img.astype(np.uint8)


def _pyramid(frames):
    return build_pyramid(torch.from_numpy(np.stack(frames)), len(SPECS))


@pytest.mark.parametrize("model", ["similarity", "homography"])
def test_plain_matches_jax(model):
    """Two keyframes (tie-heavy, textured) in one port call against two
    JAX calls: idx, coords and windows bit-equal; the similarity's Jacobian
    bit-equal, the homography's within 1e-6 of its largest entry
    (test_torch_homography.py's bar: the CPU divides by the width where
    XLA may multiply by its reciprocal)."""
    levels = _pyramid([_tie_heavy(H, W), natural_image(H, W, seed=17)])
    jspecs = jaligner.level_specs(W, H, JPARAMS)
    got = _PORT_KEYFRAME[model](levels, SPECS)
    for k in range(2):
        want = _J_KEYFRAME[model](
            tuple(jnp.asarray(lv[k].numpy()) for lv in levels), jspecs,
            JPARAMS)
        for g, w in zip(got, want):
            for name in ("idx_x", "idx_y", "coords", "windows"):
                np.testing.assert_array_equal(
                    getattr(g, name)[k].numpy(),
                    np.asarray(getattr(w, name)).astype(
                        getattr(g, name).numpy().dtype))
            jac_w = np.asarray(w.jac, np.float32)
            jac_g = g.jac[k].numpy()
            assert jac_g.shape == jac_w.shape
            if model == "similarity":
                np.testing.assert_array_equal(jac_g.view(np.int32),
                                              jac_w.view(np.int32))
            else:
                assert np.abs(jac_g - jac_w).max() <= \
                    1e-6 * np.abs(jac_w).max()


def test_zero_keyframe_ties_at_index_0():
    """The zero carry: every tile ties at 0, so every index is 0, the
    coordinates are the tiles' corners and the Jacobian is 0."""
    spec = SPECS[0]
    for model in ("similarity", "homography"):
        kd = keyframe.keyframe_level_plain(
            torch.zeros((2, H, W), dtype=torch.uint8), spec, model)
        assert not kd.idx_x.any() and not kd.idx_y.any()
        assert not kd.jac.any() and not kd.windows.any()
        corners = torch.arange(spec.wt, dtype=torch.float32) * spec.tile
        np.testing.assert_array_equal(
            kd.coords[0, 0, 0].reshape(spec.ht, spec.wt).numpy(),
            np.broadcast_to(corners.numpy(), (spec.ht, spec.wt)))


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """A CPU tensor never reaches the kernel: no build, no launch."""
    def refuse(name):
        raise AssertionError(f"cuda_build.load({name!r}) on the CPU path")
    monkeypatch.setattr(cuda_build, "load", refuse)
    before = keyframe.keyframe_level_kernel.launches
    img = _pyramid([natural_image(H, W, seed=3)])[1]
    for model in ("similarity", "homography"):
        got = keyframe.keyframe_level(img, SPECS[1], model)
        want = keyframe.keyframe_level_plain(img, SPECS[1], model)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert keyframe.keyframe_level_kernel.launches == before


def test_kernel_wrapper_refuses():
    """Another dtype or rank, the CPU and meta devices, an unknown model:
    the wrapper raises before any build or launch, no fallback."""
    before = keyframe.keyframe_level_kernel.launches
    spec = SPECS[2]
    img = torch.zeros((2, spec.height, spec.width), dtype=torch.uint8)
    with pytest.raises(ValueError, match="kernel I takes uint8"):
        keyframe.keyframe_level_kernel(img.float(), spec)
    with pytest.raises(ValueError, match=r"kernel I takes \(K, h, w\)"):
        keyframe.keyframe_level_kernel(img[0], spec)
    with pytest.raises(ValueError, match="kernel I runs on cuda"):
        keyframe.keyframe_level_kernel(img, spec)
    with pytest.raises(ValueError, match="kernel I runs on cuda"):
        keyframe.keyframe_level(img.to("meta"), spec, "homography")
    with pytest.raises(ValueError, match="unknown motion model"):
        keyframe.keyframe_level_kernel(img, spec, "affine")
    assert keyframe.keyframe_level_kernel.launches == before


def test_source_listed_and_scanned():
    """The build names the source, and the package glob that
    tests/test_torch_ops.py's import scan reads finds the module."""
    assert "keyframe" in cuda_build.SOURCES
    assert (cuda_build.CSRC_DIR / "keyframe.cu").exists()
    assert PKG / "ops" / "keyframe.py" in set(PKG.rglob("*.py"))


# --------------------------------------------------------------------------
# A numpy model of csrc/keyframe.cu's design
# --------------------------------------------------------------------------

MAX_SPAN, SPLIT_SPAN, SMEM_TARGET, PAD = 64, 32, 48 * 1024, 16


def _plan(wt, t, m):
    """(span, spans, jw, shared bytes) as ``vs_keyframe`` picks them: the
    band of P rows x t phase lines of jw bytes after PAD bytes, then the
    argmax's two int keys per column."""
    spans = -(-wt // SPLIT_SPAN) if wt > MAX_SPAN else 1
    while True:
        span = -(-wt // spans)
        jw = (span + (2 * m - 1) // t + 1 + 3) & ~3
        if (jw // 4) % 2 == 0:
            jw += 4
        keys_at = (PAD + (t + 2 * m) * t * jw + 24 + 15) & ~15
        smem = keys_at + 8 * t * span
        if smem <= SMEM_TARGET or span == 1:
            return span, -(-wt // span), jw, smem
        spans += 1


def _model_level(img, spec, win_base):
    """idx_x, idx_y and the flat windows (written into a buffer whose
    windows start ``win_base`` bytes past an aligned address) of one level
    as the kernel's blocks make them, block by block; within a block the
    lanes' work is vectorized."""
    keys, h, w = img.shape
    t, m, ht, wt = spec.tile, spec.margin, spec.ht, spec.wt
    p, n = t + 2 * m, spec.ht * spec.wt
    span, spans, jw, _ = _plan(wt, t, m)
    piece = 16 if t >= 8 else 4
    smax = max(2, (span + 2 * piece - 2) // piece)
    idx = np.full((2, keys, ht, wt), -1, np.int64)
    buf = np.full(win_base + keys * p * p * n + 8, 0xAB, np.uint8)
    ty, tx = np.meshgrid(np.arange(t), np.arange(t), indexing="ij")
    flat = ty * t + tx
    q_pl = np.arange(p * p)
    r_pl, c_pl = q_pl // p, q_pl % p
    for k in range(keys):
        for i in range(ht):
            for sp in range(spans):
                j0 = sp * span
                nj = min(span, wt - j0)
                # The band in the phase-split layout, with the PAD bytes
                # before it that the funnel reads may touch.
                cols = nj * t + 2 * m
                band = np.zeros(PAD + p * t * jw + 24, np.int64)
                ys = np.clip(i * t - m + np.arange(p), 0, h - 1)
                xs = np.arange(cols)
                src = img[k][ys][:, np.clip(j0 * t - m + xs, 0, w - 1)]
                off = (np.arange(p)[:, None] * t + xs % t) * jw + xs // t
                band[PAD + off] = src
                line = band[PAD:]
                # The argmax: a thread walks a column's t rows, a tile takes
                # the largest of its columns' packed keys.
                jr = np.arange(nj)[:, None, None]
                row = ((m + ty) * t * jw)[None]

                def at(dq, drow):
                    q = m + tx + dq
                    return line[row + drow + (q % t) * jw + q // t + jr]
                for axis, d in enumerate((at(1, 0) - at(-1, 0),
                                          at(0, t * jw) - at(0, -t * jw))):
                    key = (np.abs(d) << 11) | ((1023 - flat) << 1) | (d < 0)
                    best = key.reshape(nj, -1).max(axis=1)
                    idx[axis, k, i, j0:j0 + nj] = 1023 - ((best >> 1) & 1023)
                # The windows: slot (q, s) stores the s-th aligned piece run
                # q touches, its bytes from the band at PAD + run_off + lo.
                run = win_base + (k * p * p + q_pl) * n + i * wt + j0
                run_off = (r_pl * t + c_pl % t) * jw + c_pl // t
                lo = piece * np.arange(smax)[None, :] \
                    - (run & (piece - 1))[:, None]
                pos = lo[..., None] + np.arange(piece)         # (q, s, byte)
                keep = (lo[..., None] < nj) & (pos >= 0) & (pos < nj)
                dst = run[:, None, None] + pos
                srcb = PAD + run_off[:, None, None] + pos
                buf[dst[keep]] = band[srcb[keep]]
    wins = buf[win_base:win_base + keys * p * p * n].reshape(keys, p, p, n)
    assert (buf[:win_base] == 0xAB).all() and (
        buf[win_base + wins.size:] == 0xAB).all()
    return idx, wins


WIDE = aligner.LevelSpec(1300, 45, 10, 130, 4, 6)   # 5 spans, 16-byte pieces


@pytest.mark.parametrize("level, base", [(0, 1), (1, 2), (2, 3), (3, 5)])
def test_kernel_design_model_matches_plain(level, base):
    """The kernel's band layout, packed argmax keys and piece stores, run
    in numpy on tie-heavy and textured keyframes, rebuild the plain
    version's indices and windows bit for bit, at an unaligned window base:
    this file's three levels (tiles 4 and 2, 4-byte pieces) and a wide
    level in spans of 32 tiles (tile 10, 16-byte pieces)."""
    if level < len(SPECS):
        levels = _pyramid([_tie_heavy(H, W), natural_image(H, W, seed=5)])
        img, spec = levels[level], SPECS[level]
    else:
        spec = WIDE
        img = torch.from_numpy(np.stack([
            _tie_heavy(spec.height, spec.width),
            natural_image(spec.height, spec.width, seed=6)]))
    idx, wins = _model_level(img.numpy(), spec, base)
    want = keyframe.keyframe_level_plain(img, spec)
    np.testing.assert_array_equal(idx[0], want.idx_x.numpy())
    np.testing.assert_array_equal(idx[1], want.idx_y.numpy())
    np.testing.assert_array_equal(wins, want.windows.numpy())


def test_plan_spans_and_pitch():
    """A tile row of up to 64 tiles is one block, a wider one splits into
    spans of up to 32 (the chunks' level 0: 3 spans at 1080p, 6 at 4K),
    more where the band and keys would pass 48 KB (margin 22), and every
    line pitch is an odd number of words."""
    assert _plan(192, 20, 6)[:3] == (32, 6, 36)
    assert _plan(96, 20, 6)[:3] == (32, 3, 36)
    assert _plan(48, 20, 6)[:3] == (48, 1, 52)
    assert _plan(60, 2, 12)[:3] == (60, 1, 76)
    span, spans, _, smem = _plan(48, 20, 22)
    assert spans == 2 and smem <= SMEM_TARGET
    for wt, t, m in ((192, 20, 6), (51, 20, 6), (30, 2, 12), (250, 6, 22)):
        assert (_plan(wt, t, m)[2] // 4) % 2 == 1
