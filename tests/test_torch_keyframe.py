"""Kernel I (a keyframe set's precompute, ``ops/keyframe.py``) around its
plain version: the plain version, through the port's ``_compute_keyframe``
and ``_compute_keyframe_h``, against the JAX package's jitted functions on
a tie-heavy and a textured keyframe of a ragged size; the dispatch by
device; ``keyframe_levels`` from strided views into a set at an offset;
the wrapper's refusals; and a numpy model of ``csrc/keyframe.cu``'s design
(its work list over every level, shared-memory layout, argmax in 4-tile
words and window piece stores) against the plain version. The kernel runs
only on the card (``chip_smoke.py`` phase I), where it is held to the
plain version bit for bit."""

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
                want_f = np.asarray(getattr(w, name))
                if name == "windows":       # JAX (P, P, N), the port (N, P, P)
                    want_f = np.moveaxis(want_f, -1, 0)
                np.testing.assert_array_equal(
                    getattr(g, name)[k].numpy(),
                    want_f.astype(getattr(g, name).numpy().dtype))
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
    """A CPU tensor never reaches the kernel (``keyframe_level`` or
    ``keyframe_levels``): no build, no launch."""
    def refuse(name):
        raise AssertionError(f"cuda_build.load({name!r}) on the CPU path")
    monkeypatch.setattr(cuda_build, "load", refuse)
    before = keyframe.keyframe_levels_kernel.launches
    img = _pyramid([natural_image(H, W, seed=3)])[1]
    for model in ("similarity", "homography"):
        got = keyframe.keyframe_level(img, SPECS[1], model)
        want = keyframe.keyframe_level_plain(img, SPECS[1], model)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        got = keyframe.keyframe_levels([img], SPECS[1:2], model)[0]
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert keyframe.keyframe_levels_kernel.launches == before


def test_kernel_wrapper_refuses():
    """Another dtype or rank, the CPU and meta devices, an unknown model:
    the wrapper raises before any build or launch, no fallback."""
    before = keyframe.keyframe_levels_kernel.launches
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
    assert keyframe.keyframe_levels_kernel.launches == before


def test_source_listed_and_scanned():
    """The build names the source, and the package glob that
    tests/test_torch_ops.py's import scan reads finds the module."""
    assert "keyframe" in cuda_build.SOURCES
    assert (cuda_build.CSRC_DIR / "keyframe.cu").exists()
    assert PKG / "ops" / "keyframe.py" in set(PKG.rglob("*.py"))


# --------------------------------------------------------------------------
# keyframe_levels: a set of every level, strided input, output in place
# --------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["similarity", "homography"])
def test_keyframe_levels_strided_into_out(model):
    """``keyframe_levels`` on the CPU takes ``align_pairs``' every-other-
    frame views as they are and writes rows [offset, offset + K) of a set
    that holds carried rows before them and guard rows after: equal to each
    level's plain version after the carried rows (``torch.cat``), the other
    rows untouched."""
    frames = _pyramid([_tie_heavy(H, W), natural_image(H, W, seed=7),
                       natural_image(H, W, seed=8), _tie_heavy(H, W)[::-1]
                       .copy()])
    odd = [lv[1::2] for lv in frames]             # keyframe stride 2 h w
    assert not odd[0].is_contiguous()
    carried = keyframe.keyframe_levels([lv[:1] for lv in frames], SPECS,
                                       model)
    guard = 2
    out = tuple(keyframe.LevelKeyData(*(
        torch.full((1 + len(odd[0]) + guard,) + f.shape[1:], 7,
                   dtype=f.dtype) for f in c)) for c in carried)
    for o, c in zip(out, carried):
        for a, b in zip(o, c):
            a[:1].copy_(b)
    before = [[f.clone() for f in o] for o in out]
    got = keyframe.keyframe_levels(odd, SPECS, model, out=out, offset=1)
    assert got is out
    for o, c, b, lv, spec in zip(out, carried, before, odd, SPECS):
        want = keyframe.keyframe_level_plain(lv.contiguous(), spec, model)
        for f, fc, fb, fw in zip(o, c, b, want):
            assert torch.equal(f[:-guard], torch.cat([fc, fw]))
            assert torch.equal(f[-guard:], fb[-guard:])


def test_keyframe_levels_refuses():
    """Rows that are not contiguous, and an ``out`` of the wrong extent,
    dtype or length, raise before anything is written."""
    img = _pyramid([natural_image(H, W, seed=3)] * 2)
    with pytest.raises(ValueError, match="contiguous rows"):
        keyframe.keyframe_levels_kernel(
            [img[0].repeat_interleave(2, dim=2)[:, :, ::2]], [SPECS[0]])
    good = keyframe.keyframe_levels(img, SPECS)
    short = tuple(keyframe.LevelKeyData(*(f[:1] for f in kd))
                  for kd in good)
    with pytest.raises(ValueError, match="cannot take rows"):
        keyframe.keyframe_levels(img, SPECS, out=short)
    with pytest.raises(ValueError, match="cannot take rows"):
        keyframe.keyframe_levels(img, SPECS, out=good, offset=1)
    wrong = tuple(kd._replace(jac=kd.jac.double()) for kd in good)
    with pytest.raises(ValueError, match="out.jac"):
        keyframe.keyframe_levels(img, SPECS, out=wrong)
    with pytest.raises(ValueError, match="levels"):
        keyframe.keyframe_levels(img, SPECS, out=good[:1])


# --------------------------------------------------------------------------
# A numpy model of csrc/keyframe.cu's design
# --------------------------------------------------------------------------

MAX_SPAN, SPLIT_SPAN, SMEM_TARGET, PAD, SLACK = 64, 32, 44 * 1024, 16, 64


def _plan(wt, t, m):
    """(span, spans, jw, shared bytes) as ``plan_level`` picks them: PAD
    bytes, the band of P rows x t phase lines of jw bytes, SLACK, the
    argmax's two 16-bit keys per column, SLACK."""
    p = t + 2 * m
    spans = -(-wt // SPLIT_SPAN) if wt > MAX_SPAN else 1
    while True:
        span = -(-wt // spans)
        jw = (span + (2 * m - 1) // t + 1 + 3) & ~3
        if (jw // 4) % 2 == 0:
            jw += 4
        keys_at = (PAD + p * t * jw + SLACK + 15) & ~15
        smem = keys_at + 4 * t * span + SLACK
        if smem <= SMEM_TARGET or span == 1:
            return span, -(-wt // span), jw, smem
        spans += 1


def _work_list(specs, keys):
    """The launch's items in block order, as ``vs_keyframe_levels``
    numbers them: (level, keyframe, tile row, first tile, tiles), level 0's
    first."""
    items = []
    for lvl, s in enumerate(specs):
        span, spans, _, _ = _plan(s.wt, s.tile, s.margin)
        k, i, sp = np.meshgrid(np.arange(keys), np.arange(s.ht),
                               np.arange(spans), indexing="ij")
        j0 = (sp * span).ravel()
        items.append(np.stack([np.full(j0.size, lvl), k.ravel(), i.ravel(),
                               j0, np.minimum(span, s.wt - j0)], 1))
    return np.concatenate(items)


def _model_item(img, spec, item):
    """One item as a block runs it: its band in the phase-split layout
    (edge-clamped), the argmax's 16-bit column keys over 4 tiles a word,
    the tiles' largest full keys. Returns (idx_x, idx_y of the item's
    tiles, the band as a flat buffer with PAD bytes before it)."""
    _, k, i, j0, nj = (int(v) for v in item)
    h, w = img.shape[1:]
    t, m = spec.tile, spec.margin
    p = t + 2 * m
    _, _, jw, _ = _plan(spec.wt, t, m)
    cols = nj * t + 2 * m
    band = np.zeros((p, t, jw + 8), np.int64)
    ys = np.clip(i * t - m + np.arange(p), 0, h - 1)
    xs = np.arange(cols)
    src = img[k][ys][:, np.clip(j0 * t - m + xs, 0, w - 1)]
    band[:, xs % t, xs // t] = src
    line = band.reshape(p * t, jw + 8)

    # Every tile column of the words 4v .. 4v + 3 (tiles past nj read the
    # band's spare bytes and are dropped), all rows at once.
    ty = np.arange(t)[:, None, None]
    tx = np.arange(t)[None, :, None]
    jr = np.arange(4 * -(-nj // 4))[None, None, :]

    def at(y, q):
        return line[y * t + q % t, q // t + jr]
    dx = np.abs(at(m + ty, m + tx + 1) - at(m + ty, m + tx - 1))
    dy = np.abs(at(m + ty + 1, m + tx) - at(m + ty - 1, m + tx))
    idx = np.zeros((2, nj), np.int64)
    for axis, d in enumerate((dx, dy)):
        key16 = ((d << 5) | (31 - ty)).max(axis=0)          # (tx, tiles)
        full = ((key16 >> 5) << 11) | (
            (1023 - ((31 - (key16 & 31)) * t + tx[0])) << 1)
        idx[axis] = 1023 - ((full.max(axis=0)[:nj] >> 1) & 1023)
    flat = np.concatenate([np.zeros(PAD, np.int64), band[..., :jw].ravel(),
                           np.zeros(SLACK, np.int64)])
    return idx, flat


def _byte_perm(x, y, sel):
    """CUDA's ``__byte_perm``: byte i of the result is byte (sel >> 4 i) & 7
    of the 8 bytes of y:x (x's bytes 0-3, y's 4-7)."""
    both = [(x >> (8 * b)) & 0xFF for b in range(4)] + \
        [(y >> (8 * b)) & 0xFF for b in range(4)]
    return sum(both[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _model_windows(flat, spec, item, wins, win_base):
    """The item's windows, stored into the flat buffer ``wins`` whose
    windows start ``win_base`` bytes past an aligned address, as
    ``store_windows`` does: where P^2 and the run's address are multiples
    of 4, slot (q, w) reads the shared words at window bytes 4w .. 4w + 3
    of tiles 4q .. 4q + 3, transposes them with the kernel's byte permutes
    and stores one word into each tile's window; else a byte a slot."""
    _, k, i, j0, nj = (int(v) for v in item)
    t, m = spec.tile, spec.margin
    p, n = t + 2 * m, spec.ht * spec.wt
    _, _, jw, _ = _plan(spec.wt, t, m)
    pp = p * p
    run = win_base + (k * n + i * spec.wt + j0) * pp
    u = np.arange(pp)
    off = PAD + (u // p * t + u % p % t) * jw + u % p // t   # band_offset
    if pp % 4 or run % 4:
        j = np.arange(nj)[:, None]
        wins[run + j * pp + u] = flat[off + j]
        return
    q = np.arange(-(-nj // 4))[:, None]
    w = np.arange(pp // 4)[None, :]
    # v[b]: the word at tile 4q's byte 4w + b, its byte d tile 4q + d's.
    v = [sum(flat[off[4 * w + b] + 4 * q + d] << (8 * d) for d in range(4))
         for b in range(4)]
    lo01, hi01 = _byte_perm(v[0], v[1], 0x5140), _byte_perm(v[0], v[1],
                                                            0x7362)
    lo23, hi23 = _byte_perm(v[2], v[3], 0x5140), _byte_perm(v[2], v[3],
                                                            0x7362)
    out = [_byte_perm(lo01, lo23, 0x5410), _byte_perm(lo01, lo23, 0x7632),
           _byte_perm(hi01, hi23, 0x5410), _byte_perm(hi01, hi23, 0x7632)]
    for d in range(4):
        keep = np.broadcast_to(4 * q + d < nj, out[d].shape)
        for b in range(4):
            dst = run + (4 * q + d) * pp + 4 * w + b
            wins[np.broadcast_to(dst, keep.shape)[keep]] = \
                ((out[d] >> (8 * b)) & 0xFF)[keep]


def _model_level(img, spec, win_base):
    """idx_x, idx_y and the windows of one level's work list, item by
    item."""
    keys = img.shape[0]
    p, n = spec.tile + 2 * spec.margin, spec.ht * spec.wt
    idx = np.full((2, keys, spec.ht, spec.wt), -1, np.int64)
    wins = np.full(win_base + keys * p * p * n + 8, 0xAB, np.int64)
    for item in _work_list([spec], keys):
        ij, flat = _model_item(img, spec, item)
        _, k, i, j0, nj = item
        idx[:, k, i, j0:j0 + nj] = ij
        _model_windows(flat, spec, item, wins, win_base)
    body = wins[win_base:win_base + keys * p * p * n]
    assert (wins[:win_base] == 0xAB).all() and (
        wins[win_base + body.size:] == 0xAB).all()
    return idx, body.reshape(keys, n, p, p)


WIDE = aligner.LevelSpec(1300, 45, 10, 130, 4, 6)   # 5 spans, P = 22


@pytest.mark.parametrize("level, base", [(0, 4), (1, 2), (2, 0), (3, 8)])
def test_kernel_design_model_matches_plain(level, base):
    """The kernel's phase-split band, its argmax in 4-tile words (16-bit
    column keys: |d| << 5 | 31 - row, then the tiles' full keys) and its
    window stores, run in numpy on tie-heavy and textured keyframes,
    rebuild the plain version's indices and keypoint-major windows bit for
    bit: this file's three levels (tiles 4 and 2, P = 16 and 26) and a
    wide level in spans of 32 tiles (tile 10, P = 22), by word transposes
    at aligned window bases (a thread's word fixed at P = 16, stepping at
    P = 22 and 26) and a byte a slot at an unaligned one (level 1)."""
    if level < len(SPECS):
        levels = _pyramid([_tie_heavy(H, W), natural_image(H, W, seed=5)])
        img, spec = levels[level], SPECS[level]
    else:
        spec = WIDE
        img = torch.from_numpy(np.stack([
            _tie_heavy(spec.height, spec.width),
            natural_image(spec.height, spec.width, seed=6)]))
    idx, wins = _model_level(img.numpy().astype(np.int64), spec, base)
    want = keyframe.keyframe_level_plain(img, spec)
    np.testing.assert_array_equal(idx[0], want.idx_x.numpy())
    np.testing.assert_array_equal(idx[1], want.idx_y.numpy())
    np.testing.assert_array_equal(wins, want.windows.numpy())


def test_plan_spans_and_pitch():
    """A tile row of up to 64 tiles is one item unless it would pass 44 KB
    of shared memory, a wider one splits into spans of up to 32 (the
    chunks' level 0: 3 spans at 1080p, 6 at 4K); the 1080p chain's level 1
    is one item a row, every level fits SMEM_TARGET (the 5 blocks an SM
    that 48 registers allow), and every line pitch is an odd number of
    words."""
    assert _plan(192, 20, 6)[:3] == (32, 6, 36)
    assert _plan(96, 20, 6)[:3] == (32, 3, 36)
    assert _plan(48, 20, 6)[:3] == (48, 1, 52)
    assert _plan(60, 2, 12)[:3] == (60, 1, 76)
    span, spans, _, smem = _plan(48, 20, 22)
    assert spans == 2 and smem <= SMEM_TARGET
    for s in aligner.level_specs(1920, 1080, AlignerParams()):
        assert _plan(s.wt, s.tile, s.margin)[3] <= SMEM_TARGET
    for wt, t, m in ((192, 20, 6), (51, 20, 6), (30, 2, 12), (250, 6, 22)):
        assert (_plan(wt, t, m)[2] // 4) % 2 == 1


def _spec_sets():
    """The work lists of phase I's path inputs: the 1080p chunk's 64
    keyframes, the 4K chunk's 16, one 1080p frame, the ragged chain from
    437x1033 (3 keyframes) and 70,000 8x8 frames."""
    p = AlignerParams()
    return {"1080p chunk": (aligner.level_specs(1920, 1080, p), 64),
            "4K chunk": (aligner.level_specs(3840, 2160, p), 16),
            "one frame": (aligner.level_specs(1920, 1080, p), 1),
            "ragged 437x1033": (aligner.level_specs(1033, 437, p), 3),
            "70,000 8x8 frames": (aligner.level_specs(8, 8, p), 70_000)}


@pytest.mark.parametrize("name", list(_spec_sets()))
def test_work_list_covers_each_tile_once(name):
    """The one launch's work list covers each (level, keyframe, tile)
    exactly once, level 0's items first and the levels in order; the
    persistent blocks (item b, b + grid, ...) take every item once at a
    grid of 4 blocks on each of 132 SMs."""
    specs, keys = _spec_sets()[name]
    items = _work_list(specs, keys)
    assert (np.diff(items[:, 0]) >= 0).all() and items[0, 0] == 0
    for lvl, s in enumerate(specs):
        mine = items[items[:, 0] == lvl]
        cover = np.zeros((keys, s.ht, s.wt + 1), np.int64)
        starts = mine[:, 1] * s.ht * (s.wt + 1) + mine[:, 2] * (s.wt + 1)
        flat = cover.reshape(-1)
        np.add.at(flat, starts + mine[:, 3], 1)
        np.add.at(flat, starts + mine[:, 3] + mine[:, 4], -1)
        assert (np.cumsum(cover, axis=2)[..., :s.wt] == 1).all()
    grid = min(len(items), 4 * 132)
    taken = np.concatenate([np.arange(b, len(items), grid)
                            for b in range(grid)])
    assert np.array_equal(np.sort(taken), np.arange(len(items)))
