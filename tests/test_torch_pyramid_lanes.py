"""Kernel H's two engines (``csrc/pyr_down.cu``) emulated lane by lane in
numpy: the words each lane loads (clamped to the row, and for the wide
engine the neighbouring lanes' bytes taken by shuffle, lanes 0 and 31
loading their own, lanes past the row's end holding its last byte), the
even and odd bytes split into 16-bit lanes with the kernel's byte
permutes, the 5-tap sums on both lanes at once, and the high byte of each
lane packed as the output. Each engine, level after level, is held bit
for bit to the JAX package's ``build_pyramid`` and to the plain version.
The kernel itself runs only on the card (``chip_smoke.py`` phase G)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilizer_tpu.ops.pyr_down import build_pyramid as j_pyramid
from video_stabilizer_tpu_torch.ops.pyr_down import pyr_down_plain

torch.set_num_threads(1)

LANES = np.uint32(0x00FF00FF)


def byte_perm(x, y, s):
    """CUDA's __byte_perm: byte i of the result is byte (s >> 4i) & 7 of
    the 8 bytes y:x."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(np.broadcast(x, y).shape, np.uint32)
    for i in range(4):
        sel = np.uint64(8 * ((s >> (4 * i)) & 7))
        byte = ((both >> sel) & np.uint64(0xFF)).astype(np.uint32)
        out |= byte << np.uint32(8 * i)
    return out


def words(img, cols):
    """The words of columns cols[..., 4q .. 4q + 3] of every row of img
    (N, H, W) u8, each column clamped to the row: (N, H, *cols.shape[:-1])
    uint32 per q, as a list."""
    w = img.shape[-1]
    b = img[..., np.clip(cols, 0, w - 1)].astype(np.uint32)
    return [b[..., 4 * q] | b[..., 4 * q + 1] << 8 | b[..., 4 * q + 2] << 16
            | b[..., 4 * q + 3] << 24 for q in range(cols.shape[-1] // 4)]


def pack(a, b):
    """Each lane's high byte, 4 outputs a word (byte_perm 0x7531)."""
    return byte_perm(a, b, 0x7531)


def unpack(word_list, w2):
    """Output words of consecutive lanes (..., lanes) -> (..., w2) bytes."""
    stacked = np.stack(word_list, -1)
    shifts = np.arange(4, dtype=np.uint32) * np.uint32(8)
    by = ((stacked[..., None] >> shifts) & np.uint32(0xFF)).astype(np.uint8)
    return by.reshape(*by.shape[:-3], -1)[..., :w2]


def column_rows(h, h2):
    """Source row 2y - 2 + i of output row y, clamped: (h2, 5)."""
    return np.clip(2 * np.arange(h2)[:, None] - 2 + np.arange(5), 0, h - 1)


def narrow(img):
    """The narrow engine: a lane makes outputs x .. x + 3 from the words
    of columns 2x - 4 .. 2x + 11 (row_sums4, emit4)."""
    n, h, w = img.shape
    h2, w2 = h // 2, w // 2
    x = 4 * np.arange(-(-w2 // 4))
    w0, w1, w2_, w3 = words(img, 2 * x[:, None] - 4 + np.arange(16))
    e12, o12 = w1 & LANES, (w1 >> 8) & LANES
    e34, o34 = w2_ & LANES, (w2_ >> 8) & LANES
    e01, o01 = byte_perm(w0, e12, 0x5452), byte_perm(w0, o12, 0x5453)
    e23, o23 = byte_perm(e12, e34, 0x5432), byte_perm(o12, o34, 0x5432)
    e45 = byte_perm(e34, w3, 0x1432)
    rx = e01 + e23 + 4 * (o01 + o12) + 6 * e12
    ry = e23 + e45 + 4 * (o23 + o34) + 6 * e34
    rows = column_rows(h, h2)
    taps = [1, 4, 6, 4, 1]
    a = sum(np.uint32(c) * rx[:, rows[:, i]] for i, c in enumerate(taps))
    b = sum(np.uint32(c) * ry[:, rows[:, i]] for i, c in enumerate(taps))
    return unpack([pack(a, b)], w2)


def wide(img):
    """The wide engine: lane l of the warp at X0 makes outputs x = X0 + 8l
    .. x + 7 from its 16 bytes (columns 2x .. 2x + 15), the left lane's
    bytes 2x - 2 and 2x - 1 and the right lane's byte 2x + 16 (lanes 0 and
    31 load their own); a lane past the row's end holds its last byte
    (load_window, window_sums, row_sums8, emit8)."""
    n, h, w = img.shape
    h2, w2 = h // 2, w // 2
    warps = -(-w2 // 256)
    x = (256 * np.arange(warps)[:, None] + 8 * np.arange(32)).reshape(-1)
    v = words(img, 2 * x[:, None] + np.arange(16))
    past = x >= w2
    last = img[..., w - 1].astype(np.uint32)[..., None] * np.uint32(
        0x01010101)
    v = [np.where(past, last, q) for q in v]
    lane = np.arange(x.size) % 32
    left = np.roll(v[3], 1, axis=-1)
    right = np.roll(v[0], -1, axis=-1)
    own_left = (words(img, 2 * x[:, None] - 4 + np.arange(4))[0]
                & np.uint32(0xFFFF0000))
    own_right = words(img, 2 * x[:, None] + 16 + np.arange(4))[0] & np.uint32(
        0xFF)
    left = np.where(lane == 0, own_left, left)
    right = np.where(lane == 31, own_right, right)
    e = [q & LANES for q in v]
    o = [(q >> 8) & LANES for q in v]
    prev = ([byte_perm(left, e[0], 0x5452)]
            + [byte_perm(e[q - 1], e[q], 0x5432) for q in range(1, 4)]
            + [byte_perm(e[3], right, 0x3432)])
    odd = ([byte_perm(left, o[0], 0x5453)]
           + [byte_perm(o[q - 1], o[q], 0x5432) for q in range(1, 4)])
    s = [prev[q] + prev[q + 1] + 4 * (odd[q] + o[q]) + 6 * e[q]
         for q in range(4)]
    rows = column_rows(h, h2)
    # part = s0 + 4 s1 + 6 s2, then + 4 s3 + s4, as the strip carries it.
    outs = []
    for q in range(4):
        r = [s[q][:, rows[:, i]] for i in range(5)]
        part = r[0] + 4 * r[1] + 6 * r[2]
        outs.append(part + 4 * r[3] + r[4])
    return unpack([pack(outs[0], outs[1]), pack(outs[2], outs[3])], w2)


def chain(engine, img, levels):
    out = [img]
    for _ in range(levels - 1):
        out.append(engine(out[-1]))
    return out


@pytest.mark.parametrize("engine", [narrow, wide])
@pytest.mark.parametrize("shape, levels", [((2, 67, 121), 6),
                                           ((1, 135, 241), 7)])
def test_engines_match_jax(engine, shape, levels):
    """Odd sizes at every level, down to 2x3: bit-equal to JAX's
    build_pyramid, run as the other pyramid tests run it."""
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                     dtype=np.uint8)
    want = jax.jit(j_pyramid, static_argnums=1)(jnp.asarray(img), levels)
    for w, g in zip(want, chain(engine, img, levels)):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("engine", [narrow, wide])
@pytest.mark.parametrize("shape, levels", [((2, 437, 1033), 8),
                                           ((1, 48, 64), 4),
                                           ((3, 40, 1100), 3),
                                           ((1, 8, 8), 3)])
def test_engines_match_plain(engine, shape, levels):
    """The ragged chain to 3x8, the soak's frame, rows that end inside a
    warp's lanes (1100 columns: 550 outputs) and a tiny frame: bit-equal
    to the plain version level after level."""
    img = np.random.default_rng(sum(shape) + levels).integers(
        0, 256, shape, dtype=np.uint8)
    want = img
    for level, got in enumerate(chain(engine, img, levels)[1:], 1):
        want = pyr_down_plain(torch.from_numpy(want)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"level {level}")


@pytest.mark.parametrize("engine", [narrow, wide])
def test_engines_no_lane_carries(engine):
    """All 255: the largest row and column sums (4,080 and 65,280) stay in
    their 16-bit lanes, so every output is 255."""
    img = np.full((1, 20, 600), 255, np.uint8)
    assert (engine(img) == 255).all()
