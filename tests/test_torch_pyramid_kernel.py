"""Kernels G (BGR to gray) and H (the pyramid's downsample) around their
plain versions (``ops/gray.py``, ``ops/pyr_down.py``): the plain versions
against the JAX package on inputs the other tests do not reach, the
dispatch by device, and the wrappers' refusals. The kernels run only on
the card (``chip_smoke.py`` phase G), where they are held to the plain
versions bit for bit."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilizer_tpu.models.stabilizer import bgr_to_gray as j_gray
from video_stabilizer_tpu.ops.pyr_down import build_pyramid as j_pyramid
from video_stabilizer_tpu_torch.models import stabilizer
from video_stabilizer_tpu_torch.ops import cuda_build, gray
from video_stabilizer_tpu_torch.ops.pyr_down import (
    build_pyramid, pyr_down, pyr_down_kernel, pyr_down_plain)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "video_stabilizer_tpu_torch"


def _cube():
    """All 2^24 BGR triples as one (4096, 4096, 3) u8 image."""
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(
        np.uint8).reshape(4096, 4096, 3)


def _fma(a, x, y):
    """float32 fma(a, x, y), exact: the product of two float32 values and
    the sum with a float32 value below 2^9 fit a float64 here (at most 36
    bits from 2^8 down to 2^-27), so the one rounding is the cast."""
    return (a.astype(np.float64) * x + y).astype(np.float32)


def test_gray_plain_on_every_triple():
    """The plain version is the contract's float32 expression, each product
    and sum rounded in order, bit for bit on every BGR triple. JAX on the
    CPU gives the same expression with XLA's FMA contraction (0.299 r +
    (0.114 b + 0.587 g), each add fused with its product), which moves 546
    of the 2^24 triples by one level: its result is one of the two
    float32 evaluations, and every triple it differs on is within 1."""
    cube = _cube()
    got = gray.bgr_to_gray_plain(torch.from_numpy(cube)).numpy()
    b, g, r = (cube[..., k].astype(np.float32) for k in range(3))
    kb, kg, kr = np.float32(0.114), np.float32(0.587), np.float32(0.299)
    unfused = np.rint((kb * b + kg * g) + kr * r).astype(np.uint8)
    np.testing.assert_array_equal(got, unfused)
    fused = np.rint(_fma(kr, r, _fma(kb, b, kg * g))).astype(np.uint8)
    want = np.asarray(jax.jit(j_gray)(jnp.asarray(cube)))
    assert np.array_equal(want, unfused) or np.array_equal(want, fused)
    assert np.abs(want.astype(np.int16) - got).max() <= 1


@pytest.mark.parametrize("shape, levels", [((2, 67, 121), 6),
                                           ((1, 135, 241), 7)])
def test_pyramid_plain_odd_chains(shape, levels):
    """Odd sizes at every level, down to 2x3: bit-equal to JAX."""
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                     dtype=np.uint8)
    want = jax.jit(j_pyramid, static_argnums=1)(jnp.asarray(img), levels)
    got = build_pyramid(torch.from_numpy(img), levels)
    assert tuple(got[-1].shape) == shape[:1] + (2, 3)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """CPU tensors never reach a kernel: no build, no launch."""
    def refuse(name):
        raise AssertionError(f"cuda_build.load({name!r}) on the CPU path")
    monkeypatch.setattr(cuda_build, "load", refuse)
    before = (gray.bgr_to_gray_kernel.launches, pyr_down_kernel.launches)
    bgr = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 21, 34, 3), dtype=np.uint8))
    g = stabilizer.bgr_to_gray(bgr)
    assert torch.equal(g, gray.bgr_to_gray_plain(bgr))
    assert torch.equal(pyr_down(g), pyr_down_plain(g))
    levels = build_pyramid(g, 3)
    assert [tuple(x.shape) for x in levels] == [(2, 21, 34), (2, 10, 17),
                                                (2, 5, 8)]
    assert (gray.bgr_to_gray_kernel.launches,
            pyr_down_kernel.launches) == before


def test_kernel_wrappers_refuse():
    """Another dtype, another last axis (G) or fewer than 2 axes (H), and
    any device but the card: the wrappers raise, no fallback."""
    frame = torch.zeros(4, 5, 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="kernel G takes uint8"):
        gray.bgr_to_gray_kernel(frame.float())
    with pytest.raises(ValueError, match=r"kernel G takes \(\.\.\., 3\)"):
        gray.bgr_to_gray_kernel(torch.zeros(4, 5, 4, dtype=torch.uint8))
    with pytest.raises(ValueError, match="kernel G runs on cuda"):
        gray.bgr_to_gray_kernel(frame)
    with pytest.raises(ValueError, match="kernel G runs on cuda"):
        gray.bgr_to_gray(frame.to("meta"))
    img = torch.zeros(2, 8, 8, dtype=torch.uint8)
    with pytest.raises(ValueError, match="kernel H takes uint8"):
        pyr_down_kernel(img.int())
    with pytest.raises(ValueError, match=r"kernel H takes \(\.\.\., H, W\)"):
        pyr_down_kernel(torch.zeros(8, dtype=torch.uint8))
    with pytest.raises(ValueError, match="kernel H runs on cuda"):
        pyr_down_kernel(img)
    with pytest.raises(ValueError, match="kernel H runs on cuda"):
        pyr_down(img.to("meta"))


def test_sources_listed_and_scanned():
    """The build names both sources, and the package glob that
    tests/test_torch_ops.py's import scan reads finds both modules."""
    assert {"gray", "pyr_down"} <= set(cuda_build.SOURCES)
    for name in ("gray", "pyr_down"):
        assert (cuda_build.CSRC_DIR / f"{name}.cu").exists()
    scanned = set(PKG.rglob("*.py"))
    assert {PKG / "ops" / "gray.py", PKG / "ops" / "pyr_down.py"} <= scanned
