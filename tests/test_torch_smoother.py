"""Kernel D's plain version (``ops/tvl1.py::tvl1_smooth_plain``) held to
the JAX package's ``tvl1_smooth`` on the CPU, and the packing and dispatch
around the kernel. The kernel itself runs only on the card
(``chip_smoke.py``'s phase "kernel D"), where it is held to the plain
version bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilizer_tpu.models.smoother import tvl1_smooth as jax_tvl1
from video_stabilizer_tpu_torch.models import smoother
from video_stabilizer_tpu_torch.ops.tvl1 import (
    pack_rows, tvl1_smooth_kernel, tvl1_smooth_plain)

torch.set_num_threads(1)

N = 6
LAM_01 = float(np.float32(0.1))


def smoother_rows():
    """(6, N) float32 rows: a random walk, an exact tie (|x1 - x0| ==
    float32(0.1) after the first relaxation, the lam of that row), a NaN,
    values near 1e-30 and 1e6."""
    rng = np.random.default_rng(12)
    data = (np.cumsum(rng.normal(size=(6, N)), -1) * 2).astype(np.float32)
    data[0, :2] = [0.0, LAM_01]
    data[3, 2] = np.nan
    data[4] = np.float32(1e-30) * np.arange(N, dtype=np.float32)
    data[5] = np.float32(1e6) * rng.normal(size=N).astype(np.float32)
    return data


CASES = {
    # lam a Python float that float32 cannot hold; every pair live.
    "float lam 0.1": (0.1, None),
    # One lam and one valid_len per row: 1 (no pair live), a middle
    # length and N.
    "per-row lam and valid_len": (
        np.array([0.1, 0.5, 1.0, 4.0, 0.1, 2.0], np.float32),
        np.array([N, 1, 3, N, N, 4], np.int32)),
}


def rounded_once(data, lam, iterations, valid):
    """The loop in numpy float32, every operation rounded once: the
    rounding kernel D keeps on the card."""
    f32, n = np.float32, data.shape[-1]
    lam = np.asarray(lam, f32)
    valid = np.full(data.shape[:-1], n) if valid is None else valid
    d = list(data.T)
    x = list(d)
    with np.errstate(invalid="ignore"):
        for _ in range(iterations):
            x = [f32(0.5) * c + f32(0.5) * e for c, e in zip(x, d)]
            for i in range(n - 1):
                xi, xj = x[i], x[i + 1]
                diff = xj - xi
                mag = np.abs(diff)
                shrink = ((mag - lam) / np.maximum(mag, np.finfo(f32).tiny)
                          ) * f32(0.5)
                mid = f32(0.5) * (xi + xj)
                take, act = mag > lam, (i + 1) < valid
                x[i] = np.where(act, np.where(take, xi + diff * shrink, mid),
                                xi)
                x[i + 1] = np.where(act, np.where(take, xj - diff * shrink,
                                                  mid), xj)
    return np.stack(x, -1)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax(case):
    """Bit-equal, NaN positions included, to the loop with every float32
    operation rounded once (so a Python float lam enters as float32, as
    JAX's does). Against JAX: NaN positions equal, the rest within rtol
    1e-6 (8 float32 ULPs): XLA on the CPU contracts ``xi + diff * shrink``
    and ``xj - diff * shrink`` into FMAs, one rounding where torch rounds
    twice; these rows differ by up to 4 ULPs."""
    lam, valid = CASES[case]
    data = smoother_rows()
    got = tvl1_smooth_plain(
        torch.from_numpy(data),
        lam if isinstance(lam, float) else torch.from_numpy(lam), 100,
        None if valid is None else torch.from_numpy(valid)).numpy()
    assert np.isnan(got).any()
    np.testing.assert_array_equal(
        got.view(np.int32), rounded_once(data, lam, 100, valid).view(np.int32))
    want = np.asarray(jax_tvl1(
        jnp.asarray(data), jnp.asarray(lam, jnp.float32), 100,
        None if valid is None else jnp.asarray(valid)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _chunk_call(rng):
    # models/chunked.py::_chunk_smoothed: (S, tc, P, win) windows, a
    # transposed view; one valid_len per (stream, frame).
    wins = torch.from_numpy(rng.normal(size=(2, 3, 7, 4)).astype(np.float32))
    return (wins.transpose(-1, -2), 4.0,
            torch.from_numpy(rng.integers(1, 8, size=(2, 3, 1))))


def _sweep_call(rng):
    # models/batch.py::smooth_trajectory under the smoother sweep: one lam
    # per combo, one valid_len per output frame.
    wins = torch.from_numpy(rng.normal(size=(3, 5, 4, 7)).astype(np.float32))
    lams = torch.tensor([0.1, 1.0, 8.0])
    return (wins, lams[:, None, None],
            torch.from_numpy(rng.integers(1, 8, size=(5, 1))))


def _window_call(rng):
    # models/smoother.py::_smooth_window_body: (4, win), a count.
    return (torch.from_numpy(rng.normal(size=(4, 7)).astype(np.float32)),
            2.0, 3)


@pytest.mark.parametrize("make", [_chunk_call, _sweep_call, _window_call],
                         ids=["chunk", "sweep", "window"])
def test_packed_rows_smooth_as_the_call(make):
    """The plain version on ``pack_rows``' (R, N) rows with one lam and one
    valid_len per row equals it on the caller's broadcast shapes."""
    data, lam, valid = make(np.random.default_rng(3))
    rows, lam_r, valid_r = pack_rows(data, lam, valid)
    r = int(np.prod(data.shape[:-1]))
    assert rows.shape == (r, data.shape[-1]) and rows.is_contiguous()
    assert lam_r.shape == valid_r.shape == (r,)
    assert (lam_r.dtype, valid_r.dtype) == (torch.float32, torch.int32)
    want = tvl1_smooth_plain(data, lam, 100, valid)
    got = tvl1_smooth_plain(rows, lam_r, 100, valid_r).reshape(data.shape)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_dispatch_by_device():
    """A CPU tensor takes the plain version and launches nothing; any other
    tensor goes to kernel D, which runs on the card or raises: no fallback
    to the plain version."""
    data = torch.from_numpy(smoother_rows())
    before = tvl1_smooth_kernel.launches
    got = smoother.tvl1_smooth(data, 0.1, valid_len=4)
    assert torch.equal(got.view(torch.int32), tvl1_smooth_plain(
        data, 0.1, 100, 4).view(torch.int32))
    assert tvl1_smooth_kernel.launches == before
    with pytest.raises(ValueError, match="kernel D runs on cuda"):
        smoother.tvl1_smooth(data.to("meta"), 0.1)
    with pytest.raises(ValueError, match="kernel D runs on cuda"):
        tvl1_smooth_kernel(data, 0.1)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            smoother.tvl1_smooth(torch.zeros((2, N), device="cuda"), 0.1)
    assert tvl1_smooth_kernel.launches == before


def wavefront(data, lam, iterations, valid):
    """Kernel D's order for rows of N <= 32 (``csrc/tvl1.cu``,
    ``tvl1_wave_kernel``) emulated in torch on the CPU: column j is lane j,
    and at step t lane j, with u = t - j, is the left side of pair j of
    iteration u / 2 (u even) or the right side of pair j - 1 of iteration
    (u + 1) / 2 (u odd). Column j relaxes as the right side just before its
    pair j - 1, column 0 as the left side before its pair 0. Both lanes of
    a pair run the plain version's update on the same two values and keep
    their own side. Returns (rows, steps)."""
    n = data.shape[-1]
    j = torch.arange(n)
    tiny = torch.finfo(data.dtype).tiny
    lam, valid = lam[:, None], valid[:, None]
    x = data.clone()
    steps = 2 * (iterations - 1) + max(n - 2, 0) + 1
    for t in range(steps):
        u = t - j
        left = u % 2 == 0
        k = torch.where(left, u // 2, (u + 1) // 2)
        now = (k >= 0) & (k < iterations)
        relax = now & torch.where(left, j == 0, j > 0)
        x = torch.where(relax, 0.5 * x + 0.5 * data, x)
        y = x[:, torch.where(left, j + 1, j - 1).clamp(0, n - 1)]
        xi, xj = torch.where(left, x, y), torch.where(left, y, x)
        diff = xj - xi
        mag = torch.abs(diff)
        shrink = (mag - lam) / torch.clamp(mag, min=tiny) * 0.5
        mid = 0.5 * (xi + xj)
        take = mag > lam
        new = torch.where(left, torch.where(take, xi + diff * shrink, mid),
                          torch.where(take, xj - diff * shrink, mid))
        pair = now & torch.where(left, j + 1 < n, j > 0)
        active = torch.where(left, j + 1, j) < valid
        x = torch.where(pair & active, new, x)
    return x, steps


@pytest.mark.parametrize("lam", [0.0, 5.0])
@pytest.mark.parametrize("n", [2, 3, 16, 32])
def test_wavefront_order_is_the_plain_loop(n, lam):
    """The wavefront's order gives the plain version's rows bit for bit
    (NaN positions included) in 2 x (100 - 1) + N - 1 steps: one row for
    every valid_len from 0 to N and a row with a NaN."""
    rng = np.random.default_rng(40 + n)
    data = (np.cumsum(rng.normal(size=(n + 2, n)), -1) * 3).astype(
        np.float32)
    data[-1, n // 2] = np.nan
    rows = torch.from_numpy(data)
    lam_r = torch.full((n + 2,), lam)
    valid = torch.tensor(list(range(n + 1)) + [n], dtype=torch.int32)
    got, steps = wavefront(rows, lam_r, 100, valid)
    want = tvl1_smooth_plain(rows, lam_r, 100, valid)
    assert steps == 2 * 99 + n - 1
    assert torch.isnan(want).any()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
