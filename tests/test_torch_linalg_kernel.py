"""Kernel E around its plain version (``ops/linalg.py``): the dispatch by
device, the wrapper's refusals, and the 8x8 rotation order written into
``csrc/jacobi.cu``. The plain version is held to the JAX package's
``regularized_pinv_sym4`` by tests/test_torch_ops.py and
tests/test_torch_homography.py; the kernel runs only on the card
(``chip_smoke.py`` phase E), where it is held to the plain version."""

import pathlib
import re

import numpy as np
import pytest
import torch

from video_stabilizer_tpu_torch.ops import linalg

torch.set_num_threads(1)

SOURCE = (pathlib.Path(linalg.__file__).resolve().parent.parent / "csrc"
          / "jacobi.cu")


def test_round_robin_table_is_the_plain_order():
    """The kernel's RR8 table lists ``_round_robin_rounds(8)``: the same 7
    rounds of 4 disjoint pairs in the same order."""
    text = SOURCE.read_text()
    body = text[text.index("RR8[7][4][2] = {"):]
    body = body[:body.index("};")]
    pairs = [(int(p), int(q)) for p, q in re.findall(r"\{(\d), (\d)\}",
                                                     body)]
    rounds = tuple(tuple(pairs[4 * r:4 * r + 4]) for r in range(7))
    assert len(pairs) == 28
    assert rounds == linalg._round_robin_rounds(8)


def _hessians(n, batch, seed):
    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(batch):
        q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        mats.append((q * rng.uniform(1.0, 50.0, n)) @ q.T)
    return torch.from_numpy(np.stack(mats).astype(np.float32))


@pytest.mark.parametrize("n", [4, 8])
def test_dispatch_by_device(n):
    """A CPU tensor takes the plain version, bit for bit, with any leading
    axes, and launches nothing; the kernel's wrapper refuses another dtype,
    another n and any device but the card: no fallback to the plain
    version."""
    h = _hessians(n, 6, 31)
    before = linalg.regularized_pinv_sym4_kernel.launches
    got = linalg.regularized_pinv_sym4(h.reshape(2, 3, n, n))
    want = linalg.regularized_pinv_sym4_plain(h).reshape(2, 3, n, n)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    with pytest.raises(ValueError, match="kernel E takes float32"):
        linalg.regularized_pinv_sym4_kernel(h.double())
    with pytest.raises(ValueError, match=r"kernel E takes \(\.\.\., 4, 4\)"):
        linalg.regularized_pinv_sym4_kernel(torch.zeros(2, 6, 6))
    with pytest.raises(ValueError, match="kernel E runs on cuda"):
        linalg.regularized_pinv_sym4_kernel(h)
    with pytest.raises(ValueError, match="kernel E runs on cuda"):
        linalg.regularized_pinv_sym4(h.to("meta"))
    assert linalg.regularized_pinv_sym4_kernel.launches == before


def _kernel_rounds():
    """The source's RR8 table as 7 rounds of 4 (p, q) pairs."""
    text = SOURCE.read_text()
    body = text[text.index("RR8[7][4][2] = {"):]
    body = body[:body.index("};")]
    pairs = [(int(p), int(q)) for p, q in re.findall(r"\{(\d), (\d)\}",
                                                     body)]
    return [pairs[4 * r:4 * r + 4] for r in range(7)]


def _units(pairs):
    """Kernel E's 8x8 lane units in a round: lane l owns (pair l // 8,
    index l % 8), as (p, q, j) per lane."""
    return [(*pairs[lane // 8], lane % 8) for lane in range(32)]


def test_lane_units_write_each_element_once():
    """In every round the 32 lane units write each element of A once in the
    row phase (a[p][j], a[q][j]) and each element of A and of V once in the
    column phase (a[j][p], a[j][q]): no two lanes write one element."""
    every = sorted((i, j) for i in range(8) for j in range(8))
    for pairs in _kernel_rounds():
        units = _units(pairs)
        rows = [e for p, q, j in units for e in ((p, j), (q, j))]
        cols = [e for p, q, j in units for e in ((j, p), (j, q))]
        assert sorted(rows) == every and sorted(cols) == every


def _lane_sweeps(a, sweeps):
    """Kernel E's 8x8 rounds with the lane units above, in torch on the
    CPU: every lane takes its own pair's angle from the round's A, then the
    row phase, then the column phase of A and of V, each element written by
    its one lane from the old values. Returns (diag(A), V)."""
    b = a.shape[0]
    m = a.reshape(b, 64).clone()
    v = torch.eye(8).expand(b, 8, 8).reshape(b, 64).clone()
    eps = torch.finfo(a.dtype).tiny
    rounds = [torch.tensor(_units(pairs)).T for pairs in _kernel_rounds()]

    def rotate(x, ip, iq, c, s):
        xp, xq = x[:, ip], x[:, iq]
        x = x.clone()
        x[:, ip] = c * xp + s * xq
        x[:, iq] = -s * xp + c * xq
        return x

    for _ in range(sweeps):
        for p, q, j in rounds:
            app, aqq, apq = m[:, p * 9], m[:, q * 9], m[:, p * 8 + q]
            phi = 0.5 * torch.atan2(2.0 * apq, app - aqq + eps)
            c, s = torch.cos(phi), torch.sin(phi)
            m = rotate(m, p * 8 + j, q * 8 + j, c, s)
            m = rotate(m, j * 8 + p, j * 8 + q, c, s)
            v = rotate(v, j * 8 + p, j * 8 + q, c, s)
    return m[:, ::9], v.reshape(b, 8, 8)


@pytest.mark.parametrize("sweeps", [1, 6])
def test_lane_units_are_the_round_robin_order(sweeps):
    """The lane units' sweeps equal ``eigh_sym_round_robin``'s bit for bit.
    16 matrices, so that torch's CPU atan2, cos and sin see 64 elements a
    call in the plain version and 512 here, both whole vector loops (their
    scalar tail rounds otherwise)."""
    h = _hessians(8, 16, 32)
    w, v = _lane_sweeps(h, sweeps)
    w_want, v_want = linalg.eigh_sym_round_robin(h, sweeps)
    assert torch.equal(w.view(torch.int32), w_want.view(torch.int32))
    assert torch.equal(v.view(torch.int32), v_want.view(torch.int32))
