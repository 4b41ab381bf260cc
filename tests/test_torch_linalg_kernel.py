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
