"""Regularized pseudo-inverse of the GN Hessian (alignment.cpp:553-583)
through a fixed-sweep Jacobi eigensolver, batched over leading axes, in the
two rotation orders of ``video_stabilizer_tpu.ops.linalg`` (linalg.py:
22-106, 140-196):

  - n == 4 (the similarity Hessian): CYCLIC order, pairs (0,1), (0,2), ...,
    (2,3), rows of the pair rotated first, then columns of the row-rotated
    matrix. The golden measurement trace pins this order.
  - n >= 6 (the 8x8 homography Hessian): PARALLEL round-robin order, n - 1
    rounds of n/2 disjoint pairs per sweep, every pair of a round rotated
    with the angles taken before the round.

``torch.linalg.eigh`` is a substitute for neither. Every product is a
broadcast multiply and sum, so the card's TF32 matmul setting cannot touch
it.

On the card ``regularized_pinv_sym4`` is one launch of kernel E
(``regularized_pinv_sym4_kernel`` -> ``csrc/jacobi.cu``, float32, n = 4 or
8): all 6 sweeps, the regularization and V diag(inv_w) V^T of every matrix
of the call. ``regularized_pinv_sym4_plain`` is the same computation in
plain PyTorch, one torch operation per expression (about 1,140 kernels a
4x4 call, 1,870 an 8x8 one): the CPU path and the card's reference, never
the main path on a card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from video_stabilizer_tpu_torch.ops import cuda_build


def _rot_rows(m, p: int, q: int, c, s):
    rows = list(m.unbind(-2))
    mp, mq = rows[p], rows[q]
    rows[p] = c * mp + s * mq
    rows[q] = -s * mp + c * mq
    return torch.stack(rows, dim=-2)


def _rot_cols(m, p: int, q: int, c, s):
    cols = list(m.unbind(-1))
    mp, mq = cols[p], cols[q]
    cols[p] = c * mp + s * mq
    cols[q] = -s * mp + c * mq
    return torch.stack(cols, dim=-1)


def eigh_sym4_cyclic(a, sweeps: int = 6):
    """(w (..., 4) unsorted eigenvalues, V (..., 4, 4)) of symmetric ``a``."""
    n = a.shape[-1]
    pairs = [(p, q) for p in range(n) for q in range(p + 1, n)]
    v = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape).clone()
    eps = torch.finfo(a.dtype).tiny
    for _ in range(sweeps):
        for p, q in pairs:
            apq = a[..., p, q]
            app = a[..., p, p]
            aqq = a[..., q, q]
            phi = 0.5 * torch.atan2(2.0 * apq, app - aqq + eps)
            c = torch.cos(phi)[..., None]
            s = torch.sin(phi)[..., None]
            a = _rot_cols(_rot_rows(a, p, q, c, s), p, q, c, s)
            v = _rot_cols(v, p, q, c, s)
    return torch.diagonal(a, dim1=-2, dim2=-1), v


@functools.lru_cache(maxsize=None)
def _round_robin_rounds(n: int):
    """All n*(n-1)/2 index pairs as n-1 rounds of n/2 DISJOINT pairs (the
    circle round-robin schedule of linalg.py:22-34)."""
    idx = list(range(n))
    rounds = []
    for _ in range(n - 1):
        pairs = [tuple(sorted((idx[i], idx[n - 1 - i])))
                 for i in range(n // 2)]
        rounds.append(tuple(pairs))
        idx = [idx[0], idx[-1]] + idx[1:-1]
    return tuple(rounds)


@functools.lru_cache(maxsize=None)
def _round_robin_index(n: int, device: torch.device):
    """Per round: (p indices, q indices, the permutation that puts the
    rotated [p rows | q rows] back in index order), cached per device so
    no call copies an index table to the card."""
    out = []
    for pairs in _round_robin_rounds(n):
        ps = [p for p, _ in pairs]
        qs = [q for _, q in pairs]
        order = sorted(range(n), key=(ps + qs).__getitem__)
        out.append(tuple(torch.tensor(x, dtype=torch.int64, device=device)
                         for x in (ps, qs, order)))
    return tuple(out)


def _rotate_pairs(m, dim: int, ps, qs, order, rot):
    """Rotate the (p, q) rows (dim=-2) or columns (dim=-1) of every pair of
    a round at once: new p = c*m_p + s*m_q, new q = (-s)*m_p + c*m_q, each a
    sum of two products in that order (linalg.py:102-104). ``rot`` is
    (..., 2, 2, n/2), [[c, s], [-s, c]] per pair."""
    mp = m.index_select(dim, ps)           # (..., n/2, n) or (..., n, n/2)
    mq = m.index_select(dim, qs)
    r = rot[..., None] if dim == -2 else rot[..., None, :]
    new = [r[..., i, 0, :, :] * mp + r[..., i, 1, :, :] * mq
           for i in range(2)]
    return torch.cat(new, dim=dim).index_select(dim, order)


def eigh_sym_round_robin(a, sweeps: int = 6):
    """(w (..., n) unsorted eigenvalues, V (..., n, n)) of symmetric ``a``,
    n even: per round A <- R A R^T, V <- V R^T with R the round's n/2
    disjoint Givens rotations (linalg.py:70-106)."""
    n = a.shape[-1]
    v = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape).clone()
    eps = torch.finfo(a.dtype).tiny
    rounds = _round_robin_index(n, a.device)
    for _ in range(sweeps):
        for ps, qs, order in rounds:
            app = a[..., ps, ps]
            aqq = a[..., qs, qs]
            apq = a[..., ps, qs]
            phi = 0.5 * torch.atan2(2.0 * apq, app - aqq + eps)
            c, s = torch.cos(phi), torch.sin(phi)
            rot = torch.stack([torch.stack([c, s], -2),
                               torch.stack([-s, c], -2)], -3)
            a = _rotate_pairs(_rotate_pairs(a, -2, ps, qs, order, rot), -1,
                              ps, qs, order, rot)
            v = _rotate_pairs(v, -1, ps, qs, order, rot)
    return torch.diagonal(a, dim1=-2, dim2=-1), v


def eigh_sym(a, sweeps: int = 6):
    """(w (..., n) unsorted eigenvalues, V (..., n, n)) of small symmetric
    ``a`` by fixed-sweep Jacobi, in the JAX package's rotation order
    (linalg.py:37-106): cyclic for n == 4, round-robin for an even n >= 6.
    The order stays: the golden trace pins the 4x4 one."""
    n = a.shape[-1]
    if n == 4:
        return eigh_sym4_cyclic(a, sweeps)
    if n >= 6 and n % 2 == 0:
        return eigh_sym_round_robin(a, sweeps)
    raise ValueError(f"eigh_sym takes n == 4 or an even n >= 6, got {n}")


def eigh_sym4(a, sweeps: int = 6):
    """4x4 specialization of ``eigh_sym`` (linalg.py:172-174)."""
    return eigh_sym(a, sweeps=sweeps)


def regularized_pinv_sym4(h, cond_threshold: float = 1e6,
                          tikhonov_scale: float = 1e-6):
    """cond = w_max / (w_min + 1e-10); above 1e6 add 1e-6 * w_max to the
    diagonal; invert with near-null eigenvalues zeroed (DECOMP_SVD). Takes
    the 4x4 similarity Hessian (cyclic Jacobi) or the 8x8 homography one
    (round-robin Jacobi), as the JAX function does, batched over leading
    axes.

    On the card this is one launch of kernel E (float32); on the CPU the
    plain version."""
    if h.device.type == "cpu":
        return regularized_pinv_sym4_plain(h, cond_threshold, tikhonov_scale)
    return regularized_pinv_sym4_kernel(h, cond_threshold, tikhonov_scale)


def regularized_pinv_sym4_plain(h, cond_threshold: float = 1e6,
                                tikhonov_scale: float = 1e-6):
    """``regularized_pinv_sym4`` in plain PyTorch: the Jacobi rotations of
    ``eigh_sym``, then the regularized inverse, one torch operation per
    expression."""
    w, v = eigh_sym(h)
    w_max = torch.amax(w, dim=-1, keepdim=True)
    w_min = torch.amin(w, dim=-1, keepdim=True)
    cond = w_max / (w_min + 1e-10)
    lam = torch.where(cond > cond_threshold, tikhonov_scale * w_max,
                      torch.zeros_like(w_max))
    w2 = w + lam
    cutoff = torch.clamp(w_max + lam, min=0.0) * 1e-7
    inv_w = torch.where(w2 > cutoff, 1.0 / w2, torch.zeros_like(w2))
    # (V diag(inv_w)) V^T as a broadcast sum: full float32 whatever the
    # card's TF32 matmul setting.
    vs = v * inv_w[..., None, :]
    return (vs[..., :, :, None] * v.transpose(-1, -2)[..., None, :, :]).sum(-2)


def regularized_pinv_sym4_kernel(h, cond_threshold: float = 1e6,
                                 tikhonov_scale: float = 1e-6,
                                 sweeps: int = 6):
    """``regularized_pinv_sym4_plain``'s function as one launch of kernel E
    on the CUDA card: float32 (..., n, n), n = 4 (cyclic order) or 8
    (round-robin order). ``sweeps`` is the plain version's 6 on every path
    (chip_smoke.py runs more to measure the dependent chain). Raises on any
    other device, dtype or n, and if the launch is refused. Each launch
    adds one to ``regularized_pinv_sym4_kernel.launches``."""
    if h.dtype != torch.float32:
        raise ValueError(f"kernel E takes float32 matrices, not {h.dtype}")
    n = h.shape[-1] if h.dim() >= 2 else 0
    if n not in (4, 8) or h.shape[-2] != n:
        raise ValueError(f"kernel E takes (..., 4, 4) or (..., 8, 8) "
                         f"matrices, got {tuple(h.shape)}")
    if h.device.type != "cuda":
        raise ValueError(f"kernel E runs on cuda, not {h.device}")
    mats = h.reshape(-1, n, n).contiguous()
    out = torch.empty_like(mats)
    b = mats.shape[0]
    if b == 0:
        return out.reshape(h.shape)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = _kernel()(mats.data_ptr(), out.data_ptr(), b, n, sweeps,
                    float(cond_threshold), float(tikhonov_scale), stream)
    if err != 0:
        raise RuntimeError(f"jacobi kernel launch failed ({b} matrices of "
                           f"{n}x{n}): CUDA error {err}")
    regularized_pinv_sym4_kernel.launches += 1
    return out.reshape(h.shape)


@functools.cache
def _kernel():
    """``vs_regularized_pinv`` of the built ``csrc/jacobi.cu``, typed."""
    fn = cuda_build.load("jacobi").vs_regularized_pinv
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
        ctypes.c_float] * 2 + [ctypes.c_void_p]
    return fn


regularized_pinv_sym4_kernel.launches = 0
