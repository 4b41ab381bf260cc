"""Similarity-transform algebra on (..., 4) tensors ``[A, B, TX, TY]``.

    W(x, y) = ((1 + A) * x - B * y + TX,  B * x + (1 + A) * y + TY)

Same expressions, in the same evaluation order, as
``video_stabilizer_tpu.transforms`` (reference: imgproc.cpp:333-437). Every
function broadcasts over leading axes.
"""

from __future__ import annotations

import torch

A, B, TX, TY = 0, 1, 2, 3


def identity(batch_shape=(), dtype=torch.float32, device=None):
    """The identity transform: zeros of shape ``batch_shape + (4,)``."""
    return torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=device)


def make(a=0.0, b=0.0, tx=0.0, ty=0.0, dtype=torch.float32, device=None):
    """A transform tensor from scalars (or equal-shaped tensors), stacked on
    the last axis (transforms.py:38-41)."""
    return torch.stack([torch.as_tensor(v, dtype=dtype, device=device)
                        for v in (a, b, tx, ty)], dim=-1)


def warp_points(t, xy):
    """Warp (..., 2) points by ``t`` about the origin (imgproc.cpp:389-394)."""
    a, b = t[..., A], t[..., B]
    x, y = xy[..., 0], xy[..., 1]
    wx = (1.0 + a) * x - b * y + t[..., TX]
    wy = b * x + (1.0 + a) * y + t[..., TY]
    return torch.stack([wx, wy], dim=-1)


def warp_points_center(t, xy, cx, cy):
    """Warp (..., 2) points by ``t`` pivoting rotation/scale about
    (cx, cy) (imgproc.cpp:401-411)."""
    a, b = t[..., A], t[..., B]
    px = xy[..., 0] - cx
    py = xy[..., 1] - cy
    wx = (1.0 + a) * px - b * py + cx + t[..., TX]
    wy = b * px + (1.0 + a) * py + cy + t[..., TY]
    return torch.stack([wx, wy], dim=-1)


def inverse(t):
    """Exact closed-form inverse (imgproc.cpp:333-359)."""
    p = 1.0 + t[..., A]
    q = t[..., B]
    denom = p * p + q * q
    a_inv = p / denom - 1.0
    b_inv = -q / denom
    tx_inv = (-p * t[..., TX] - q * t[..., TY]) / denom
    ty_inv = (q * t[..., TX] - p * t[..., TY]) / denom
    return torch.stack([a_inv, b_inv, tx_inv, ty_inv], dim=-1)


def compose(t1, t2):
    """``T2(T1(p))``: apply t1 first, then t2 (imgproc.cpp:361-387)."""
    p1 = 1.0 + t1[..., A]
    q1 = t1[..., B]
    p2 = 1.0 + t2[..., A]
    q2 = t2[..., B]
    a3 = p2 * p1 - q2 * q1 - 1.0
    b3 = p2 * q1 + q2 * p1
    tx3 = p2 * t1[..., TX] - q2 * t1[..., TY] + t2[..., TX]
    ty3 = q2 * t1[..., TX] + p2 * t1[..., TY] + t2[..., TY]
    return torch.stack([a3, b3, tx3, ty3], dim=-1)


def corner_points(width, height, dtype=torch.float32, device=None):
    """The four corners of the displacement metric (imgproc.cpp:424-427):
    (0, 0), (w, 0), (0, h), (w, h) as (..., 4, 2), broadcast over the
    shapes of ``width`` and ``height``."""
    w = torch.as_tensor(width, dtype=dtype, device=device)
    h = torch.as_tensor(height, dtype=dtype, device=device)
    w, h = torch.broadcast_tensors(w, h)
    z = torch.zeros_like(w)
    return torch.stack([torch.stack([z, z], -1), torch.stack([w, z], -1),
                        torch.stack([z, h], -1), torch.stack([w, h], -1)],
                       dim=-2)


def max_corner_displacement(t, width, height):
    """Max distance an image corner (0,0), (w,0), (0,h), (w,h) moves under
    ``t`` pivoted about (W*0.5, H*0.5) (imgproc.cpp:419-437). The corners
    enter as Python scalars: a corner tensor built on the card would be a
    host-to-device copy that waits for the device."""
    w, h = float(width), float(height)
    cx, cy = w * 0.5, h * 0.5
    a, b = t[..., A], t[..., B]
    dists = []
    for x, y in ((0.0, 0.0), (w, 0.0), (0.0, h), (w, h)):
        px, py = x - cx, y - cy
        dx = ((1.0 + a) * px - b * py + cx + t[..., TX]) - x
        dy = (b * px + (1.0 + a) * py + cy + t[..., TY]) - y
        dists.append(torch.sqrt(dx * dx + dy * dy))
    return torch.amax(torch.stack(dists, dim=-1), dim=-1)


def center_to_ul(t, width, height, minus_one=False):
    """Center-pivot (TX, TY) to the origin-based translation of the raw
    warps. ``minus_one=True`` uses cx = (W-1)*0.5 (ImageWarp,
    imgproc.cpp:125-131), else cx = W*0.5 (SparseICA, imgproc.cpp:72-75)."""
    if minus_one:
        cx = (width - 1) * 0.5
        cy = (height - 1) * 0.5
    else:
        cx = width * 0.5
        cy = height * 0.5
    a, b = t[..., A], t[..., B]
    tx_ul = t[..., TX] - a * cx + b * cy
    ty_ul = t[..., TY] - b * cx - a * cy
    return torch.stack([a, b, tx_ul, ty_ul], dim=-1)


def to_affine_matrix(t, width=None, height=None, minus_one=True):
    """(..., 2, 3) forward affine matrix [[1+A, -B, tx], [B, 1+A, ty]];
    with ``width`` and ``height`` TX/TY are first made origin-based
    (imgproc.cpp:446-467, transforms.py:161-172)."""
    if width is not None:
        t = center_to_ul(t, width, height, minus_one=minus_one)
    a, b = t[..., A], t[..., B]
    row0 = torch.stack([1.0 + a, -b, t[..., TX]], dim=-1)
    row1 = torch.stack([b, 1.0 + a, t[..., TY]], dim=-1)
    return torch.stack([row0, row1], dim=-2)
