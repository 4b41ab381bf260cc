"""8-DOF homography algebra on (..., 8) tensors.

    H(p) = [[1+p0, p1,   p2],
            [p3,   1+p4, p5],
            [p6,   p7,   1 ]]

acting on centered, width-normalized coordinates u = (x - W*0.5) / W,
v = (y - H*0.5) / W, so one parameter vector holds at every pyramid level.
Same expressions, in the same evaluation order, as
``video_stabilizer_tpu.homography`` (homography.py:1-113); every function
broadcasts over leading axes.

The 3x3 products are written out as sums of three products, so no matmul
(and no TF32 setting of the card) touches them. ``inverse`` is the
closed-form adjugate: the determinant cancels in the H22 normalization of
``from_matrix``, so no division by it, and nothing here waits for the device
(``torch.linalg.inv`` checks for singular matrices on the host).
"""

from __future__ import annotations

import torch


def identity(batch_shape=(), dtype=torch.float32, device=None):
    """The identity homography: zeros of shape ``batch_shape + (8,)``."""
    return torch.zeros(tuple(batch_shape) + (8,), dtype=dtype, device=device)


def to_matrix(p):
    """(..., 8) -> (..., 3, 3) with H[2,2] = 1."""
    one = torch.ones_like(p[..., 0])
    row0 = torch.stack([1.0 + p[..., 0], p[..., 1], p[..., 2]], -1)
    row1 = torch.stack([p[..., 3], 1.0 + p[..., 4], p[..., 5]], -1)
    row2 = torch.stack([p[..., 6], p[..., 7], one], -1)
    return torch.stack([row0, row1, row2], -2)


def from_matrix(m):
    """(..., 3, 3) -> (..., 8), normalizing H[2,2] to 1."""
    m = m / m[..., 2:3, 2:3]
    return torch.stack([
        m[..., 0, 0] - 1.0, m[..., 0, 1], m[..., 0, 2],
        m[..., 1, 0], m[..., 1, 1] - 1.0, m[..., 1, 2],
        m[..., 2, 0], m[..., 2, 1],
    ], -1)


def matmul3(a, b):
    """(..., 3, 3) @ (..., 3, 3) as explicit f32 sums of three products."""
    return (a[..., :, 0, None] * b[..., None, 0, :]
            + a[..., :, 1, None] * b[..., None, 1, :]
            + a[..., :, 2, None] * b[..., None, 2, :])


def warp_norm(p, uv):
    """Warp centered-normalized points. uv: (..., 2) -> (..., 2)."""
    u, v = uv[..., 0], uv[..., 1]
    num_x = (1.0 + p[..., 0]) * u + p[..., 1] * v + p[..., 2]
    num_y = p[..., 3] * u + (1.0 + p[..., 4]) * v + p[..., 5]
    den = p[..., 6] * u + p[..., 7] * v + 1.0
    return torch.stack([num_x / den, num_y / den], -1)


def norm_coords(xy, width, height):
    """Pixel -> centered width-normalized coordinates."""
    s = 1.0 / width
    cx, cy = width * 0.5, height * 0.5
    return torch.stack([(xy[..., 0] - cx) * s, (xy[..., 1] - cy) * s], -1)


def denorm_coords(uv, width, height):
    cx, cy = width * 0.5, height * 0.5
    return torch.stack([uv[..., 0] * width + cx, uv[..., 1] * width + cy], -1)


def warp_points(p, xy, width, height):
    """Warp pixel-coordinate points (about the W*0.5 center)."""
    return denorm_coords(warp_norm(p, norm_coords(xy, width, height)),
                         width, height)


def compose(p1, p2):
    """Apply p1 first, then p2: H(p2) @ H(p1), H22-normalized."""
    return from_matrix(matmul3(to_matrix(p2), to_matrix(p1)))


def inverse(p):
    """H(p)^-1 as the adjugate of H(p), H22-normalized."""
    m = to_matrix(p)

    def e(i, j):
        return m[..., i, j]

    adj = torch.stack([
        torch.stack([e(1, 1) * e(2, 2) - e(1, 2) * e(2, 1),
                     e(0, 2) * e(2, 1) - e(0, 1) * e(2, 2),
                     e(0, 1) * e(1, 2) - e(0, 2) * e(1, 1)], -1),
        torch.stack([e(1, 2) * e(2, 0) - e(1, 0) * e(2, 2),
                     e(0, 0) * e(2, 2) - e(0, 2) * e(2, 0),
                     e(0, 2) * e(1, 0) - e(0, 0) * e(1, 2)], -1),
        torch.stack([e(1, 0) * e(2, 1) - e(1, 1) * e(2, 0),
                     e(0, 1) * e(2, 0) - e(0, 0) * e(2, 1),
                     e(0, 0) * e(1, 1) - e(0, 1) * e(1, 0)], -1),
    ], -2)
    return from_matrix(adj)


def sim_to_homography(t, width, height):
    """Embed a centre-pivot similarity (..., 4) [A, B, TX, TY] (W*0.5
    convention) into the normalized homography parameterization."""
    a, b = t[..., 0], t[..., 1]
    s = 1.0 / width
    zero = torch.zeros_like(a)
    return torch.stack([a, -b, t[..., 2] * s, b, a, t[..., 3] * s,
                        zero, zero], -1)


def max_corner_displacement(p, width, height):
    """Max distance an image corner (0,0), (w,0), (0,h), (w,h) moves under
    ``p``. The corners enter as Python scalars: a corner tensor built on the
    card would be a host-to-device copy that waits for the device."""
    w, h = float(width), float(height)
    s = 1.0 / w
    cx, cy = w * 0.5, h * 0.5
    dists = []
    for x, y in ((0.0, 0.0), (w, 0.0), (0.0, h), (w, h)):
        u = torch.full_like(p[..., 0], x - cx) * s
        v = torch.full_like(p[..., 0], y - cy) * s
        wuv = warp_norm(p, torch.stack([u, v], -1))
        dx = (wuv[..., 0] * w + cx) - x
        dy = (wuv[..., 1] * w + cy) - y
        dists.append(torch.sqrt(dx * dx + dy * dy))
    return torch.amax(torch.stack(dists, dim=-1), dim=-1)


def jacobian_rows(u, v):
    """d(warped u, v)/d(p) at p = 0 for normalized coords (u, v):
    dWu/dp = [u, v, 1, 0, 0, 0, -u^2, -uv],
    dWv/dp = [0, 0, 0, u, v, 1, -uv, -v^2]. Returns (ju, jv), each
    (..., 8)."""
    one = torch.ones_like(u)
    zero = torch.zeros_like(u)
    ju = torch.stack([u, v, one, zero, zero, zero, -u * u, -u * v], -1)
    jv = torch.stack([zero, zero, zero, u, v, one, -u * v, -v * v], -1)
    return ju, jv
