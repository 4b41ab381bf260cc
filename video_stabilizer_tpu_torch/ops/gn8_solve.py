"""Per-level 8-DOF Gauss-Newton solve: kernel C of the port.

``gn8_solve`` launches ``csrc/gn8_solve.cu`` for CUDA tensors and runs
``gn8_solve_plain`` for CPU tensors. It replaces
``video_stabilizer_tpu/ops/pallas_gn.py::_gn8_kernel`` (with ``_compose_h``,
``_warp_corner_h`` and ``_tap_sample``), batched over items on a leading
axis as kernel B is (``ops/gn_solve.py``): an item is one alignment at one
level, and it names its keyframe through ``key_index``. See the source
note in ``csrc/gn8_solve.cu`` for the bound and the design. Each item runs
on a thread-block cluster that splits its N keypoints; ``launch_plan``
picks the cluster and block size. The threshold is one value per item, as
kernel B's is (``gn_solve.item_thresholds``).

The plain version is the XLA loop of
``models/homography_aligner.py::_align_level_h`` (175-216) in PyTorch, with
one host sync per iteration; it is the CPU path and the card's reference,
never the main path on a card. Both take the keypoints already normalized
(u, v), which the XLA loop rebuilds from the same pixel coordinates in
every iteration with the same expressions.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from video_stabilizer_tpu_torch import homography as Hm
from video_stabilizer_tpu_torch.ops import cuda_build
from video_stabilizer_tpu_torch.ops.gn_solve import (
    CLUSTER_SIZES, LaunchPlan, gn_corners, item_thresholds, make_plan)
from video_stabilizer_tpu_torch.ops.patches import (
    clamp_rel, sample_windows_flat)

# Float32 operations of csrc/gn8_solve.cu per keypoint, set and iteration
# (each add, multiply, divide, min, max, floor and bf16 rounding counted
# once): the projective warp in normalized coordinates and back to pixels
# (20), the window offset, clamp and floor (8), eight Lanczos2 weights
# (8 x 16), their normalizer (7), the 4x4 taps of bf16 products (100), the
# residual (2) and the eight terms of b (16).
OPS_PER_SAMPLE = 281

# Floats of csrc/gn8_solve.cu's operand cache per keypoint (CACHE_FLOATS):
# ox, oy, and per set u, v, template and 8 Jacobian rows.
CACHE_FLOATS = 24
THREADS = (256, 512)   # the block sizes csrc/gn8_solve.cu is built for


def launch_plan(items: int, n: int) -> LaunchPlan:
    """Kernel C's plan for ``items`` items of ``n`` keypoints (a pure
    function; the measurements behind it are in PERF.md): the fewest CTAs
    per item, up to 8, that leave each at most 1024 keypoints, 256 threads
    for a slice of at most 1024 keypoints and 512 above."""
    cluster = next((c for c in CLUSTER_SIZES if -(-n // c) <= 1024), 8)
    threads = 256 if -(-n // cluster) <= 1024 else 512
    return make_plan(items, n, cluster, threads, CACHE_FLOATS)


def normalized_keypoints(key, spec):
    """(u, v) (K, 2, N): the keypoints in centered width-normalized
    coordinates, as ``_warp_rel_h`` forms them (homography_aligner.py:
    118-119)."""
    w_l, h_l = float(spec.width), float(spec.height)
    u = (key.coords[:, 0] - w_l * 0.5) / w_l
    v = (key.coords[:, 1] - h_l * 0.5) / w_l
    return u.contiguous(), v.contiguous()


def warp_rel_positions_h(p, u, v, width: int, height: int, ox, oy,
                         psize: int):
    """Clamped window positions of normalized keypoints (u, v) (..., N)
    under homographies ``p`` (..., 8) that the caller broadcast
    (homography_aligner.py:116-123)."""
    w_l, h_l = float(width), float(height)
    wp = Hm.warp_norm(p, torch.stack([u, v], -1))
    wx = wp[..., 0] * w_l + w_l * 0.5
    wy = wp[..., 1] * w_l + h_l * 0.5
    return clamp_rel(wx - ox, psize), clamp_rel(wy - oy, psize)


def gn8_solve_plain(windows, key_index, tmpl, jac_masked, hinv, u, v, ox,
                    oy, p_init, *, threshold, width: int, height: int,
                    max_iters: int):
    """Plain PyTorch version of kernel C: the masked XLA loop of
    ``_align_level_h``, batched over items, each with its own threshold."""
    thr = item_thresholds(threshold, p_init.shape[0], p_init.device)
    psize = windows.shape[-1]
    kidx = key_index.to(torch.int64)
    ui, vi = u[kidx], v[kidx]                            # (B, 2, N)
    w_l, h_l = float(width), float(height)
    corners = gn_corners(width, height, windows.device)
    c0 = Hm.warp_points(p_init[:, None, :], corners, w_l, h_l)
    p, prev = p_init, c0
    conv = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    iters = torch.zeros(p.shape[0], dtype=torch.int32, device=p.device)
    for _ in range(max_iters):
        # Each iteration steps only the items still running, as in
        # gn_solve_plain.
        act = torch.nonzero(~conv).flatten()
        if act.numel() == 0:
            break
        rel_x, rel_y = warp_rel_positions_h(p[act][:, None, None, :], ui[act],
                                            vi[act], width, height, ox, oy,
                                            psize)
        warped = sample_windows_flat(windows, rel_x, rel_y,
                                     key_index=kidx[act])
        residual = tmpl[act] - warped
        bvec = (jac_masked[act] * residual[:, None]).sum(dim=(2, 3))
        dt = (hinv[act] * bvec[:, None, :]).sum(dim=-1)           # (b, 8)
        p_new = Hm.compose(dt, p[act])
        new_c = Hm.warp_points(p_new[:, None, :], corners, w_l, h_l)
        disp12 = torch.linalg.vector_norm(new_c - prev[act],
                                          dim=-1).amax(dim=-1)
        p = p.index_copy(0, act, p_new)
        prev = prev.index_copy(0, act, new_c)
        iters = iters.index_add(0, act, torch.ones_like(iters[act]))
        conv = conv.index_copy(0, act, disp12 < thr[act])
    disp01 = torch.linalg.vector_norm(prev - c0, dim=-1).amax(dim=-1)
    return p, conv, disp01, iters


def _check(windows, key_index, tmpl, jac_masked, hinv, u, v, ox, oy, p_init):
    k, n, p, _ = windows.shape
    bsz = p_init.shape[0]
    want = {
        "windows": (windows, (k, n, p, p), torch.uint8),
        "key_index": (key_index, (bsz,), None),
        "tmpl": (tmpl, (bsz, 2, n), torch.float32),
        "jac_masked": (jac_masked, (bsz, 8, 2, n), torch.float32),
        "hinv": (hinv, (bsz, 8, 8), torch.float32),
        "u": (u, (k, 2, n), torch.float32),
        "v": (v, (k, 2, n), torch.float32),
        "ox": (ox, (n,), torch.float32),
        "oy": (oy, (n,), torch.float32),
        "p_init": (p_init, (bsz, 8), torch.float32),
    }
    for name, (x, shape, dtype) in want.items():
        if tuple(x.shape) != shape or (dtype is not None
                                       and x.dtype != dtype):
            raise ValueError(f"{name}: want {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != windows.device:
            raise ValueError(f"{name} is on {x.device}, windows on "
                             f"{windows.device}")


def gn8_solve(windows, key_index, tmpl, jac_masked, hinv, u, v, ox, oy,
              p_init, *, threshold, width: int, height: int,
              max_iters: int):
    """Run one level's whole 8-DOF GN loop for every item.

    Args:
      windows: (K, N, P, P) u8 keyframe sampling windows.
      key_index: (B,) integer keyframe of each item.
      tmpl: (B, 2, N) f32 template intensities.
      jac_masked: (B, 8, 2, N) f32 masked Jacobian rows.
      hinv: (B, 8, 8) f32 regularized inverse Hessians.
      u, v: (K, 2, N) f32 keypoints in centered width-normalized coords.
      ox, oy: (N,) f32 window origins in pixels.
      p_init: (B, 8) f32 initial homographies.
      threshold: the GN corner-move threshold (px), a float or a (B,) f32
        tensor of one per item.
    Returns:
      (p (B, 8) f32, converged (B,) bool, disp01 (B,) f32, iters (B,) i32).
    """
    kwargs = dict(threshold=threshold, width=width, height=height,
                  max_iters=max_iters)
    if windows.device.type == "cpu":
        _check(windows, key_index, tmpl, jac_masked, hinv, u, v, ox, oy,
               p_init)
        return gn8_solve_plain(windows, key_index, tmpl, jac_masked, hinv, u,
                               v, ox, oy, p_init, **kwargs)
    plan = launch_plan(p_init.shape[0], windows.shape[1])
    return gn8_solve_with_plan(plan, windows, key_index, tmpl, jac_masked,
                               hinv, u, v, ox, oy, p_init, **kwargs)


def gn8_solve_with_plan(plan: LaunchPlan, windows, key_index, tmpl,
                        jac_masked, hinv, u, v, ox, oy, p_init, *,
                        threshold, width: int, height: int,
                        max_iters: int):
    """Launch kernel C with a given plan (``gn8_solve`` takes
    ``launch_plan``'s); CUDA tensors only. Raises if the launch is
    refused."""
    _check(windows, key_index, tmpl, jac_masked, hinv, u, v, ox, oy, p_init)
    dev = windows.device
    if dev.type != "cuda":
        raise ValueError(f"kernel C runs on cuda, not {dev}")
    bsz = p_init.shape[0]
    _, n, _, p = windows.shape
    if ((plan.items, plan.n) != (bsz, n) or plan.threads not in THREADS
            or plan.cluster not in CLUSTER_SIZES):
        raise ValueError(f"{plan} does not fit {bsz} items of {n} keypoints")
    args = [windows, key_index.to(torch.int64).contiguous(), tmpl,
            jac_masked, hinv, u, v, ox, oy, p_init,
            item_thresholds(threshold, bsz, dev)]
    if not all(x.is_contiguous() for x in args):
        raise ValueError("gn8_solve needs contiguous operands")
    p_out = torch.empty((bsz, 8), dtype=torch.float32, device=dev)
    conv = torch.empty((bsz,), dtype=torch.bool, device=dev)
    disp01 = torch.empty((bsz,), dtype=torch.float32, device=dev)
    iters = torch.empty((bsz,), dtype=torch.int32, device=dev)
    # The convergence corners in normalized coordinates, formed in double
    # and rounded once, as gn8_solve_pallas forms them.
    w_l, h_l = float(width), float(height)
    cx, cy = w_l * 0.5, h_l * 0.5
    corners = [((x - cx) / w_l, (y - cy) / w_l)
               for x, y in ((0.0, 0.0), (w_l - 1.0, 0.0), (0.0, h_l - 1.0),
                            (w_l - 1.0, h_l - 1.0))]
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [x.data_ptr() for x in args + [p_out, conv, disp01, iters]]
    err = _kernel()(*ptrs, bsz, p, n, w_l, cx, cy, *(c[0] for c in corners),
                    *(c[1] for c in corners), p - 3.0 - 1e-3, max_iters,
                    plan.threads, plan.cluster, plan.slice, plan.cached,
                    stream)
    if err != 0:
        raise RuntimeError(f"gn8_solve kernel launch failed ({plan}): CUDA "
                           f"error {err}")
    gn8_solve.launches += 1
    return p_out, conv, disp01, iters


@functools.cache
def _kernel():
    """``vs_gn8_solve`` of the built ``csrc/gn8_solve.cu``, typed."""
    fn = cuda_build.load("gn8_solve").vs_gn8_solve
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 12 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    return fn


gn8_solve.launches = 0
