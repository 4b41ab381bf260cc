"""Per-level 4-DOF Gauss-Newton solve: kernel B of the port.

``gn_solve`` launches ``csrc/gn_solve.cu`` for CUDA tensors and runs
``gn_solve_plain`` for CPU tensors. It replaces
``video_stabilizer_tpu/ops/pallas_gn.py::_gn_kernel`` (with ``_tap_sample``),
batched over items on a leading axis: an item is one alignment at one level,
and it names the keyframe whose windows and keypoints it samples through
``key_index``, so keyframes shared by several items are stored once. See the
source note in ``csrc/gn_solve.cu`` for the bound and the design. Each item
runs on a thread-block cluster that splits its N keypoints;
``launch_plan`` picks the cluster size. The convergence threshold is one
value per item (``item_thresholds``), as the Pallas kernel's traced
threshold is under vmap over the aligner's traced parameters, so a
parameter sweep runs all its combos in one launch per level.

The plain version loops in Python with one host sync per iteration; it is
the CPU path and the card's reference, never the main path on a card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from video_stabilizer_tpu_torch import transforms as T
from video_stabilizer_tpu_torch.ops import cuda_build
from video_stabilizer_tpu_torch.ops.patches import (
    sample_windows_flat, warp_rel_positions_flat)


# Float32 operations of csrc/gn_solve.cu per keypoint, set and iteration
# (each add, multiply, min, max, abs, floor and bf16 rounding counted once):
# the warped position (10), its clamp and floor (8), eight Lanczos2 weights
# (8 x 16), their normalizer (7), the 4x4 taps of bf16 products (100), the
# residual (2) and the four terms of b (8).
OPS_PER_SAMPLE = 263

# Launch shapes of csrc/gn_solve.cu and csrc/gn8_solve.cu on an H100.
SMEM_LIMIT = 232_448   # dynamic shared memory a block may opt into
CACHE_BYTES = 98_304   # operand cache per CTA: two CTAs still fit on an SM
CLUSTER_SIZES = (1, 2, 4, 8)   # the portable cluster sizes
# Floats of csrc/gn_solve.cu's operand cache per keypoint (CACHE_FLOATS):
# ox, oy, and per set fx, fy, template and 4 Jacobian rows.
CACHE_FLOATS = 16
THREADS = (256,)       # the block sizes csrc/gn_solve.cu is built for


class LaunchPlan(NamedTuple):
    """How a GN kernel launch spreads ``items`` items of ``n`` keypoints:
    ``cluster`` CTAs of ``threads`` threads per item, CTA r of a cluster
    walking keypoints [r * slice, (r + 1) * slice) of [0, n), the first
    ``cached`` of them kept in ``smem`` bytes of dynamic shared memory."""
    items: int
    n: int
    cluster: int
    threads: int
    slice: int
    cached: int
    smem: int

    @property
    def grid(self) -> int:
        return self.items * self.cluster

    def slices(self):
        """[lo, hi) of each CTA of a cluster, as the kernel forms them."""
        return [(min(r * self.slice, self.n),
                 min((r + 1) * self.slice, self.n))
                for r in range(self.cluster)]


def make_plan(items: int, n: int, cluster: int, threads: int,
              cache_floats: int) -> LaunchPlan:
    """The plan of one cluster and block size: even slices, and as much of
    each slice's operands cached as CACHE_BYTES holds."""
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster size {cluster} not in {CLUSTER_SIZES}")
    size = -(-n // cluster)
    cached = min(size, CACHE_BYTES // (4 * cache_floats))
    return LaunchPlan(items, n, cluster, threads, size, cached,
                      cached * 4 * cache_floats)


def launch_plan(items: int, n: int) -> LaunchPlan:
    """Kernel B's plan for ``items`` items of ``n`` keypoints (a pure
    function; the measurements behind it are in PERF.md): the fewest CTAs
    per item, up to 8, that leave each at most 512 keypoints, of 256
    threads."""
    cluster = next((c for c in CLUSTER_SIZES if -(-n // c) <= 512), 8)
    return make_plan(items, n, cluster, THREADS[0], CACHE_FLOATS)


def gn_corners(width: int, height: int, device=None):
    """The GN convergence corners use the (w-1, h-1) extent
    (alignment.cpp:590-593)."""
    w, h = width - 1.0, height - 1.0
    return torch.tensor([[0.0, 0.0], [w, 0.0], [0.0, h], [w, h]],
                        dtype=torch.float32, device=device)


def item_thresholds(threshold, items: int, device) -> torch.Tensor:
    """The (items,) f32 convergence thresholds of a GN launch: a float or
    a 0-d tensor broadcasts to every item; a (items,) tensor gives each
    item its own."""
    if not isinstance(threshold, torch.Tensor):
        # A fill on the device, not a copy from the host: a copy from
        # pageable host memory waits for the stream.
        return torch.full((items,), float(threshold), dtype=torch.float32,
                          device=device)
    thr = threshold.to(device=device, dtype=torch.float32)
    if thr.dim() == 0:
        return thr.expand(items).contiguous()
    if tuple(thr.shape) != (items,):
        raise ValueError(f"threshold: want () or ({items},), got "
                         f"{tuple(thr.shape)}")
    return thr.contiguous()


def gn_solve_plain(windows, key_index, tmpl, jac_masked, hinv, fx, fy, ox,
                   oy, t_init, *, threshold, width: int, height: int,
                   max_iters: int, fixed_iters: int = -1):
    """Plain PyTorch version of kernel B: the masked loop of
    ``models/aligner.py::_align_level`` (aligner.py:409-452), batched, with
    each item's own threshold (``item_thresholds``); with ``fixed_iters >=
    0`` its fixed-iteration form (aligner.py:387-407): exactly that many
    steps for every item, converged = the last step moved no corner by the
    threshold (true with no step), iters = fixed_iters."""
    fixed = fixed_iters >= 0
    thr = item_thresholds(threshold, t_init.shape[0], t_init.device)
    p = windows.shape[-1]
    kidx = key_index.to(torch.int64)
    fxi, fyi = fx[kidx], fy[kidx]                       # (B, 2, N)
    cx, cy = width * 0.5, height * 0.5
    jac_scale = torch.tensor(1.0 / width, dtype=torch.float32)
    corners = gn_corners(width, height, windows.device)
    c0 = T.warp_points_center(t_init[:, None, :], corners, cx, cy)
    t, prev = t_init, c0
    conv = (0.0 < thr) if fixed else torch.zeros_like(thr, dtype=torch.bool)
    iters = torch.zeros(t.shape[0], dtype=torch.int32, device=t.device)
    every = torch.arange(t.shape[0], device=t.device)
    for _ in range(fixed_iters if fixed else max_iters):
        # Each iteration steps only the items still running; each item's
        # arithmetic is its own, so its bits do not depend on the others.
        act = every if fixed else torch.nonzero(~conv).flatten()
        if act.numel() == 0:
            break
        t_ul = T.center_to_ul(t[act], width, height)[:, None, None, :]
        rel_x, rel_y = warp_rel_positions_flat(fxi[act], fyi[act], t_ul, ox,
                                               oy, p)
        warped = sample_windows_flat(windows, rel_x, rel_y,
                                     key_index=kidx[act])
        residual = tmpl[act] - warped
        bvec = (jac_masked[act] * residual[:, None]).sum(dim=(2, 3))
        dt = (hinv[act] * bvec[:, None, :]).sum(dim=-1)           # (b, 4)
        delta = torch.stack([dt[:, 0] * jac_scale.to(dt.device),
                             dt[:, 1] * jac_scale.to(dt.device),
                             dt[:, 2], dt[:, 3]], dim=-1)
        t_new = T.compose(delta, t[act])      # delta first (alignment.cpp:639)
        new_c = T.warp_points_center(t_new[:, None, :], corners, cx, cy)
        disp12 = torch.linalg.vector_norm(new_c - prev[act],
                                          dim=-1).amax(dim=-1)
        t = t.index_copy(0, act, t_new)
        prev = prev.index_copy(0, act, new_c)
        iters = iters.index_add(0, act, torch.ones_like(iters[act]))
        conv = conv.index_copy(0, act, disp12 < thr[act])
    disp01 = torch.linalg.vector_norm(prev - c0, dim=-1).amax(dim=-1)
    return t, conv, disp01, iters


def _check(windows, key_index, tmpl, jac_masked, hinv, fx, fy, ox, oy,
           t_init):
    k, n, p, _ = windows.shape
    bsz = t_init.shape[0]
    want = {
        "windows": (windows, (k, n, p, p), torch.uint8),
        "key_index": (key_index, (bsz,), None),
        "tmpl": (tmpl, (bsz, 2, n), torch.float32),
        "jac_masked": (jac_masked, (bsz, 4, 2, n), torch.float32),
        "hinv": (hinv, (bsz, 4, 4), torch.float32),
        "fx": (fx, (k, 2, n), torch.float32),
        "fy": (fy, (k, 2, n), torch.float32),
        "ox": (ox, (n,), torch.float32),
        "oy": (oy, (n,), torch.float32),
        "t_init": (t_init, (bsz, 4), torch.float32),
    }
    for name, (x, shape, dtype) in want.items():
        if tuple(x.shape) != shape or (dtype is not None
                                       and x.dtype != dtype):
            raise ValueError(f"{name}: want {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != windows.device:
            raise ValueError(f"{name} is on {x.device}, windows on "
                             f"{windows.device}")


def gn_solve(windows, key_index, tmpl, jac_masked, hinv, fx, fy, ox, oy,
             t_init, *, threshold, width: int, height: int,
             max_iters: int, fixed_iters: int = -1):
    """Run one level's whole GN loop for every item: to convergence or
    ``max_iters``, or with ``fixed_iters >= 0`` exactly that many
    iterations (see ``gn_solve_plain``).

    Args:
      windows: (K, N, P, P) u8 keyframe sampling windows.
      key_index: (B,) integer keyframe of each item.
      tmpl: (B, 2, N) f32 template intensities.
      jac_masked: (B, 4, 2, N) f32 masked, set-averaged Jacobian rows.
      hinv: (B, 4, 4) f32 regularized inverse Hessians.
      fx, fy: (K, 2, N) f32 keypoint coordinates.
      ox, oy: (N,) f32 window origins.
      t_init: (B, 4) f32 initial centre-pivot transforms.
      threshold: the GN corner-move threshold (px), a float or a (B,) f32
        tensor of one per item.
    Returns:
      (t (B, 4) f32, converged (B,) bool, disp01 (B,) f32, iters (B,) i32).
    """
    kwargs = dict(threshold=threshold, width=width, height=height,
                  max_iters=max_iters, fixed_iters=fixed_iters)
    if windows.device.type == "cpu":
        _check(windows, key_index, tmpl, jac_masked, hinv, fx, fy, ox, oy,
               t_init)
        return gn_solve_plain(windows, key_index, tmpl, jac_masked, hinv, fx,
                              fy, ox, oy, t_init, **kwargs)
    plan = launch_plan(t_init.shape[0], windows.shape[1])
    return gn_solve_with_plan(plan, windows, key_index, tmpl, jac_masked,
                              hinv, fx, fy, ox, oy, t_init, **kwargs)


def gn_solve_with_plan(plan: LaunchPlan, windows, key_index, tmpl,
                       jac_masked, hinv, fx, fy, ox, oy, t_init, *,
                       threshold, width: int, height: int,
                       max_iters: int, fixed_iters: int = -1):
    """Launch kernel B with a given plan (``gn_solve`` takes
    ``launch_plan``'s); CUDA tensors only. Raises if the launch is
    refused."""
    _check(windows, key_index, tmpl, jac_masked, hinv, fx, fy, ox, oy, t_init)
    dev = windows.device
    if dev.type != "cuda":
        raise ValueError(f"kernel B runs on cuda, not {dev}")
    bsz = t_init.shape[0]
    _, n, _, p = windows.shape
    if ((plan.items, plan.n) != (bsz, n) or plan.threads not in THREADS
            or plan.cluster not in CLUSTER_SIZES):
        raise ValueError(f"{plan} does not fit {bsz} items of {n} keypoints")
    args = [windows, key_index.to(torch.int64).contiguous(), tmpl,
            jac_masked, hinv, fx, fy, ox, oy, t_init,
            item_thresholds(threshold, bsz, dev)]
    if not all(x.is_contiguous() for x in args):
        raise ValueError("gn_solve needs contiguous operands")
    t_out = torch.empty((bsz, 4), dtype=torch.float32, device=dev)
    conv = torch.empty((bsz,), dtype=torch.bool, device=dev)
    disp01 = torch.empty((bsz,), dtype=torch.float32, device=dev)
    iters = torch.empty((bsz,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [x.data_ptr() for x in args + [t_out, conv, disp01, iters]]
    err = _kernel()(*ptrs, bsz, p, n, width * 0.5, height * 0.5,
                    width - 1.0, height - 1.0, 1.0 / width, p - 3.0 - 1e-3,
                    max_iters, fixed_iters, plan.threads, plan.cluster,
                    plan.slice, plan.cached, stream)
    if err != 0:
        raise RuntimeError(f"gn_solve kernel launch failed ({plan}): CUDA "
                           f"error {err}")
    gn_solve.launches += 1
    return t_out, conv, disp01, iters


@functools.cache
def _kernel():
    """``vs_gn_solve`` of the built ``csrc/gn_solve.cu``, typed."""
    fn = cuda_build.load("gn_solve").vs_gn_solve
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    return fn


gn_solve.launches = 0
