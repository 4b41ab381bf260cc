"""Select's warp-diff prelude of one pyramid level for B items: the
template intensities at each keyframe tile's argmax, the warp diffs at the
incoming transform, the keep-mask (the histogram threshold, or the exact
count), the masked Jacobian and the Gauss-Newton Hessian. Kernel J of the
port.

``level_prelude_kernel`` launches ``csrc/prelude.cu`` for CUDA tensors: one
launch a level for all items, either model, either selection: the
histogram mask with the keep fraction one value or one per item, or the
exact count of ``selection="topk"`` (its count static, as the JAX
package's). It replaces the JAX package's XLA stages
``video_stabilizer_tpu/models/aligner.py:316-345`` (inside ``_align_level``)
and ``video_stabilizer_tpu/models/homography_aligner.py:130-149`` (inside
``_align_level_h``), not a Pallas kernel; it was added because a profile of
the un-captured 1080p chunk on an H100 put select's several dozen eager
kernels a level (the tap gather, the Lanczos2 weights, the histogram, the
Hessian's product) among the largest device stages left. See the source
note in ``csrc/prelude.cu`` for the bound and the design.

``level_prelude_plain`` is the same computation in plain PyTorch: the CPU
path and the card's reference, never the main path on a card.
``level_prelude`` dispatches by device. The regularized inverse of the
Hessian stays kernel E's (``ops/linalg.py``), a launch of its own.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from video_stabilizer_tpu_torch import transforms as T
from video_stabilizer_tpu_torch.ops import cuda_build
from video_stabilizer_tpu_torch.ops.argmax import tile_argmax_flat_index
from video_stabilizer_tpu_torch.ops.gn8_solve import (
    normalized_keypoints, warp_rel_positions_h)
from video_stabilizer_tpu_torch.ops.gn_solve import CLUSTER_SIZES
from video_stabilizer_tpu_torch.ops.keyframe import (
    jacobian_rows, kernel_scalars)
from video_stabilizer_tpu_torch.ops.patches import (
    sample_windows_flat, warp_rel_positions_flat, window_origins_flat)
from video_stabilizer_tpu_torch.ops.select import (
    histogram_mask, topk_count, topk_mask)

# Launch shape of csrc/prelude.cu: a block of THREADS threads; per item a
# cluster of 1-8 CTAs, doubled while a level's CTAs number under
# TARGET_CTAS (about two an SM of the H100's 132) and each CTA keeps at
# least MIN_SLICE keypoints (the histogram merge, the scans and the
# barriers cost a CTA the same whatever its slice holds). On the H100 this
# plan was the fastest cluster size, or within a few % of it, at every
# level of the 1080p and 4K chunks (PERF.md, kernel J: 2 CTAs an item at
# every 1080p level, 8 at 4K down to N = 1296, 4 at N = 480). The
# kernel's outputs are the same bytes under every plan. The exact-count
# mode keeps 4 bytes an entry where the histogram mode keeps 2, and its
# plan also doubles the cluster while a CTA's slice passes
# EXACT_MAX_SLICE, so that its dynamic shared memory (8 x slice bytes)
# with its static ~22 KB stays under the 48 KB a kernel takes without
# raising its limit, and 4 CTAs still fit an SM (G1's 864 items of N =
# 5184 take 2 CTAs an item there, 1 in the histogram mode: on the H100
# that level read 0.409 ms, against 0.458 at 1 CTA an item, whose 41 KB of
# entries leave 3 CTAs an SM).
THREADS = 256
TARGET_CTAS = 256
MIN_SLICE = 100
EXACT_MAX_SLICE = 3072


class LaunchPlan(NamedTuple):
    """Kernel J's launch of ``items`` items of ``n`` keypoints: ``cluster``
    CTAs an item, CTA r taking keypoints [r * slice, (r + 1) * slice) of
    [0, n) in both sets, their bins (or, in the ``exact``-count mode, their
    warp diffs) in ``smem`` bytes of dynamic shared memory."""
    items: int
    n: int
    cluster: int
    slice: int
    exact: bool = False

    @property
    def smem(self) -> int:
        return 2 * (4 if self.exact else 2) * self.slice

    def slices(self):
        """[lo, hi) of each CTA of a cluster, as the kernel forms them."""
        return [(min(r * self.slice, self.n),
                 min((r + 1) * self.slice, self.n))
                for r in range(self.cluster)]


def launch_plan(items: int, n: int, cluster: int | None = None,
                exact: bool = False) -> LaunchPlan:
    """Kernel J's plan (a pure function): ``cluster`` CTAs an item if
    given, else 1 doubled (up to 8) while ``items`` x cluster < TARGET_CTAS
    and a CTA of the doubled cluster would keep MIN_SLICE keypoints, and in
    the ``exact``-count mode also while a CTA keeps over EXACT_MAX_SLICE."""
    if cluster is None:
        cluster = 1
        while cluster < CLUSTER_SIZES[-1] and (
                (items * cluster < TARGET_CTAS
                 and -(-n // (2 * cluster)) >= MIN_SLICE)
                or (exact and -(-n // cluster) > EXACT_MAX_SLICE)):
            cluster *= 2
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster size {cluster} not in {CLUSTER_SIZES}")
    return LaunchPlan(items, n, cluster, max(-(-n // cluster), 1), exact)


def template_intensities(spec, key, key_index, templates, template_index):
    """(B, 2, N) f32 template intensities at each item's keyframe argmax
    pixels; ``templates`` (M, h, w) u8, picked by ``template_index``."""
    w, h = spec.width, spec.height
    n = spec.ht * spec.wt
    bsz = key_index.shape[0]
    idx = torch.stack([key.idx_x, key.idx_y], dim=1)[key_index]
    pos = tile_argmax_flat_index(idx, w, spec.tile).reshape(bsz, 2 * n)
    flat_tmpl = templates.reshape(templates.shape[0], h * w)
    tmpl = flat_tmpl[template_index[:, None], pos].reshape(bsz, 2, n)
    return tmpl.to(torch.float32)


def selection_mask(wd, params, fraction=None):
    """The smallest-fraction keypoints of each (item, set) row of ``wd``
    (B, 2, N) as a 0/1 mask, by ``params.selection`` (aligner.py:203-213):
    the histogram threshold ("mask") with ``fraction`` (a float, a 0-d or a
    (B,) tensor; ``params.smallest_fraction`` if None), or the exact count
    ("topk"), whose count is static: it always takes
    ``params.smallest_fraction``, as the JAX package's does."""
    if params.selection == "topk":
        return topk_mask(wd, params.smallest_fraction)
    if fraction is None:
        fraction = params.smallest_fraction
    if isinstance(fraction, torch.Tensor) and fraction.dim() == 1:
        fraction = fraction[:, None]
    return histogram_mask(wd, fraction)


def level_prelude(spec, key, key_index, templates, template_index, transform,
                  params, fraction=None, model: str = "similarity"):
    """Everything of one level before the GN loop, at the incoming
    transform, for B items (see ``level_prelude_plain``). CPU tensors take
    the plain version; any other tensors take kernel J, either selection,
    which raises on what it does not take."""
    if key.windows.device.type == "cpu":
        return level_prelude_plain(spec, key, key_index, templates,
                                   template_index, transform, params,
                                   fraction, model)
    return level_prelude_kernel(spec, key, key_index, templates,
                                template_index, transform, params, fraction,
                                model)


def level_prelude_plain(spec, key, key_index, templates, template_index,
                        transform, params, fraction=None,
                        model: str = "similarity", return_wd: bool = False):
    """Select's prelude in plain PyTorch (aligner.py:316-345,
    homography_aligner.py:130-149): template intensities, warp-diff
    selection at the incoming transform (similarity: (B, 4) centre-pivot,
    centre convention W*0.5, alignment.cpp:409-431; homography: (B, 8)
    normalized), with ``fraction`` as ``selection_mask`` takes it, and the
    Hessian over both selected sets.

    Args:
      key: a level's ``LevelKeyData`` of K keyframes; ``key_index`` (B,)
        picks each item's.
      templates: (M, h, w) u8; ``template_index`` (B,) picks each item's.
    Returns (tmpl (B, 2, N), jac_masked (B, R, 2, N), hess (B, R, R)),
    R = 4 or 8, f32; the similarity's jac_masked has the ICA X/Y-set
    average (0.5) folded in, its Hessian not. With ``return_wd`` also the
    warp diffs wd (B, 2, N).
    """
    rows = jacobian_rows(model)
    w, h = spec.width, spec.height
    p = key.windows.shape[-1]
    tmpl = template_intensities(spec, key, key_index, templates,
                                template_index)
    jac = key.jac[key_index]                                  # (B, R, 2, N)
    ox, oy = window_origins_flat(spec.ht, spec.wt, spec.tile, spec.margin,
                                 device=transform.device)
    if rows == 4:
        t_ul0 = T.center_to_ul(transform, w, h)[:, None, None, :]
        rel_x0, rel_y0 = warp_rel_positions_flat(
            key.coords[key_index, 0], key.coords[key_index, 1], t_ul0, ox,
            oy, p)
    else:
        u, v = normalized_keypoints(key, spec)
        rel_x0, rel_y0 = warp_rel_positions_h(
            transform[:, None, None, :], u[key_index], v[key_index], w, h,
            ox, oy, p)
    wd = torch.abs(sample_windows_flat(key.windows, rel_x0, rel_y0,
                                       key_index=key_index) - tmpl)
    mask = selection_mask(wd, params, fraction)               # (B, 2, N)
    jm = jac * mask[:, None]
    hess = (jm[:, :, None] * jac[:, None, :]).sum(dim=(3, 4))   # (B, R, R)
    jac_masked = jac * (mask * 0.5)[:, None] if rows == 4 else jm
    out = (tmpl, jac_masked.contiguous(), hess.contiguous())
    return out + (wd,) if return_wd else out


class _PreludeArgs(ctypes.Structure):
    """``PreludeArgs`` of csrc/prelude.cu: one level's launch."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "windows", "coords", "jac", "idx_x", "idx_y", "key_index",
        "templates")]
        + [("tstride", ctypes.c_longlong)]
        + [(name, ctypes.c_void_p) for name in (
            "template_index", "transform", "fraction")]
        + [("fstride", ctypes.c_int), ("fvalue", ctypes.c_float)]
        + [(name, ctypes.c_void_p) for name in (
            "tmpl", "jac_masked", "hess", "wd", "mask")]
        + [(name, ctypes.c_int) for name in (
            "batch", "n", "p", "t", "w", "wt", "margin", "cluster",
            "slice", "exact", "k")]
        + [(name, ctypes.c_float) for name in (
            "cx", "cy", "inv_w", "wf", "rel_hi")])


def _want(name, x, shape, dtype, dev):
    if tuple(x.shape) != tuple(shape) or x.dtype != dtype:
        raise ValueError(f"kernel J: {name} wants {tuple(shape)} {dtype}, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if x.device != dev:
        raise ValueError(f"kernel J: {name} is on {x.device}, the keyframe "
                         f"windows on {dev}")


def _fraction_operand(fraction, items: int, dev):
    """(tensor or None, stride, value) of the keep fraction: a float goes
    by value (as float32), a 0-d tensor by pointer with stride 0 and a
    (items,) tensor with stride 1, read on the device."""
    if not isinstance(fraction, torch.Tensor):
        return None, 0, float(np.float32(fraction))
    f = fraction.to(device=dev, dtype=torch.float32)
    if f.dim() == 0:
        return f, 0, 0.0
    if tuple(f.shape) != (items,):
        raise ValueError(f"kernel J: fraction wants () or ({items},), got "
                         f"{tuple(f.shape)}")
    return f.contiguous(), 1, 0.0


def level_prelude_kernel(spec, key, key_index, templates, template_index,
                         transform, params, fraction=None,
                         model: str = "similarity", return_wd: bool = False,
                         plan: LaunchPlan | None = None,
                         return_mask: bool = False):
    """``level_prelude_plain``'s function on the CUDA card: one launch of
    kernel J (``plan``, ``launch_plan``'s if None, its mode the
    selection's), the histogram mode for ``selection="mask"``, the
    exact-count mode for ``"topk"`` (``fraction`` is then not read: the
    count is ``topk_count(N, params.smallest_fraction)``, capped at N).
    ``return_mask`` (the exact-count mode's debug output) adds the (B, 2,
    N) 0/1 mask after the warp diffs. Raises on another selection, on any
    other device, on a dtype, shape or layout the kernel does not take
    (keyframe fields contiguous, template rows contiguous), on a plan of
    the other mode, and if the launch is refused. Each launch adds one to
    ``level_prelude_kernel.launches``; B = 0 or N = 0 launches nothing (an
    empty level's Hessian is 0)."""
    if params.selection not in ("mask", "topk"):
        raise ValueError(f"kernel J takes selection 'mask' or 'topk', not "
                         f"{params.selection!r}")
    exact = params.selection == "topk"
    if return_mask and not exact:
        raise ValueError("kernel J writes its mask in the exact-count mode "
                         "only")
    rows = jacobian_rows(model)
    dev = key.windows.device
    keys, p = key.windows.shape[0], key.windows.shape[-1]
    n = spec.ht * spec.wt
    bsz = transform.shape[0]
    if plan is not None and (plan.items, plan.n, plan.exact) != (
            bsz, n, exact):
        raise ValueError(f"kernel J: {plan} does not fit {bsz} items of {n} "
                         f"keypoints, selection {params.selection!r}")
    if p != spec.tile + 2 * spec.margin:
        raise ValueError(f"kernel J: windows of {p} for tile {spec.tile}, "
                         f"margin {spec.margin}")
    _want("windows", key.windows, (keys, n, p, p), torch.uint8, dev)
    _want("coords", key.coords, (keys, 2, 2, n), torch.float32, dev)
    _want("jac", key.jac, (keys, rows, 2, n), torch.float32, dev)
    _want("idx_x", key.idx_x, (keys, spec.ht, spec.wt), torch.int32, dev)
    _want("idx_y", key.idx_y, (keys, spec.ht, spec.wt), torch.int32, dev)
    _want("transform", transform, (bsz, rows), torch.float32, dev)
    if not all(f.is_contiguous() for f in key):
        raise ValueError("kernel J takes contiguous keyframe fields")
    frames = templates.shape[0] if templates.dim() == 3 else -1
    _want("templates", templates, (frames, spec.height, spec.width),
          torch.uint8, dev)
    h, w = spec.height, spec.width
    if (w > 1 and templates.stride(2) != 1) or (h > 1
                                                and templates.stride(1) != w):
        raise ValueError(f"kernel J takes templates with contiguous rows, "
                         f"not strides {templates.stride()}")
    if dev.type != "cuda":
        raise ValueError(f"kernel J runs on cuda, not {dev}")
    kidx = key_index.to(torch.int64).contiguous()
    tidx = template_index.to(torch.int64).contiguous()
    _want("key_index", kidx, (bsz,), torch.int64, dev)
    _want("template_index", tidx, (bsz,), torch.int64, dev)
    if exact:
        frac, fstride, fvalue = None, 0, 0.0
        k = min(topk_count(n, params.smallest_fraction), n)
    else:
        if fraction is None:
            fraction = params.smallest_fraction
        frac, fstride, fvalue = _fraction_operand(fraction, bsz, dev)
        k = 0
    transform = transform.contiguous()

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    tmpl, jac_masked = empty(bsz, 2, n), empty(bsz, rows, 2, n)
    wd = empty(bsz, 2, n) if return_wd else None
    mask = empty(bsz, 2, n) if return_mask else None
    debug = tuple(x for x in (wd, mask) if x is not None)
    if bsz == 0 or n == 0:
        hess = torch.zeros((bsz, rows, rows), dtype=torch.float32,
                           device=dev)
        return (tmpl, jac_masked, hess) + debug
    hess = empty(bsz, rows, rows)
    plan = plan or launch_plan(bsz, n, exact=exact)
    cx, cy, _, inv_w, wf = kernel_scalars(spec)
    ptr = (lambda x: None if x is None else x.data_ptr())
    args = _PreludeArgs(
        key.windows.data_ptr(), key.coords.data_ptr(), key.jac.data_ptr(),
        key.idx_x.data_ptr(), key.idx_y.data_ptr(), kidx.data_ptr(),
        templates.data_ptr(),
        templates.stride(0) if frames > 1 else h * w,
        tidx.data_ptr(), transform.data_ptr(), ptr(frac), fstride, fvalue,
        tmpl.data_ptr(), jac_masked.data_ptr(), hess.data_ptr(), ptr(wd),
        ptr(mask), bsz, n, p, spec.tile, w, spec.wt, spec.margin,
        plan.cluster, plan.slice, int(exact), k, cx, cy, inv_w, wf,
        p - 3.0 - 1e-3)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(ctypes.byref(args), int(rows == 8), stream)
    if err != 0:
        raise RuntimeError(f"prelude kernel launch failed ({plan}, {model}, "
                           f"P {p}): CUDA error {err}")
    level_prelude_kernel.launches += 1
    return (tmpl, jac_masked, hess) + debug


def kernel_attributes(slice_: int, exact: bool = False):
    """((registers a thread of the 4x4 form, of the 8x8 form), (their
    static shared memory bytes), (CTAs of THREADS threads an SM of each at
    ``slice_`` keypoints a CTA)) of the histogram or the ``exact``-count
    mode, as the card reports them (``cudaFuncGetAttributes``, the
    occupancy API)."""
    regs, smem, ctas = ((ctypes.c_int * 2)() for _ in range(3))
    fn = cuda_build.load("prelude").vs_prelude_attributes
    fn.restype = ctypes.c_int
    err = fn(ctypes.c_int(slice_), ctypes.c_int(int(exact)), regs, smem,
             ctas)
    if err != 0:
        raise RuntimeError(f"kernel J's attributes: CUDA error {err}")
    return tuple(regs), tuple(smem), tuple(ctas)


@functools.cache
def _kernel():
    """``vs_level_prelude`` of the built ``csrc/prelude.cu``, typed."""
    fn = cuda_build.load("prelude").vs_level_prelude
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_PreludeArgs), ctypes.c_int,
                   ctypes.c_void_p]
    return fn


level_prelude_kernel.launches = 0
