"""Kernel F's plain version (``ops/accum.py::accum_scan_plain``) on the
scan's (B, T, P) layout, held to the accumulator loops the call sites ran
before (bit for bit) and to the JAX package's ``accumulate_corrections`` /
``accumulate_corrections_h`` on the CPU; and the dispatch around the
kernel. The kernel itself runs only on the card (``chip_smoke.py`` phase
E), where it is held to the plain version bit for bit."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilizer_tpu import config as jcfg
from video_stabilizer_tpu.models.batch import (
    accumulate_corrections as jax_accumulate)
from video_stabilizer_tpu.models.homography_aligner import (
    accumulate_corrections_h as jax_accumulate_h)
from video_stabilizer_tpu_torch.config import StabilizerParams
from video_stabilizer_tpu_torch.models import batch
from video_stabilizer_tpu_torch.ops.accum import (
    accum_scan, accum_scan_kernel, accum_scan_plain, corner_consts,
    fold_jitter)

torch.set_num_threads(1)

WIDTH, HEIGHT = 320, 240
# The smoother sweep's decay rows (apps/grid_search_smoother.py) and one
# whose span 48 - 13 = 35 has no exact float32 reciprocal.
DECAYS = ((48.0, 64.0, 0.9, 0.7), (32.0, 48.0, 0.95, 0.8),
          (13.0, 48.0, 0.85, 0.6))


def measurements(rng, lead, steps, model):
    """Seeded (lead..., T, P) float32 measurements whose accumulator
    crosses min_disp and max_disp: similarity A, B ~ 1e-2, TX, TY ~ 12 px;
    homography p2, p5 the same in width units, p6, p7 ~ 2e-5."""
    shape = tuple(lead) + (steps,)
    if model == "similarity":
        cols = [rng.normal(0, 1e-2, shape), rng.normal(0, 1e-2, shape),
                rng.normal(0, 12, shape), rng.normal(0, 12, shape)]
    else:
        lin = [rng.normal(0, 5e-3, shape) for _ in range(4)]
        cols = [lin[0], lin[1], rng.normal(0, 12, shape) / WIDTH, lin[2],
                lin[3], rng.normal(0, 12, shape) / WIDTH,
                rng.normal(0, 2e-5, shape), rng.normal(0, 2e-5, shape)]
    return np.stack(cols, -1).astype(np.float32)


def failures(rng, lead, steps):
    """(lead..., T) success with failures in the middle of the sequence."""
    ok = rng.random(tuple(lead) + (steps,)) > 0.15
    ok[..., steps // 2] = False
    return ok


def bits(x):
    return x.contiguous().view(torch.int32)


def old_chunk_loop(accum, meas_m, smoothed, succ, m_valid, params, model):
    """models/chunked.py's accumulator loop before kernel F."""
    accums = []
    for j in range(meas_m.shape[1]):
        accum = torch.where(succ[:, j, None], accum, torch.zeros_like(accum))
        folded = fold_jitter(accum, meas_m[:, j], smoothed[:, j], params,
                             WIDTH, HEIGHT, model)
        accum = torch.where(m_valid[:, j, None], folded, accum)
        accums.append(accum)
    return torch.stack(accums, dim=1), accum


def old_clip_loop(meas, success, smoothed, params, model, decay=None):
    """models/batch.py::accumulate_corrections before kernel F."""
    lead, (t_total, npar) = meas.shape[:-2], meas.shape[-2:]
    lag = params.lag
    offset = lag - params.smoother_memory
    accum = meas.new_zeros(lead + (npar,))
    accums = [meas.new_zeros(lead + (0, npar))]
    for i in range(t_total):
        accum = torch.where(success[..., i, None], accum,
                            torch.zeros_like(accum))
        m = i - lag
        if m >= 0:
            sm = smoothed[..., min(m + offset, smoothed.shape[-2] - 1), :] \
                if params.enable_smoother else None
            accum = fold_jitter(accum, meas[..., m, :], sm, params, WIDTH,
                                HEIGHT, model, decay)
            accums.append(accum[..., None, :])
    return torch.cat(accums, dim=-2)


@pytest.mark.parametrize("model", ["similarity", "homography"])
@pytest.mark.parametrize("smoother", [True, False])
def test_chunk_layout_matches_old_loop(model, smoother):
    """The chunk's call (carried accumulator, invalid leading steps of a
    fresh stream, failures mid-chunk) equals the old loop bit for bit."""
    rng = np.random.default_rng(21)
    params = StabilizerParams(enable_smoother=smoother)
    s, tc = 3, 16
    meas = torch.from_numpy(measurements(rng, (s,), tc, model))
    smoothed = torch.from_numpy(measurements(rng, (s,), tc, model))
    succ = torch.from_numpy(failures(rng, (s,), tc))
    seen = torch.tensor([0, 6, 32])
    m_valid = seen[:, None] + torch.arange(tc)[None] - params.lag >= 0
    accum0 = torch.from_numpy(measurements(rng, (s,), 1, model)[:, 0])
    want, want_last = old_chunk_loop(accum0, meas, smoothed, succ, m_valid,
                                     params, model)
    got, last = accum_scan_plain(accum0, meas, smoothed if smoother else None,
                                 succ, m_valid, params, WIDTH, HEIGHT, model)
    assert not bool(m_valid[0, :params.lag].any())
    assert torch.equal(bits(got), bits(want))
    assert torch.equal(bits(last), bits(want_last))


@pytest.mark.parametrize("model", ["similarity", "homography"])
@pytest.mark.parametrize("case", ["smoother", "no smoother", "decay per combo",
                                  "memory > lag"])
def test_clip_layout_matches_old_loop(model, case):
    """``accumulate_corrections`` on the scan's layout (its steps from
    ``lag`` on, the smoothed rows through the cached index) equals the old
    loop bit for bit: on streams, the smoother off (smoothed = meas, as
    grid_search_align passes it), one decay row per combo, and memory >
    lag (a negative smoothed index counts from the end)."""
    rng = np.random.default_rng(22)
    params = StabilizerParams(enable_smoother=case != "no smoother")
    decay = None
    lead = (2,)
    if case == "decay per combo":
        decay = torch.tensor(DECAYS)
        lead = (len(DECAYS),)
    if case == "memory > lag":
        params = StabilizerParams(lag=3, smoother_memory=5)
    t = 32
    meas = torch.from_numpy(measurements(rng, lead, t, model))
    succ = torch.from_numpy(failures(rng, lead, t))
    smoothed = (torch.from_numpy(measurements(
        rng, lead, t - params.smoother_memory, model))
        if params.enable_smoother else meas)
    want = old_clip_loop(meas, succ, smoothed, params, model, decay)
    got = batch.accumulate_corrections(meas, succ, smoothed, params, WIDTH,
                                       HEIGHT, model, decay)
    assert got.shape == lead + (t - params.lag, meas.shape[-1])
    assert torch.equal(bits(got), bits(want))


# The port against JAX: a parameter's gap over its largest |value| in the
# sequence (test_plain_matches_jax says why).
JAX_BAR = 3e-5


def _jax_params(params, decay=None):
    fields = dict(lag=params.lag, smoother_memory=params.smoother_memory,
                  enable_smoother=params.enable_smoother)
    if decay is not None:
        fields.update(zip(("min_disp", "max_disp", "min_decay", "max_decay"),
                          decay))
    return jcfg.StabilizerParams(**fields)


@pytest.mark.parametrize("model,smoother", [
    ("similarity", True), ("similarity", False), ("homography", True),
    ("homography", False)])
def test_plain_matches_jax(model, smoother):
    """Against the JAX package's scan on the same seeded measurements with
    failures. Bar, per parameter: within 3e-5 of the parameter's largest
    |value| over the sequence. Measured: at most 1.7e-5, in A, p0 and p4,
    which the fold forms as (1 + A) - 1 and so carry float32's absolute
    rounding of 1 (1.2e-7) on values of about 0.01; 1e-6 or less in the
    other parameters. XLA on the CPU fuses the fold and may contract a
    product and a sum into one rounding where torch rounds twice."""
    rng = np.random.default_rng(23)
    params = StabilizerParams(enable_smoother=smoother)
    t = 40
    meas = measurements(rng, (), t, model)
    succ = failures(rng, (), t)
    smoothed = measurements(rng, (), t - params.smoother_memory, model)
    got = batch.accumulate_corrections(
        torch.from_numpy(meas), torch.from_numpy(succ),
        torch.from_numpy(smoothed), params, WIDTH, HEIGHT, model).numpy()
    jfn = jax_accumulate if model == "similarity" else jax_accumulate_h
    want = np.asarray(jfn(jnp.asarray(meas), jnp.asarray(succ),
                          jnp.asarray(smoothed), _jax_params(params), WIDTH,
                          HEIGHT))
    assert got.shape == want.shape
    scale = np.abs(want).max(axis=-2, keepdims=True)
    assert np.all(np.abs(got - want) <= JAX_BAR * scale)


def test_decay_per_combo_matches_jax():
    """The smoother sweep's per-combo decay rows against JAX run once per
    combo with those values in its params; bar as above."""
    rng = np.random.default_rng(24)
    params = StabilizerParams()
    t = 40
    meas = measurements(rng, (), t, "similarity")
    succ = failures(rng, (), t)
    smoothed = measurements(rng, (len(DECAYS),), t - params.smoother_memory,
                            "similarity")
    c = len(DECAYS)
    got = batch.accumulate_corrections(
        torch.from_numpy(meas).expand(c, t, 4),
        torch.from_numpy(succ).expand(c, t), torch.from_numpy(smoothed),
        params, WIDTH, HEIGHT, decay=torch.tensor(DECAYS)).numpy()
    for k, row in enumerate(DECAYS):
        want = np.asarray(jax_accumulate(
            jnp.asarray(meas), jnp.asarray(succ), jnp.asarray(smoothed[k]),
            _jax_params(params, row), WIDTH, HEIGHT))
        scale = np.abs(want).max(axis=-2, keepdims=True)
        assert np.all(np.abs(got[k] - want) <= JAX_BAR * scale), row


def test_dispatch_by_device():
    """A CPU tensor takes the plain version and launches nothing; the
    kernel's wrapper refuses a non-float32 tensor and any device but the
    card: no fallback to the plain version."""
    rng = np.random.default_rng(25)
    params = dataclasses.replace(StabilizerParams(), lag=2)
    meas = torch.from_numpy(measurements(rng, (2,), 6, "similarity"))
    succ = torch.from_numpy(failures(rng, (2,), 6))
    accum0 = torch.zeros(2, 4)
    before = accum_scan_kernel.launches
    got = accum_scan(accum0, meas, meas, succ, None, params, WIDTH, HEIGHT)
    want = accum_scan_plain(accum0, meas, meas, succ, None, params, WIDTH,
                            HEIGHT)
    assert all(torch.equal(bits(g), bits(w)) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="kernel F takes float32 meas"):
        accum_scan_kernel(accum0, meas.double(), meas, succ, None, params,
                          WIDTH, HEIGHT)
    with pytest.raises(ValueError, match="kernel F runs on cuda"):
        accum_scan_kernel(accum0, meas, meas, succ, None, params, WIDTH,
                          HEIGHT)
    with pytest.raises(ValueError, match="kernel F runs on cuda"):
        accum_scan(accum0.to("meta"), meas.to("meta"), meas.to("meta"),
                   succ.to("meta"), None, params, WIDTH, HEIGHT)
    assert accum_scan_kernel.launches == before


def test_corner_consts_are_torchs_operands():
    """Kernel F's corner constants are the float32 values the plain
    version's scalar operands take: the homography's width-normalized
    corners as ``full_like(x - cx) * (1 / w)`` computes them, the
    similarity's corner offsets, the corners and the centre."""
    w, h = 1920, 1080
    for model in ("similarity", "homography"):
        k = np.array(corner_consts(model, w, h, (48.0, 64.0, 0.9, 0.7)),
                     np.float32)
        for c, (x, y) in enumerate(((0.0, 0.0), (w, 0.0), (0.0, h), (w, h))):
            if model == "similarity":
                want = [x - w * 0.5, y - h * 0.5]
            else:
                one = torch.zeros(1)
                want = [float(torch.full_like(one, x - w * 0.5) * (1.0 / w)),
                        float(torch.full_like(one, y - h * 0.5) * (1.0 / w))]
            assert [k[c], k[4 + c], k[8 + c], k[12 + c]] == [
                np.float32(v) for v in want + [x, y]]
        assert list(k[16:]) == [np.float32(v) for v in (
            w, w * 0.5, h * 0.5, 48.0, 64.0, 0.9, 0.7, 16.0, 1 / 16)]
