"""The port's quality metrics and tracer held to the JAX package on the CPU:
the dense LK flow (``utils/flow.py``) and its median-jitter metric on the
device, the cv2 Farneback metric (``utils/jitter.py``) and its cv2-free
refusal, and ``utils/metrics.py``. The flow is float32 in both packages;
its box sums are cumulative sums, which torch adds in another order (in
double on the CPU) than XLA, so the flows differ in the last bits."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilizer_tpu.utils import flow as jflow
from video_stabilizer_tpu.utils import jitter as jjitter
from video_stabilizer_tpu_torch import utils as tutils
from video_stabilizer_tpu_torch.config import StabilizerParams
from video_stabilizer_tpu_torch.models.batch import stabilize_clip
from video_stabilizer_tpu_torch.utils import flow, jitter, metrics
from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip
from conftest import natural_image

# Torch's CPU threads would contend with the JAX runtime's in this process.
torch.set_num_threads(1)

H, W = 64, 96
SHIFTS = [(0.0, 0.0), (1.5, -0.75), (-3.25, 2.0), (5.0, 4.0)]
# The JAX package's flow as its metric runs it, inside one compiled
# program: called op by op, its many small operations each cost a dispatch.
_j_dense_flow_lk = jax.jit(jflow.dense_flow_lk)
# The flows of the two packages on the same pair, float32 with another
# cumulative-sum order: at most 1.9e-5 px on these pairs against the JAX
# package's jitted flow (2.0e-5 against its eager one).
FLOW_BAR = 1e-4


def shifted_pair(dx, dy, seed=3):
    """tests/test_flow.py's pair at 64x96: b is a moved by (dx, dy)."""
    big = natural_image(H + 16, W + 16, seed=seed).astype(np.float64)
    a = big[8:8 + H, 8:8 + W]
    x0, y0 = 8 - dx, 8 - dy
    xi, yi = int(np.floor(x0)), int(np.floor(y0))
    fx, fy = x0 - xi, y0 - yi
    win = big[yi:yi + H + 1, xi:xi + W + 1]
    b = (win[:-1, :-1] * (1 - fx) * (1 - fy) + win[:-1, 1:] * fx * (1 - fy)
         + win[1:, :-1] * (1 - fx) * fy + win[1:, 1:] * fx * fy)
    return a.astype(np.uint8), b.astype(np.uint8)


def test_dense_flow_lk_matches_jax():
    """Per-pixel u, v of four pairs within FLOW_BAR of the JAX package's,
    the pairs batched on a leading axis in the port."""
    pairs = [shifted_pair(dx, dy) for dx, dy in SHIFTS]
    a = torch.from_numpy(np.stack([p[0] for p in pairs]))
    b = torch.from_numpy(np.stack([p[1] for p in pairs]))
    u, v = flow.dense_flow_lk(a, b)
    for i, (pa, pb) in enumerate(pairs):
        uj, vj = _j_dense_flow_lk(jnp.asarray(pa), jnp.asarray(pb))
        assert np.abs(u[i].numpy() - np.asarray(uj)).max() <= FLOW_BAR
        assert np.abs(v[i].numpy() - np.asarray(vj)).max() <= FLOW_BAR


def test_median_flow_px_matches_jax_and_known_translations():
    """The per-pair statistic within FLOW_BAR of the JAX package's, and both
    within test_flow.py's bar of the known translation:
    max(0.25, 0.15 |d|)."""
    for dx, dy in SHIFTS:
        a, b = shifted_pair(dx, dy)
        got = float(flow.median_flow_px(torch.from_numpy(a),
                                        torch.from_numpy(b)))
        want = float(jflow.median_flow_px(jnp.asarray(a), jnp.asarray(b)))
        assert abs(got - want) <= FLOW_BAR, (dx, dy, got, want)
        true = float(np.hypot(dx, dy))
        assert abs(got - true) < max(0.25, 0.15 * true), (dx, dy, got)


def test_median_jitter_px_device_matches_jax():
    """A 10-frame BGR clip: within FLOW_BAR of the JAX package's (measured
    9.5e-7 px); clips batched on a leading axis give each clip's own
    value."""
    clips = [synth_shaky_clip(10, H, W, seed=s, jitter_px=1.0)
             for s in (9, 10)]
    got = flow.median_jitter_px_device(clips[0], device="cpu")
    want = jflow.median_jitter_px_device(clips[0])
    assert abs(got - want) <= FLOW_BAR, (got, want)
    both = flow.median_jitter_px_device_impl(
        flow.gray_f32(torch.from_numpy(np.stack(clips))))
    assert both.shape == (2,)
    for c, clip in enumerate(clips):
        assert float(both[c]) == flow.median_jitter_px_device(
            torch.from_numpy(clip))


def test_device_metric_discriminates_stabilized_output():
    """test_flow.py's bar on the port: a clip stabilized by the port scores
    below 0.6x its shaky input on the port's device metric."""
    clip = synth_shaky_clip(16, 128, 160, seed=72, jitter_px=1.0,
                            pan_px_per_frame=0.3)
    out, _, _ = stabilize_clip(clip, StabilizerParams(
        lag=4, smoother_memory=2, crop_pixels=8), device="cpu")
    in_j = flow.median_jitter_px_device(clip, device="cpu")
    out_j = flow.median_jitter_px_device(out)
    assert out_j < 0.6 * in_j, (in_j, out_j)


@pytest.mark.skipif(not jitter.HAS_CV2, reason="cv2 unavailable")
def test_median_jitter_px_equals_jax():
    """The cv2 Farneback metric on the same clip, gray and BGR: the same
    float as the JAX package's, and the ratio as its jitter_ratio."""
    clip = synth_shaky_clip(8, H, W, seed=71, jitter_px=1.2)
    assert jitter.median_jitter_px(clip) == jjitter.median_jitter_px(clip)
    gray = clip[..., 0]
    assert jitter.median_jitter_px(gray) == jjitter.median_jitter_px(gray)
    assert jitter.jitter_ratio(clip, clip[::-1]) == \
        jjitter.jitter_ratio(clip, clip[::-1])
    assert tutils.median_jitter_px is jitter.median_jitter_px


def test_cv2_free_refuses_as_jax(monkeypatch):
    """Without cv2 the metric raises the JAX package's RuntimeError, word
    for word, unless VIDSTAB_ALLOW_JITTER_FALLBACK=1 opts into the dense-LK
    twin: then it warns and gives the median of the pairs'
    ``median_flow_px``."""
    clip = synth_shaky_clip(4, H, W, seed=73, jitter_px=1.0)
    monkeypatch.setattr(jitter, "HAS_CV2", False)
    monkeypatch.setattr(jjitter, "HAS_CV2", False)
    monkeypatch.delenv("VIDSTAB_ALLOW_JITTER_FALLBACK", raising=False)
    with pytest.raises(RuntimeError) as got:
        jitter.median_jitter_px(clip, device="cpu")
    with pytest.raises(RuntimeError) as want:
        jjitter.median_jitter_px(clip)
    assert str(got.value) == str(want.value)

    monkeypatch.setenv("VIDSTAB_ALLOW_JITTER_FALLBACK", "1")
    with pytest.warns(RuntimeWarning, match="dense-LK"):
        val = jitter.median_jitter_px(clip, device="cpu")
    f = clip.astype(np.float64)
    gray = torch.from_numpy(np.clip(np.round(
        0.114 * f[..., 0] + 0.587 * f[..., 1] + 0.299 * f[..., 2]), 0,
        255).astype(np.float32))
    meds = [float(flow.median_flow_px(gray[i], gray[i + 1]))
            for i in range(3)]
    assert val == float(np.median(meds))


def test_performance_metrics_and_trace(tmp_path, monkeypatch):
    """Host timers and custom metrics report as the JAX package's do; a
    disabled registry records nothing; ``time_function`` uses the process
    registry; ``device_trace`` writes a torch.profiler Chrome trace."""
    pm = metrics.PerformanceMetrics(enabled=True)
    for _ in range(3):
        with pm.timer("Stage"):
            torch.ones(8).sum()
    pm.log_metric("frames", 4)
    rep = pm.report().splitlines()
    assert rep[0] == "==== PERFORMANCE METRICS ===="
    assert rep[2].startswith("Stage") and rep[2].split()[3] == "3"
    assert "==== CUSTOM METRICS ====" in rep and rep[-1].startswith("frames")
    off = metrics.PerformanceMetrics(enabled=False)
    with off.timer("Stage"):
        pass
    off.log_metric("frames", 1)
    assert not off.timers and not off.custom
    monkeypatch.setattr(metrics.PerformanceMetrics, "_instance", pm)
    with metrics.time_function("Other"):
        pass
    assert pm.timers["Other"].count == 1
    pm.reset()
    assert not pm.timers and not pm.custom
    assert tutils.PerformanceMetrics is metrics.PerformanceMetrics
    with metrics.device_trace(str(tmp_path)):
        torch.ones(64).cumsum(0)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]
    assert os.path.isdir(tmp_path)
