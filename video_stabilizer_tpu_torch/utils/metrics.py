"""Performance tracing.

Port of ``video_stabilizer_tpu.utils.metrics`` (metrics.py:1-115), the
analog of the reference's compile-time-gated PerformanceMetrics singleton,
TimerGuard and TIME_FUNCTION (alignment.cpp:10-147): labeled timers and
scalar metrics with avg / total / min / max / count reporting, enabled at
run time. A timer given a CUDA device measures the device timeline between
two CUDA events, as the port's stage spans do (``utils/spans.py``), and
opens a span of its label, so that an active ``spans.Recorder`` sees it
too; without a device it is the host's clock. ``device_trace`` records a
``torch.profiler`` trace (the JAX package's uses ``jax.profiler``).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict

import torch

from video_stabilizer_tpu_torch.utils.spans import span


@dataclass
class _Metric:
    total: float = 0.0
    count: int = 0
    min: float = float("inf")
    max: float = float("-inf")

    def add(self, v: float):
        self.total += v
        self.count += 1
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def avg(self):
        return self.total / max(self.count, 1)


@dataclass
class PerformanceMetrics:
    """Labeled timers + custom scalar metrics.

    Enabled via the VIDSTAB_METRICS=1 env var or ``enabled=True``; when
    disabled, the context manager is a no-op (the analog of TIME_FUNCTION
    expanding to ``;`` — alignment.cpp:145-147).
    """

    enabled: bool = field(
        default_factory=lambda: os.environ.get("VIDSTAB_METRICS", "0") == "1")
    timers: Dict[str, _Metric] = field(default_factory=dict)
    custom: Dict[str, _Metric] = field(default_factory=dict)

    _instance = None

    @classmethod
    def instance(cls) -> "PerformanceMetrics":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    @contextlib.contextmanager
    def timer(self, label: str, device=None):
        """Time the block in ms under ``label``: on the host's clock, or,
        with a CUDA ``device``, between CUDA events on its current stream
        (waiting for the end event when the block exits)."""
        if not self.enabled:
            yield
            return
        dev = None if device is None else torch.device(device)
        if dev is not None and dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(dev))
            try:
                with span(label):
                    yield
            finally:
                end.record(torch.cuda.current_stream(dev))
                end.synchronize()
                self.timers.setdefault(label, _Metric()).add(
                    start.elapsed_time(end))
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            self.timers.setdefault(label, _Metric()).add(ms)

    def log_metric(self, label: str, value: float):
        if self.enabled:
            self.custom.setdefault(label, _Metric()).add(float(value))

    def report(self) -> str:
        lines = ["==== PERFORMANCE METRICS ===="]
        hdr = (f"{'label':<40}{'avg(ms)':>12}{'total(ms)':>12}{'calls':>8}"
               f"{'min':>10}{'max':>10}")
        lines.append(hdr)
        for name in sorted(self.timers):
            m = self.timers[name]
            lines.append(f"{name:<40}{m.avg:>12.3f}{m.total:>12.3f}"
                         f"{m.count:>8d}{m.min:>10.3f}{m.max:>10.3f}")
        if self.custom:
            lines.append("==== CUSTOM METRICS ====")
            for name in sorted(self.custom):
                m = self.custom[name]
                lines.append(f"{name:<40}{m.avg:>12.3f}{m.total:>12.3f}"
                             f"{m.count:>8d}{m.min:>10.3f}{m.max:>10.3f}")
        return "\n".join(lines)

    def reset(self):
        self.timers.clear()
        self.custom.clear()


def time_function(label: str, device=None):
    """Shortcut: ``with time_function("PyramidLevel_3"): ...`` (a CUDA
    ``device`` times the device timeline, as ``PerformanceMetrics.timer``
    says)."""
    return PerformanceMetrics.instance().timer(label, device)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block, with the CUDA activity when
    a card is present, written as ``<log_dir>/trace.json`` (Chrome trace
    format) when the block exits."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
