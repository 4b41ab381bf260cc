"""Named device-time spans of the chunk pipeline.

The pipeline marks its stages with ``span(name)``. Nothing is measured
unless a ``Recorder`` is active: then each span records a CUDA event pair on
the current stream, and ``Recorder.totals()`` gives the milliseconds of the
device timeline between them, summed per name. A span therefore covers the
stage's kernels and any idle gap on the device while the host enqueues
them. Spans on a CPU tensor path are not recorded.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

_active = None


class Recorder:
    """Collects the spans opened while it is active (``with Recorder()``)."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        global _active
        if _active is not None:
            raise RuntimeError("a span recorder is already active")
        _active = self
        return self

    def __exit__(self, *exc):
        global _active
        _active = None

    def totals(self) -> dict[str, float]:
        """Milliseconds per span name (synchronizes the device)."""
        torch.cuda.synchronize()
        out = defaultdict(float)
        for name, start, end in self.events:
            out[name] += start.elapsed_time(end)
        return dict(out)


def active() -> bool:
    """Whether a ``Recorder`` is active."""
    return _active is not None


@contextlib.contextmanager
def span(name: str):
    rec = _active
    if rec is None or not torch.cuda.is_available():
        yield
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    try:
        yield
    finally:
        end.record()
        rec.events.append((name, start, end))
