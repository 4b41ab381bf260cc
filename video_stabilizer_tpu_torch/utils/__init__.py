"""Host-side utilities of the PyTorch port: video I/O, the jitter
evaluation metric and the performance-metrics tracer (the JAX package's
``utils`` exports), plus the stage spans, the dense-flow metric on the
device and checkpoints."""

from video_stabilizer_tpu_torch.utils.metrics import (
    PerformanceMetrics, time_function)
from video_stabilizer_tpu_torch.utils import io
from video_stabilizer_tpu_torch.utils.jitter import median_jitter_px

__all__ = ["PerformanceMetrics", "time_function", "io", "median_jitter_px"]
