"""Pipeline models: the aligner, the trajectory smoother, the streaming
stabilizer, and the clip / chunked multi-stream pipelines."""

from video_stabilizer_tpu_torch.models.aligner import (
    AlignerState,
    DynAlignParams,
    LevelSpec,
    VideoAligner,
    align_next_frame,
    init_state,
    level_specs,
)
from video_stabilizer_tpu_torch.models.batch import (
    align_clip,
    stabilize_clip,
    stabilize_streams,
)
from video_stabilizer_tpu_torch.models.chunked import (
    ChunkedStabilizer,
    StreamState,
    init_stream_state,
    stabilize_stream_chunked,
)
from video_stabilizer_tpu_torch.models.homography_aligner import (
    align_clip_homography,
    stabilize_clip_homography,
)
from video_stabilizer_tpu_torch.models.smoother import (
    L1SmootherCenter, tvl1_smooth)
from video_stabilizer_tpu_torch.models.stabilizer import VideoStabilizer

__all__ = [
    "AlignerState", "DynAlignParams", "LevelSpec", "VideoAligner",
    "align_next_frame", "init_state", "level_specs",
    "align_clip", "stabilize_clip", "stabilize_streams",
    "ChunkedStabilizer", "StreamState", "init_stream_state",
    "stabilize_stream_chunked",
    "align_clip_homography", "stabilize_clip_homography",
    "L1SmootherCenter", "tvl1_smooth",
    "VideoStabilizer",
]
