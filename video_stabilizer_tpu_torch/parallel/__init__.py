"""Scale-out over devices and processes: stream batches split over a mesh
of devices (``mesh``), and the multi-process recipe (``multihost``); the
JAX package's ``parallel`` exports."""

from video_stabilizer_tpu_torch.parallel.mesh import (
    init_sharded_stream_states,
    make_mesh,
    shard_streams,
    stabilize_chunk_streams_sharded,
    stabilize_streams_sharded,
)
from video_stabilizer_tpu_torch.parallel.multihost import (
    initialize_multihost,
    local_stream_slice,
    make_global_stream_batch,
    multihost_mesh,
)

__all__ = ["make_mesh", "shard_streams", "stabilize_streams_sharded",
           "init_sharded_stream_states", "stabilize_chunk_streams_sharded",
           "initialize_multihost", "local_stream_slice",
           "make_global_stream_batch", "multihost_mesh"]
