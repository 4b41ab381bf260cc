"""Two-process smoke run of ``parallel/multihost.py`` on the CPU: the port
of the JAX package's ``apps/multihost_smoke.py``.

It runs the multi-process recipe for real: process-group bring-up, each
process feeding only its own streams, the stream-split stabilization. Two
processes, each with a mesh of 4 CPU entries, stand in for 2 hosts x 4
cards. It runs on the CPU by design, with the ``gloo`` backend: one card
cannot host two NCCL ranks. The launcher passes the CPU explicitly.

    python -m video_stabilizer_tpu_torch.apps.multihost_smoke

The launcher takes a free port from the OS for the coordinator, starts the
two workers, waits on each with a timeout and exits non-zero if any fails.
Each worker holds its own output shards bit-equal to the port's
single-process ``stabilize_clip`` on the same streams.
"""

import argparse
import os
import socket
import subprocess
import sys

N_PROC = 2
DEV_PER_PROC = 4
S_TOTAL = 8  # one stream per mesh entry
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def worker(pid: int, port: int) -> None:
    import time
    t0 = time.perf_counter()

    import numpy as np
    import torch
    import torch.distributed as dist

    from video_stabilizer_tpu_torch.config import StabilizerParams
    from video_stabilizer_tpu_torch.models.batch import stabilize_clip
    from video_stabilizer_tpu_torch.parallel import (
        initialize_multihost, local_stream_slice, make_global_stream_batch,
        multihost_mesh, stabilize_streams_sharded)
    from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

    torch.set_num_threads(1)
    initialize_multihost(f"localhost:{port}", N_PROC, pid, backend="gloo")
    if dist.get_world_size() != N_PROC:
        raise RuntimeError(f"world size {dist.get_world_size()}")
    mesh = multihost_mesh([torch.device("cpu")] * DEV_PER_PROC)

    params = StabilizerParams(lag=2, smoother_memory=1, crop_pixels=4)
    # Every process could make every stream; each feeds only its own.
    clips = np.stack([synth_shaky_clip(8, 48, 64, seed=90 + s, jitter_px=0.5)
                      for s in range(S_TOTAL)])
    sl = local_stream_slice(S_TOTAL)
    if sl.stop - sl.start != S_TOTAL // N_PROC:
        raise RuntimeError(f"local slice {sl}")
    batch = make_global_stream_batch(clips[sl], mesh, S_TOTAL)
    out, meas, ok = stabilize_streams_sharded(batch, mesh, params)

    starts = []
    for shard, offset in zip(out.shards, out.offsets):
        for i, got in enumerate(shard):
            ref, _, _ = stabilize_clip(clips[offset + i], params,
                                       device="cpu")
            np.testing.assert_array_equal(got.numpy(), ref.numpy())
            starts.append(offset + i)
    dist.barrier()
    dist.destroy_process_group()
    print(f"[proc {pid}] OK: {N_PROC} processes x {mesh.size} CPU mesh "
          f"entries, local streams {starts} match the single-process "
          f"pipeline ({time.perf_counter() - t0:.1f} s)", flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--worker", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--timeout", type=float, default=110.0,
                    help="seconds to wait for each worker")
    args = ap.parse_args(argv)
    if args.worker is not None:
        worker(args.worker, args.port)
        return 0

    port = free_port()
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # stay on the loopback
    procs = [subprocess.Popen(
        [sys.executable, "-m", "video_stabilizer_tpu_torch.apps."
         "multihost_smoke", "--worker", str(pid), "--port", str(port)],
        cwd=_REPO, env=env) for pid in range(N_PROC)]
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=args.timeout))
    except subprocess.TimeoutExpired:
        print(f"multihost smoke: a worker ran past {args.timeout} s",
              file=sys.stderr)
        return 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        print(f"multihost smoke: worker exit codes {codes}", file=sys.stderr)
        return 1
    print(f"multihost smoke OK: {N_PROC} processes x {DEV_PER_PROC} CPU "
          "mesh entries")
    return 0


if __name__ == "__main__":
    sys.exit(main())
