"""The port's measuring tools on the CPU at 96x128: the chunked bench
(``video_stabilizer_tpu_torch.bench``), the other configurations
(``apps/bench_configs.py``) and the chunk profiler
(``apps/profile_chunk.py``). They print the JAX tools' JSON lines and
tables; their times on the CPU mean nothing, so only keys, names and
totals are checked. No JAX here."""

import contextlib
import io as pyio
import json

import pytest
import torch

from video_stabilizer_tpu_torch import bench, graft_entry
from video_stabilizer_tpu_torch.apps import bench_configs, profile_chunk

torch.set_num_threads(1)

SMALL = ["--device", "cpu", "--height", "96", "--width", "128"]
BENCH_ENV = dict(BENCH_HEIGHT="96", BENCH_WIDTH="128", BENCH_STREAMS="2",
                 BENCH_FRAMES="4", BENCH_REPS="1", BENCH_INNER="1")


def stdout_of(fn, *args, **kw):
    out = pyio.StringIO()
    with contextlib.redirect_stdout(out):
        ret = fn(*args, **kw)
    return ret, out.getvalue().splitlines()


def test_bench_prints_one_json_line(monkeypatch):
    for k, v in dict(BENCH_ENV, BENCH_DEVICE="cpu").items():
        monkeypatch.setenv(k, v)
    (line, ok_rate), lines = stdout_of(bench.main)
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got == line
    assert set(got) == {"metric", "value", "unit", "device"}
    assert got["metric"] == "stabilized_96p_bgr_fps_2streams_chunked"
    assert got["value"] > 0 and got["unit"] == "frames/sec"
    assert got["device"] == "cpu"
    assert 0.0 <= ok_rate <= 1.0


@pytest.mark.parametrize("argv, metric, unit", [
    (["--mode", "4k", "--streams", "2", "--frames", "4", "--reps", "1"],
     "stabilized_96p_bgr_homography_lanczos2_fps_2streams_chunked",
     "frames/sec"),
    (["--mode", "latency", "--chain", "2", "--reps", "1", "--fixed-iters",
      "4"], "p50_on_device_align_latency_96p_fixed4", "ms/frame"),
    (["--mode", "latency-chunk2", "--chain", "2", "--reps", "1",
      "--merge-coarse", "2"],
     "p50_e2e_latency_96p_chunk2_single_stream_merge2", "ms/frame"),
    (["--mode", "latency-request", "--samples", "2"],
     "single_request_latency_96p_chunk2", "ms/request (2 frames)"),
], ids=["4k", "latency", "latency-chunk2", "latency-request"])
def test_bench_configs_modes(argv, metric, unit):
    ret, lines = stdout_of(bench_configs.main, argv + SMALL)
    assert ret == 0 and len(lines) == 1
    got = json.loads(lines[0])
    assert set(got) == {"metric", "value", "unit", "align_success",
                        "device", "note"}
    assert got["metric"] == metric and got["unit"] == unit
    assert got["value"] > 0 and got["device"] == "cpu"
    assert 0.0 <= got["align_success"] <= 1.0
    if argv[1] == "latency-request":
        assert set(got["note"]) >= {
            "p50_ms_submit_to_ready", "p99_ms_submit_to_ready",
            "p50_ms_incl_frame_fetch", "p99_ms_incl_frame_fetch",
            "p50_ms_dispatch_floor"}


def test_bench_configs_1080p_mode_runs_the_bench(monkeypatch):
    for k, v in BENCH_ENV.items():
        monkeypatch.setenv(k, v)
    ret, lines = stdout_of(bench_configs.main,
                           ["--mode", "1080p", "--device", "cpu"])
    assert ret == 0
    assert json.loads(lines[-1])["metric"] == (
        "stabilized_96p_bgr_fps_2streams_chunked")


def test_align_next_frame_leaves_its_state_untouched():
    """bench_latency runs every rep from the same start state."""
    from video_stabilizer_tpu_torch.config import AlignerParams
    from video_stabilizer_tpu_torch.models.aligner import (
        align_next_frame, init_state)
    from video_stabilizer_tpu_torch.parallel.mesh import tensor_leaves
    from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

    params = AlignerParams()
    clip = torch.from_numpy(synth_shaky_clip(3, 96, 128, seed=6,
                                             color=False))
    state = init_state(128, 96, params, "cpu")
    for frame in clip:     # zero state, then a keyframe, then a non-key
        before = [t.clone() for t in tensor_leaves(state)]
        fields = (state.curr_idx, state.frames_seen)
        new, _, _ = align_next_frame(state, frame, params)
        assert (state.curr_idx, state.frames_seen) == fields
        for a, b in zip(before, tensor_leaves(state)):
            assert torch.equal(a, b)
        state = new


def test_profile_summaries_agree_with_parse_only(tmp_path):
    """A chunk traced on the CPU (top-level aten operators in place of
    device events): the run's table and ``--parse-only``'s agree, and by
    source nearly all of the time lies in the port's own frames."""
    args = ["--logdir", str(tmp_path), "--streams", "2", "--frames", "2",
            "--top", "5"]
    ran, _ = stdout_of(profile_chunk.main, args + SMALL)
    parsed, lines = stdout_of(profile_chunk.main, args + ["--parse-only"])
    assert parsed == ran and len(ran) > 10
    assert any("aten::" in name for name in ran)
    assert "by kernel" in lines[1]
    by_src, _ = stdout_of(profile_chunk.main,
                          args + ["--parse-only", "--by-source"])
    total = sum(us for us, _ in ran.values())
    assert sum(us for us, _ in by_src.values()) == pytest.approx(total)
    assert sum(n for _, n in by_src.values()) == sum(
        n for _, n in ran.values())
    mine = sum(us for name, (us, _) in by_src.items()
               if name.startswith(profile_chunk.PACKAGE))
    assert mine / total > 0.9


def _x(cat, name, ts, dur, tid=1, **args):
    return dict(ph="X", cat=cat, name=name, pid=7, tid=tid, ts=ts, dur=dur,
                args=args)


def test_by_source_links_kernels_to_their_launching_frame():
    """A CUDA trace in miniature: each kernel reaches its runtime call by
    correlation id, and its time goes to the innermost package frame around
    that call, not to a library frame inside it nor to a frame of another
    thread."""
    pkg = profile_chunk.PACKAGE
    events = [
        _x("python_function", f"{pkg}models/chunked.py(161): run", 0, 100),
        _x("python_function", f"{pkg}models/smoother.py(19): smooth", 10,
           30),
        _x("python_function", "torch/functional.py(9): helper", 12, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 14, 2, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 50, 2, correlation=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 60, 2, tid=2, correlation=3),
        _x("python_function", f"{pkg}ops/other.py(1): elsewhere", 55, 20,
           tid=3),
        _x("kernel", "void smooth_kernel<float>()", 20, 7.0, tid=9,
           correlation=1),
        _x("kernel", "warp_kernel", 52, 3.0, tid=9, correlation=2),
        _x("gpu_memcpy", "Memcpy DtoH", 62, 5.0, tid=9, correlation=3),
        _x("gpu_user_annotation", "warp", 50, 9.0, tid=9),
        _x("cpu_op", "aten::add", 13, 4),
    ]
    assert profile_chunk.summarize_ops(events) == {
        "void smooth_kernel<float>()": (7.0, 1), "warp_kernel": (3.0, 1),
        "Memcpy DtoH": (5.0, 1)}
    assert profile_chunk.summarize_by_source(events) == {
        f"{pkg}models/smoother.py(19): smooth": (7.0, 1),
        f"{pkg}models/chunked.py(161): run": (3.0, 1),
        profile_chunk.UNATTRIBUTED: (5.0, 1)}


@pytest.mark.parametrize("call", [
    lambda: bench_configs.main(["--mode", "latency", "--chain", "2"]),
    lambda: bench_configs.main(["--mode", "1080p"]),
    lambda: profile_chunk.main([]),
    lambda: bench.main(),
    lambda: graft_entry.entry(),
], ids=["bench_configs", "bench_configs-1080p", "profile_chunk", "bench",
        "graft_entry"])
def test_tools_default_to_the_card(monkeypatch, call):
    """Asked for no device, each tool runs on the CUDA card, and raises
    when there is none."""
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
