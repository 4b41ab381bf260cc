"""The program layer (``utils/graphs.py``) on the CPU.

The card's capture and replay cannot run here, so a stand-in backend takes
their place: it "captures" by keeping the function and the outputs of one
run, and "replays" by running the function again on the static inputs with
the launch counts held (no Python runs in a real replay) and writing the
results into those same outputs, as a graph writes its static outputs.
Through it the tests check the program entry points against the
un-captured composition, the cache key and the wrapper's bookkeeping.
No JAX here: the entry points' parity with the JAX package is held by
``test_torch_chunked.py``, ``test_torch_streaming.py`` and the others,
which now run through the same entry points."""

import contextlib

import numpy as np
import pytest
import torch

from video_stabilizer_tpu_torch import transforms as T
from video_stabilizer_tpu_torch.config import AlignerParams, StabilizerParams
from video_stabilizer_tpu_torch.models import (
    aligner, batch, chunked, smoother, stabilizer)
from video_stabilizer_tpu_torch.ops.gn_solve import gn_solve
from video_stabilizer_tpu_torch.ops.warp_kernel import warp_frames
from video_stabilizer_tpu_torch.utils import graphs
from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip
from video_stabilizer_tpu_torch.utils.spans import Recorder

torch.set_num_threads(1)

H, W = 96, 128
CPU = torch.device("cpu")
# Short lag and memory keep the chunks and streams small.
PARAMS = StabilizerParams(lag=2, smoother_memory=1, crop_pixels=8)
PARAMS_H = StabilizerParams(
    lag=2, smoother_memory=1, crop_pixels=8, output_interp="lanczos2",
    aligner=AlignerParams(phase_correlate=True, threshold=0.1))


class StandIn:
    """A capture backend with ``CudaGraphs``' methods that needs no card."""

    def __init__(self, fail_capture=False):
        self.fail_capture = fail_capture
        self.replays = self.released = self.opened = 0
        self.pools = []            # (program name, device, pool) a capture

    def new_pool(self, dev):
        self.opened += 1
        return ("pool", self.opened)

    def device_of(self, leaves):
        return CPU if any(isinstance(x, torch.Tensor) for x in leaves) \
            else None

    def on(self, dev):
        return contextlib.nullcontext()

    def warmup(self, dev, fn):
        return fn()

    def capture(self, dev, fn, name, pool, inputs):
        self.pools.append((name, dev, pool))
        if self.fail_capture:
            raise RuntimeError(f"{name}: capture refused")
        # A capture on the card runs no kernel: what the run writes into
        # the static inputs (a donated state) is put back.
        saved = [x.clone() if isinstance(x, torch.Tensor) else x
                 for x in inputs]
        out = fn()
        for x, s in zip(inputs, saved):
            if isinstance(x, torch.Tensor):
                x.copy_(s)
        static_out = leaves(out)

        def graph():
            held = graphs.launch_counts()
            with graphs.eager():          # nested programs run inline
                new = leaves(fn())
            graphs.add_launches({k: held.get(k, 0) - n
                                 for k, n in graphs.launch_counts().items()})
            for s, n in zip(static_out, new):
                if isinstance(s, torch.Tensor):
                    s.copy_(n)
        return graph, out, 0.0, 0.0, 0

    def replay(self, dev, graph):
        self.replays += 1
        graph()

    def release(self, dev, entries):
        self.released += len(entries)
        entries.clear()


@pytest.fixture
def stand_in():
    backend = StandIn()
    graphs.reset()
    with graphs.use_backend(backend):
        yield backend
    graphs.reset()


def leaves(tree):
    out = []
    graphs._flatten(tree, out)
    return out


def assert_same(got, want):
    got, want = leaves(got), leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b


def clip(streams, frames, seed):
    return torch.from_numpy(np.stack([
        synth_shaky_clip(frames, H, W, seed=seed + s, jitter_px=0.8,
                         pan_px_per_frame=0.3, rot_jitter=0.002)
        for s in range(streams)]))


# -- (a) the entry points against the un-captured composition -----------------

@pytest.mark.parametrize("params, model", [(PARAMS, "similarity"),
                                          (PARAMS_H, "homography")],
                         ids=["similarity", "homography"])
def test_chunk_program_equals_the_uncaptured_composition(stand_in, params,
                                                         model):
    """Two 4-frame chunks of 2 streams: the first call captures, the second
    replays; both equal stabilize_chunk_core + warp_delayed, state too."""
    frames = clip(2, 8, 31)
    got_state = want_state = chunked.init_stream_state(W, H, params, 3, 2,
                                                       CPU, model)
    for c in range(2):
        x = frames[:, 4 * c:4 * (c + 1)]
        got_state, *got = chunked.stabilize_chunk_streams(got_state, x,
                                                          params, model)
        want_state, delayed, accums, meas, succ, valid = \
            chunked.stabilize_chunk_core(want_state, x, params, W, H, model)
        out = batch.warp_delayed(delayed, accums, params, W, H, model)
        assert_same((got_state, got), (want_state, (out, meas, succ, valid)))
    assert stand_in.replays == 1
    assert len(chunked._stabilize_chunk_streams_jit.stats()) == 1


def test_one_stream_chunk_program(stand_in):
    """``stabilize_chunk_impl`` (``_stabilize_chunk_jit``) is the streams
    program at S = 1."""
    frames = clip(1, 8, 41)
    state = chunked.init_stream_state(W, H, PARAMS, 3, 1, CPU)
    got_s, want_s = state, state
    for c in range(2):
        x = frames[:, 4 * c:4 * (c + 1)]
        got_s, *got = chunked.stabilize_chunk_impl(got_s, x[0], PARAMS)
        with graphs.eager():
            want_s, *want = chunked.stabilize_chunk_streams(want_s, x,
                                                            PARAMS)
        assert_same((got_s, got), (want_s, [w[0] for w in want]))
    assert chunked._stabilize_chunk_jit.replays == 1


def test_chunk_programs_keep_four_keys_per_card():
    assert chunked._stabilize_chunk_streams_jit.max_keys == 4
    assert chunked._stabilize_chunk_jit.max_keys == 4


def test_a_stream_count_met_again_replays_into_the_shared_pool(stand_in):
    """The chunk program at 48x64 with 1, 2, then 1 stream: two keys in one
    pool, and the repeated key replays, byte-equal to its un-captured
    call."""
    h, w = 48, 64
    params = StabilizerParams(lag=4, smoother_memory=2, crop_pixels=4)
    frames = torch.from_numpy(np.stack([
        synth_shaky_clip(4, h, w, seed=1000 + s, jitter_px=0.6,
                         pan_px_per_frame=0.1) for s in range(2)]))
    prog = chunked._stabilize_chunk_streams_jit
    state1 = chunked.init_stream_state(w, h, params, 3, 1, CPU)
    state1, *_ = chunked.stabilize_chunk_streams(state1, frames[:1, :2],
                                                 params)
    chunked.stabilize_chunk_streams(
        chunked.init_stream_state(w, h, params, 3, 2, CPU), frames[:, :2],
        params)
    got = chunked.stabilize_chunk_streams(state1, frames[:1, 2:], params)
    with graphs.eager():
        want = chunked.stabilize_chunk_streams(state1, frames[:1, 2:],
                                               params)
    assert_same(got, want)
    assert (prog.captures, prog.replays, prog.evictions) == (2, 1, 0)
    assert {p for name, _, p in stand_in.pools if name == prog.name} == {
        prog.pool(CPU)}


def test_streaming_programs_equal_eager(stand_in):
    """6 frames through ``VideoStabilizer``: gray, the align step (its four
    branches), the smoother window and the warp replayed against the same
    stabilizer run un-captured: outputs and measurements equal."""
    frames = clip(1, 6, 51)[0]
    runs = []
    for ctx in (graphs.eager, contextlib.nullcontext):
        stab = stabilizer.VideoStabilizer(PARAMS, CPU)
        meas = []
        align = stab.aligner.align_next_frame

        def recorded(gray, align=align, meas=meas):
            t, ok = align(gray)
            meas.append((t, ok))
            return t, ok
        stab.aligner.align_next_frame = recorded
        with ctx():
            outs = [stab.process_frame(f) for f in frames]
        runs.append(([o for o in outs if o is not None], meas))
    assert len(runs[0][0]) == 6 - PARAMS.lag
    assert_same(runs[1], runs[0])
    assert len(aligner._align_next_frame_impl.stats()) == 4
    assert aligner._align_next_frame_impl.replays == 2
    assert stabilizer._to_gray.replays == 5
    assert stabilizer._warp_fn.replays == 3


def test_smoother_window_program(stand_in):
    rng = np.random.default_rng(3)
    buf = torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32))
    want = smoother._smooth_window_body(buf, 1.0, 10, 16, 100)
    for _ in range(2):
        got = smoother._smooth_window(buf, 1.0, 10, 16, 100)
        assert torch.equal(got, want)
    assert smoother._smooth_window.replays == 1
    # Another window size is another key.
    smoother._smooth_window(buf, 1.0, 3, 9, 100)
    assert len(smoother._smooth_window.stats()) == 2


# -- (b) the cache key --------------------------------------------------------

def _scaled(x, params, model="similarity"):
    return x * (2.0 if model == "similarity" else 3.0)


def test_cache_key(stand_in):
    prog = graphs.Program(_scaled, static_argnames=("params", "model"))
    x = torch.ones(3)
    prog(x, PARAMS)
    prog(x + 1, PARAMS)
    assert prog.captures == 1 and prog.replays == 1
    prog(x, PARAMS_H)                           # another params
    prog(torch.ones(4), PARAMS)                 # another shape
    prog(x.double(), PARAMS)                    # another dtype
    assert torch.equal(prog(x, PARAMS, model="homography"), x * 3.0)
    assert prog.captures == 5 and prog.replays == 1
    prog(x, params=PARAMS, model="homography")  # the same key by keyword
    assert prog.captures == 5 and prog.replays == 2
    with pytest.raises(TypeError, match="hashable"):
        prog(x, {"lag": 2})
    # Host ints inside a state pick a branch as statics do.
    state = aligner.init_state(W, H, AlignerParams(), CPU)
    keys = {graphs._flatten((state._replace(curr_idx=c, frames_seen=f),),
                            []) for c in (0, 1) for f in (0, 1, 2)}
    assert len(keys) == 1
    metas = {tuple(graphs._meta(v) for v in (c, f))
             for c in (0, 1) for f in (0, 1, 2)}
    assert len(metas) == 6


class _PerDevice(StandIn):
    """The stand-in with each call's tensors' own device as its card."""

    def device_of(self, leaves):
        return next((x.device for x in leaves
                     if isinstance(x, torch.Tensor)), None)


def test_max_keys_counts_the_keys_of_each_device():
    """With ``max_keys=1`` a second key on one device drops the first and
    releases it through the backend; a key on another device does not, so
    the shards of a mesh each keep their own card's graph."""
    backend = _PerDevice()
    prog = graphs.Program(lambda x: x * 2, name="double", max_keys=1)
    meta = torch.device("meta")
    with graphs.use_backend(backend):
        for x in (torch.ones(2), torch.ones(2, device=meta)) * 2:
            prog(x)
        assert (prog.captures, prog.replays, prog.evictions) == (2, 2, 0)
        assert torch.equal(prog(torch.ones(3)), torch.full((3,), 2.0))
        prog(torch.ones(2, device=meta))
        assert (prog.captures, prog.replays, prog.evictions) == (3, 3, 1)
        assert backend.released == 1 and len(prog._cache) == 2
        prog(torch.ones(2))                 # dropped: captured anew
        assert (prog.captures, prog.evictions) == (4, 2)
    prog.reset()
    assert (prog.captures, prog.replays, prog.evictions) == (0, 0, 0)


def test_the_keys_of_a_program_on_a_device_share_one_pool():
    """Every key of one program on one device is captured into one pool;
    another device or another program has its own; a key dropped while
    others stay on its device leaves the pool in use."""
    backend = _PerDevice()
    meta = torch.device("meta")
    two = graphs.Program(lambda x: x * 2, name="two", max_keys=2)
    other = graphs.Program(lambda x: x * 3, name="other")
    with graphs.use_backend(backend):
        for n in (1, 2):
            two(torch.ones(n))
            two(torch.ones(n, device=meta))
        other(torch.ones(1))
        pools = {(name, dev, pool) for name, dev, pool in backend.pools}
        assert len(backend.pools) == 5 and len(pools) == 3
        assert two.pool(CPU) not in (two.pool(meta), other.pool(CPU))
        kept = two.pool(CPU)
        two(torch.ones(3))                  # drops the key of n = 1
        assert two.evictions == 1 and two.pool(CPU) == kept
        assert backend.pools[-1] == ("two", CPU, kept)
    two.reset()
    assert two.pool(CPU) is None and two.pool(meta) is None


def test_dropping_the_last_key_on_a_device_gives_its_pool_back():
    """With one key per device, a new key first drops the last one: the
    pool goes back with it, and the new key opens another; the other
    device keeps its own."""
    backend = _PerDevice()
    meta = torch.device("meta")
    prog = graphs.Program(lambda x: x + 1, name="one", max_keys=1)
    with graphs.use_backend(backend):
        prog(torch.ones(2))
        prog(torch.ones(2, device=meta))
        first, on_meta = prog.pool(CPU), prog.pool(meta)
        prog(torch.ones(3))
        assert backend.released == 1 and prog.evictions == 1
        assert prog.pool(CPU) not in (first, None)
        assert prog.pool(meta) == on_meta
        assert [p for _, _, p in backend.pools] == [first, on_meta,
                                                    prog.pool(CPU)]
    prog.reset()


def test_unhashable_statics_raise_on_the_cpu_path_too():
    prog = graphs.Program(_scaled, static_argnames=("params",))
    with pytest.raises(TypeError, match="hashable"):
        prog(torch.ones(2), [1, 2])
    assert torch.equal(prog(torch.ones(2), PARAMS), torch.full((2,), 2.0))
    assert prog.captures == 0      # the CPU calls the function directly


# -- (c) the bookkeeping ------------------------------------------------------

def _step(x, y):
    gn_solve.launches += 1               # stand-ins for kernel launches
    warp_frames.launches += 2
    form = ("similarity", "bilinear")
    warp_frames.form_launches[form] = warp_frames.form_launches.get(form,
                                                                    0) + 2
    return x, x + y


def test_inputs_copied_in_never_written_outputs_not_aliased(stand_in):
    prog = graphs.Program(_step)
    x1, y1 = torch.arange(4.0), torch.ones(4)
    keep = (x1.clone(), y1.clone())
    first = prog(x1, y1)
    assert first[0].data_ptr() != x1.data_ptr()
    assert torch.equal(first[0], keep[0]) and torch.equal(first[1], keep[0]
                                                          + 1)
    second = prog(x1 * 10, y1 * 10)                 # a replay
    third = prog(torch.zeros(4), torch.zeros(4))    # and another
    assert torch.equal(x1, keep[0]) and torch.equal(y1, keep[1])
    assert torch.equal(first[0], keep[0])           # earlier results stay
    assert torch.equal(first[1], keep[0] + 1)
    assert torch.equal(second[1], keep[0] * 10 + 10)
    assert torch.equal(third[0], torch.zeros(4))
    assert second[0].data_ptr() != third[0].data_ptr()
    entry, = prog._cache.values()
    assert all(b.data_ptr() not in (x1.data_ptr(), y1.data_ptr())
               for b in entry.static_in)


def test_launch_counts_add_per_replay(stand_in):
    from video_stabilizer_tpu_torch.ops import warp_kernel
    prog = graphs.Program(_step)
    warp_kernel.reset_launches()
    gn_solve.launches = 0
    prog(torch.ones(2), torch.ones(2))   # eager run: counted; capture: not
    assert gn_solve.launches == 1 and warp_frames.launches == 2
    for _ in range(3):
        prog(torch.ones(2), torch.ones(2))
    assert gn_solve.launches == 4 and warp_frames.launches == 8
    assert warp_frames.form_launches == {("similarity", "bilinear"): 8}
    stats, = prog.stats()
    assert stats["launches_per_replay"] == {
        ("gn_solve", None): 1, ("warp_frames", None): 2,
        ("warp_frames", ("similarity", "bilinear")): 2}
    gn_solve.launches = 0
    warp_kernel.reset_launches()


def test_a_recorder_refuses_the_captured_path(stand_in):
    prog = graphs.Program(_scaled, static_argnames=("params",))
    with Recorder(), pytest.raises(RuntimeError, match="Recorder"):
        prog(torch.ones(2), PARAMS)                 # at capture
    assert prog.captures == 0
    prog(torch.ones(2), PARAMS)
    with Recorder(), pytest.raises(RuntimeError, match="Recorder"):
        prog(torch.ones(2), PARAMS)                 # and at a replay
    with Recorder(), graphs.eager():
        assert torch.equal(prog(torch.ones(2), PARAMS), torch.full((2,),
                                                                   2.0))
    assert prog.replays == 0


def test_a_failed_capture_raises():
    prog = graphs.Program(_scaled, static_argnames=("params",))
    with graphs.use_backend(StandIn(fail_capture=True)), \
            pytest.raises(RuntimeError, match="capture refused"):
        prog(torch.ones(2), PARAMS)
    assert prog.captures == 0 and not prog.stats()
    assert prog.pool(CPU) is None            # no graph holds the pool


def test_nested_programs_run_inside_the_outer_one(stand_in):
    inner = graphs.Program(lambda x: x + 1, name="inner")
    outer = graphs.Program(lambda x: inner(x) * 2, name="outer")
    for _ in range(3):
        assert torch.equal(outer(torch.ones(2)), torch.full((2,), 4.0))
    assert inner.captures == 0 and outer.replays == 2


# -- (d) no card, no device given: the entry points raise ---------------------

@pytest.mark.parametrize("make", [
    lambda: chunked.ChunkedStabilizer(PARAMS),
    lambda: chunked.init_stream_state(W, H, PARAMS),
    lambda: chunked.stabilize_stream_chunked(np.zeros((4, H, W, 3),
                                                      np.uint8), PARAMS, 2),
    lambda: stabilizer.VideoStabilizer(PARAMS),
    lambda: aligner.VideoAligner(),
    lambda: aligner.init_state(W, H, AlignerParams()),
    lambda: smoother.L1SmootherCenter(2, 1),
    lambda: __import__("video_stabilizer_tpu_torch.apps.bench_configs",
                       fromlist=["x"]).bench_latency(1, 2, height=H,
                                                     width=W),
], ids=["ChunkedStabilizer", "init_stream_state", "stabilize_stream_chunked",
        "VideoStabilizer", "VideoAligner", "aligner.init_state",
        "L1SmootherCenter", "bench_latency"])
def test_entry_points_raise_without_cuda(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_the_warp_program_takes_the_correction_as_an_input(stand_in):
    """``_warp_fn``'s correction is a tensor input, so a new correction
    replays the same graph."""
    frame = clip(1, 1, 61)[0, 0]
    for k in range(3):
        accum = torch.tensor([1e-3 * k, 0.0, 0.5 * k, -0.25 * k])
        got = stabilizer._warp_fn(frame, accum, PARAMS)
        want = batch.output_warp(
            frame, T.center_to_ul(accum, W, H, minus_one=True), PARAMS)
        assert torch.equal(got, want)
    assert stabilizer._warp_fn.replays == 2
