"""State donation in the program layer (``utils/graphs.py``) on the CPU.

The chunk programs donate their state, as the JAX package's
``donate_argnums=(0,)`` does: the function writes the new state into the
donated static inputs and the program returns them uncloned. These tests
drive that through ``test_torch_graphs.py``'s stand-in backend, whose
capture, as the card's, writes nothing: a small program pins each rule,
then the chunk programs at 48x64 pin the chain, two chains in turn, an
evicted key and the frame tail's shift. No JAX here: parity with the JAX
package stays with ``test_torch_chunked.py``, whose ``ChunkedStabilizer``
and ``stabilize_stream_chunked`` now take the donating path."""

import numpy as np
import pytest
import torch
from test_torch_graphs import (  # noqa: F401 (the stand_in fixture)
    StandIn, assert_same, leaves, stand_in)

from video_stabilizer_tpu_torch.config import StabilizerParams
from video_stabilizer_tpu_torch.models import batch, chunked
from video_stabilizer_tpu_torch.utils import graphs
from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip

torch.set_num_threads(1)

H, W = 48, 64
CPU = torch.device("cpu")
# tc = 2 < lag = 4: the soak's shape, every chunk shifts the carried tail.
PARAMS = StabilizerParams(lag=4, smoother_memory=2, crop_pixels=4)


class Counting(StandIn):
    """The stand-in, counting the copies into a key's donated static inputs
    that a call makes outside its replay (its copy-in)."""

    def __init__(self):
        super().__init__()
        self.replaying = False
        self.blocks = set()
        self.copies_in = 0
        outer = self

        class Spy(torch.overrides.TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                if (func is torch.Tensor.copy_ and not outer.replaying
                        and args[0].untyped_storage().data_ptr()
                        in outer.blocks):
                    outer.copies_in += 1
                return func(*args, **(kwargs or {}))
        self.spy = Spy

    def replay(self, dev, graph):
        self.replaying = True
        try:
            super().replay(dev, graph)
        finally:
            self.replaying = False


@pytest.fixture
def counting():
    backend = Counting()
    graphs.reset()
    with graphs.use_backend(backend), backend.spy():
        yield backend
    graphs.reset()


def _advance(state, x):
    """A donating step: the new state written into ``state``'s tensors
    after their last read, and returned; a second output besides."""
    total = state["total"] + x
    state["count"].add_(1)
    state["total"].copy_(total * 0.5)
    return state, total


def _fresh(n=3):
    return {"count": torch.zeros((), dtype=torch.int64),
            "total": torch.zeros(n)}


def _reference(state, xs):
    """The steps on a copy, un-captured: (each step's state and output)."""
    state = graphs._tree_map(torch.clone, state)
    out = []
    for x in xs:
        state, y = _advance(graphs._tree_map(torch.clone, state), x)
        out.append((graphs._tree_map(torch.clone, state), y))
    return out


def _prog():
    return graphs.Program(_advance, name="advance",
                          donate_argnames=("state",))


def _xs(n=4, size=3, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=size).astype(np.float32))
            for _ in range(n)]


# -- semantics 1-6 on a small program -----------------------------------------

def test_a_donated_chain_copies_no_state_in_and_returns_the_static_inputs(
        counting):
    prog = _prog()
    xs = _xs()
    state = _fresh()
    want = _reference(state, xs)
    for k, x in enumerate(xs):
        counting.copies_in = 0
        state, y = prog(state, x)
        entry, = prog._cache.values()
        counting.blocks = {entry.donated_block}
        assert_same((state, y), want[k])
        if k:                     # the first call copies the fresh state in
            assert counting.copies_in == 0
        got = {v.untyped_storage().data_ptr() for v in leaves(state)}
        assert got == {entry.donated_block}
    assert (prog.captures, prog.replays) == (1, 3)
    stats, = prog.stats()
    assert stats["static_out_bytes"] == y.untyped_storage().nbytes()


def test_a_foreign_state_is_copied_in_and_never_written(counting):
    prog = _prog()
    xs = _xs()
    chain, _ = prog(_fresh(), xs[0])
    entry, = prog._cache.values()
    counting.blocks = {entry.donated_block}
    foreign = {"count": torch.tensor(7), "total": torch.ones(3)}
    keep = graphs._tree_map(torch.clone, foreign)
    counting.copies_in = 0
    got, y = prog(foreign, xs[1])
    assert counting.copies_in == 2          # both leaves, into the key
    assert_same(foreign, keep)
    assert_same((got, y), _reference(keep, xs[1:2])[0])


def test_two_chains_of_one_key_in_turn_each_give_what_they_give_alone(
        counting):
    prog = _prog()
    xs_a, xs_b = _xs(seed=1), _xs(seed=2)
    want_a, want_b = _reference(_fresh(), xs_a), _reference(_fresh(), xs_b)
    a, b = _fresh(), _fresh()
    for k in range(len(xs_a)):
        a, ya = prog(a, xs_a[k])
        b, yb = prog(b, xs_b[k])
        assert_same((a, ya), want_a[k])
        assert_same((b, yb), want_b[k])
    assert len(prog._cache) == 1
    # The chain last in holds the static inputs; the other was moved off.
    entry, = prog._cache.values()
    assert {v.untyped_storage().data_ptr() for v in leaves(b)} == {
        entry.donated_block}
    assert entry.donated_block not in {
        v.untyped_storage().data_ptr() for v in leaves(a)}


def test_reusing_an_advanced_state_raises(counting):
    prog = _prog()
    xs = _xs()
    s1, _ = prog(_fresh(), xs[0])
    s2, _ = prog(s1, xs[1])
    with pytest.raises(RuntimeError, match="already advanced"):
        prog(s1, xs[2])
    with pytest.raises(RuntimeError, match="already advanced"):
        prog.call(s1, xs[2], donate=False)
    derived = {"count": s2["count"].view(()), "total": s2["total"][:]}
    with pytest.raises(RuntimeError, match="already advanced"):
        prog(derived, xs[2])
    with graphs.eager(), pytest.raises(RuntimeError, match="already"):
        prog(s1, xs[2])
    # Dropped with its key, the advanced state is still refused; the held
    # one is copied into the new key and goes on.
    graphs.reset([prog])
    with pytest.raises(RuntimeError, match="already advanced"):
        prog(s1, xs[2])
    s3, y = prog(s2, xs[2])
    assert_same((s3, y), _reference(_fresh(), xs[:3])[2])


def test_a_state_held_after_its_key_was_evicted_goes_on():
    backend = StandIn()
    prog = graphs.Program(_advance, name="advance", max_keys=1,
                          donate_argnames=("state",))
    xs = _xs()
    with graphs.use_backend(backend):
        s, _ = prog(_fresh(), xs[0])
        s, _ = prog(s, xs[1])
        other, _ = prog(_fresh(5), _xs(1, 5)[0])    # drops the first key
        assert prog.evictions == 1 and backend.released == 1
        s, y = prog(s, xs[2])
        s, y = prog(s, xs[3])
    assert_same((s, y), _reference(_fresh(), xs)[3])
    assert prog.evictions == 2


def test_not_donating_copies_in_never_writes_and_clones_out(counting):
    """``call(donate=False)``: the wrappers' contract, also on a key whose
    donated chain is live: that chain is moved off, not overwritten."""
    prog = _prog()
    xs = _xs()
    chain, _ = prog(_fresh(), xs[0])
    entry, = prog._cache.values()
    counting.blocks = {entry.donated_block}
    before = graphs._tree_map(torch.clone, chain)
    keep = graphs._tree_map(torch.clone, chain)
    counting.copies_in = 0
    got, y = prog.call(chain, xs[1], donate=False)
    assert counting.copies_in == 2
    assert_same(chain, before)                 # the input is not written
    assert entry.donated_block not in {
        v.untyped_storage().data_ptr() for v in leaves(got)}
    again, _ = prog.call(chain, xs[1], donate=False)
    assert_same(got, again)                    # and a result not changed
    assert_same((got, y), _reference(keep, xs[1:2])[0])
    chain, _ = prog(chain, xs[2])              # the chain goes on
    assert_same(chain, _reference(keep, xs[2:3])[0][0])


@pytest.mark.parametrize("donate", [True, False])
def test_the_cpu_and_eager_paths_run_the_same_function(donate):
    """Off the card a donating call may write the caller's tensors in place
    (as JAX on the CPU may consume a donated buffer); one that does not
    donate gives the function copies."""
    prog = _prog()
    xs = _xs()
    state = _fresh()
    keep = graphs._tree_map(torch.clone, state)
    got, y = prog.call(state, xs[0], donate=donate)
    assert_same((got, y), _reference(keep, xs[:1])[0])
    assert (got["total"] is state["total"]) == donate
    if not donate:
        assert_same(state, keep)
    assert prog.captures == 0


def test_a_capture_writes_nothing(counting):
    """The stand-in mirrors the card: after the first call the static
    inputs hold the eager run's update, once, and the first replay starts
    from it."""
    prog = _prog()
    xs = _xs()
    s, _ = prog(_fresh(), xs[0])
    assert int(s["count"]) == 1
    s, y = prog(s, xs[1])
    assert_same((s, y), _reference(_fresh(), xs[:2])[1])


def test_donated_and_other_static_inputs_are_two_allocations(counting):
    prog = _prog()
    prog(_fresh(), _xs()[0])
    entry, = prog._cache.values()
    x_buf = entry.static_in[-1]
    assert x_buf.untyped_storage().data_ptr() != entry.donated_block
    with pytest.raises(ValueError, match="donated"):
        graphs.Program(_advance, static_argnames=("state",),
                       donate_argnames=("state",))


# -- the chunk programs -------------------------------------------------------

def _clip(streams, frames, seed):
    return torch.from_numpy(np.stack([
        synth_shaky_clip(frames, H, W, seed=seed + s, jitter_px=0.6,
                         pan_px_per_frame=0.1) for s in range(streams)]))


def _uncaptured(state, x):
    new, delayed, accums, meas, succ, valid = chunked.stabilize_chunk_core(
        state, x, PARAMS, W, H)
    out = batch.warp_delayed(delayed, accums, PARAMS, W, H)
    return new, out, meas, succ, valid


def test_a_donated_chunk_chain_equals_the_uncaptured_chain(counting):
    """Three 2-frame chunks of 2 streams through the donating program: each
    call byte-equal to the un-captured composition, state included; the
    state is the key's static inputs, and chunks 2-3 copy none of it in."""
    prog = chunked._stabilize_chunk_streams_jit
    frames = _clip(2, 6, 71)
    got = want = chunked.init_stream_state(W, H, PARAMS, 3, 2, CPU)
    for c in range(3):
        x = frames[:, 2 * c:2 * c + 2]
        want = _uncaptured(want, x)
        counting.copies_in = 0
        got = prog(got[0] if c else got, x, PARAMS, W, H)
        entry, = prog._cache.values()
        counting.blocks = {entry.donated_block}
        assert_same(got, want)
        if c:
            assert counting.copies_in == 0
        assert {v.untyped_storage().data_ptr() for v in leaves(got[0])} == {
            entry.donated_block}
        want = want[0]
    assert (prog.captures, prog.replays) == (1, 2)
    stats, = prog.stats()
    assert stats["static_out_bytes"] == graphs.storage_nbytes(leaves(got[1:]))


def test_two_stabilizers_of_one_shape_in_turn_equal_each_alone(stand_in):
    frames = _clip(2, 8, 81).numpy()
    alone = []
    for s in range(2):
        stab = chunked.ChunkedStabilizer(PARAMS, device="cpu")
        alone.append([stab.process_chunk(frames[s, k:k + 2])
                      for k in range(0, 8, 2)])
        graphs.reset()
    stabs = [chunked.ChunkedStabilizer(PARAMS, device="cpu")
             for _ in range(2)]
    for k in range(4):
        for s in range(2):
            assert_same(stabs[s].process_chunk(frames[s, 2 * k:2 * k + 2]),
                        alone[s][k])
    prog = chunked._stabilize_chunk_jit
    assert (prog.captures, prog.replays) == (1, 7)


def test_an_evicted_chunk_key_leaves_its_held_state_usable(stand_in,
                                                            monkeypatch):
    """A stabilizer's key dropped (``max_keys``) by another chunk length
    while it holds the state: its next chunk is still right."""
    prog = chunked._stabilize_chunk_jit
    monkeypatch.setattr(prog, "max_keys", 1)
    frames = _clip(1, 10, 91)[0].numpy()
    ref = chunked.ChunkedStabilizer(PARAMS, device="cpu")
    with graphs.eager():
        want = [ref.process_chunk(frames[k:k + 2]) for k in range(0, 6, 2)]
    stab = chunked.ChunkedStabilizer(PARAMS, device="cpu")
    got = [stab.process_chunk(frames[k:k + 2]) for k in range(0, 4, 2)]
    chunked.ChunkedStabilizer(PARAMS, device="cpu").process_chunk(frames[:4])
    assert prog.evictions == 1
    got.append(stab.process_chunk(frames[4:6]))
    assert_same(got, want)


@pytest.mark.parametrize("lag, tc", [(4, 2), (5, 2), (7, 2), (3, 4)])
def test_the_frame_tail_shifts_in_place(lag, tc):
    """The donating body writes the new tail over the old one: positions
    tc.. of [tail | chunk], tc < lag included (blocks of tc frames in
    ascending order)."""
    rng = np.random.default_rng(lag * 10 + tc)
    tail = torch.from_numpy(rng.integers(0, 256, (2, lag, 3, 5, 3),
                                         dtype=np.uint8))
    frames = torch.from_numpy(rng.integers(0, 256, (2, tc, 3, 5, 3),
                                           dtype=np.uint8))
    want = torch.cat([tail, frames], dim=1)[:, tc:]
    chunked._shift_tail(tail, tail, frames)
    assert torch.equal(tail, want)


def test_the_wrappers_keep_their_state_and_results(stand_in):
    """``stabilize_chunk_streams`` declines the donation on a key a
    donating chain shares: the chain and the wrapper's input and results
    each stay as they were."""
    frames = _clip(1, 6, 101)
    prog = chunked._stabilize_chunk_streams_jit
    chain = chunked.init_stream_state(W, H, PARAMS, 3, 1, CPU)
    chain = prog(chain, frames[:, :2], PARAMS, W, H)[0]
    keep = graphs._tree_map(torch.clone, chain)
    first = chunked.stabilize_chunk_streams(chain, frames[:, 2:4], PARAMS)
    held = graphs._tree_map(torch.clone, first)
    second = chunked.stabilize_chunk_streams(first[0], frames[:, 4:6],
                                             PARAMS)
    assert_same(chain, keep)
    assert_same(first, held)
    chain, *out = prog(chain, frames[:, 2:4], PARAMS, W, H)
    assert_same((chain, *out), first)
    assert_same(second, _uncaptured(_uncaptured(keep, frames[:, 2:4])[0],
                                    frames[:, 4:6]))
    assert prog.captures == 1
