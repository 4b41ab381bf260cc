"""The port's scale-out layer on the CPU: streams split over a mesh of CPU
entries (``parallel/mesh.py``) held bit-equal to the unsharded port, each
shard independent of the others, the multi-process recipe
(``parallel/multihost.py``) in one process and in two
(``apps/multihost_smoke.py``), the dry run (``graft_entry.py``), and the
seed-61 stream of a sharded run held to the JAX package's chunked path.

Configuration: tests/test_torch_chunked.py's (96x128, 16 frames, chunks of
8, lag 4, memory 2, crop 8), 8 streams of its content, seeds 61-68."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from video_stabilizer_tpu import config as jcfg
from video_stabilizer_tpu import parallel as jparallel
from video_stabilizer_tpu.models import chunked as jchunked
from video_stabilizer_tpu_torch import graft_entry, parallel
from video_stabilizer_tpu_torch.config import (
    StabilizerParams, params_from_jax_dict)
from video_stabilizer_tpu_torch.models import batch, chunked
from video_stabilizer_tpu_torch.parallel.mesh import Sharded, tensor_leaves
from video_stabilizer_tpu_torch.utils import graphs
from video_stabilizer_tpu_torch.utils.io import synth_shaky_clip


H, W, N = 96, 128, 16
HALF = N // 2
JPARAMS = jcfg.StabilizerParams(lag=4, smoother_memory=2, crop_pixels=8,
                                output_warp="pallas")
PARAMS = params_from_jax_dict(dataclasses.asdict(JPARAMS))
SEEDS = tuple(range(61, 69))   # stream 0 is seed 61, held to JAX
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clip(seed):
    return synth_shaky_clip(N, H, W, seed=seed, jitter_px=0.8,
                            pan_px_per_frame=0.3)


def _mesh(n):
    return parallel.make_mesh([CPU] * n)


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """A few torch threads for this module, restored after it: its port
    runs are eager ops with the JAX runtime idle (its one program runs
    alone), so they meet none of the contention that one thread avoids in
    files that interleave the two runtimes."""
    before = torch.get_num_threads()
    torch.set_num_threads(3)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def smoke():
    """The two-process smoke, started first so that it runs beside the
    tests below; its test reads it."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "video_stabilizer_tpu_torch.apps."
         "multihost_smoke"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def clips(smoke):
    return np.stack([_clip(s) for s in SEEDS])


_atan2 = torch.atan2


def _atan2_on_the_vector_path(y, x):
    """``torch.atan2`` with every element computed by the CPU's vector
    loop: each call padded to a multiple of 64 elements. On the CPU, torch
    computes the elements of a call that fall outside its unrolled vector
    loop (all of them in a call of 16 on an AVX-512 host) with scalar
    code that rounds differently, so a result depends on how many items
    share the call."""
    y, x = torch.broadcast_tensors(y, x)
    n = y.numel()
    pad = (-n) % 64
    yf = torch.cat([y.reshape(-1), y.new_ones(pad)])
    xf = torch.cat([x.reshape(-1), x.new_ones(pad)])
    return _atan2(yf, xf)[:n].reshape(y.shape)


@pytest.fixture(scope="module")
def runs(clips):
    """The 8 streams through the unsharded path (n None) and the sharded
    path on 2 and 4 CPU entries, each run once: ``runs(path, n, exact)``.
    ``path`` "chunked" gives the states after each of two chunks and each
    chunk's (out, meas, ok, valid); "clip" gives (out, meas, ok).
    ``exact`` runs with ``_atan2_on_the_vector_path``."""
    cache = {}

    def run(path, n, exact):
        key = path, n, exact
        if key in cache:
            return cache[key]
        mesh = None if n is None else _mesh(n)
        with pytest.MonkeyPatch.context() as mp:
            if exact:
                mp.setattr(torch, "atan2", _atan2_on_the_vector_path)
            if path == "clip":
                cache[key] = (
                    batch.stabilize_streams(clips, PARAMS, "cpu")
                    if mesh is None else
                    parallel.stabilize_streams_sharded(clips, mesh, PARAMS))
                return cache[key]
            if mesh is None:
                state = chunked.init_stream_state(W, H, PARAMS, 3, 8, "cpu")
            else:
                state = parallel.init_sharded_stream_states(8, W, H, PARAMS,
                                                            mesh)
            states, results = [], []
            for c in range(2):
                frames = clips[:, c * HALF:(c + 1) * HALF]
                if mesh is None:
                    state, *res = chunked.stabilize_chunk_streams(
                        state, torch.from_numpy(frames), PARAMS)
                else:
                    state, *res = parallel.stabilize_chunk_streams_sharded(
                        state, frames, mesh, PARAMS)
                # The sharded chunk donates its states: keep a copy.
                states.append(_copy(state))
                results.append(res)
        cache[key] = states, results
        return cache[key]
    return run


def _copy(state):
    if isinstance(state, Sharded):
        return Sharded(tuple(map(_copy, state.shards)), state.offsets)
    return graphs._tree_map(torch.clone, state)


def _cat(value):
    return torch.cat(value.shards) if isinstance(value, Sharded) else value


@pytest.mark.parametrize("path", ["chunked", "clip"])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_matches_unsharded_bit_for_bit(runs, path, n):
    """Every stream is an independent item, so a shard changes only how
    many streams share a call: bit-equal outputs, measurements, flags and
    carried state, once the one operator whose CPU rounding depends on
    the call's size, ``torch.atan2`` (the Jacobi rotation angle in
    ``ops/linalg.py``), is put on one code path for every element."""
    want, got = runs(path, None, True), runs(path, n, True)
    if path == "clip":
        for g, w in zip(got, want):
            assert g.offsets == tuple(range(0, 8, 8 // n))
            assert torch.equal(_cat(g), w)
        return
    (want_states, want), (got_states, got) = want, got
    for c in range(2):
        for g, w in zip(got[c], want[c]):
            assert torch.equal(_cat(g), w)
        sharded = got_states[c]
        assert sharded.offsets == tuple(range(0, 8, 8 // n))
        for shard, offset in zip(sharded.shards, sharded.offsets):
            for g, w in zip(tensor_leaves(shard),
                            tensor_leaves(want_states[c])):
                assert torch.equal(g, w[offset:offset + 8 // n])


def _lsb_diff(a, b):
    return np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))


def test_sharded_chunked_as_it_runs(runs):
    """The chunked path on 4 CPU entries as it runs, with torch's own
    ``atan2``: its last-bit differences in a Jacobi angle can flip a GN
    stop decision, which moves a converged transform by hundredths of a
    pixel, so this is held to the GN class of test_torch_failure.py's
    bars: ok and valid equal, TX/TY 0.1 px, A/B 1e-3, >= 99 % of pixels
    within 1 LSB. Measured on this clip: TX/TY 0.063 px, A/B 6.3e-4."""
    _, want = runs("chunked", None, True)
    _, got = runs("chunked", 4, False)
    for c in range(2):
        out, meas, ok, valid = (_cat(g) for g in got[c])
        w_out, w_meas, w_ok, w_valid = want[c]
        assert torch.equal(ok, w_ok) and torch.equal(valid, w_valid)
        np.testing.assert_allclose(meas[..., 2:], w_meas[..., 2:], atol=0.1)
        np.testing.assert_allclose(meas[..., :2], w_meas[..., :2],
                                   atol=1e-3)
        assert np.mean(_lsb_diff(out, w_out) <= 1) >= 0.99


def test_shards_are_independent(clips, runs):
    """Stands in for the JAX package's zero-collective HLO pin
    (test_sharding.py): new frames for shard 0's streams in chunk 2 change
    shard 0's results and leave every other shard's outputs and carried
    state bit-unchanged."""
    states, results = runs("chunked", 4, False)
    frames = clips[:, HALF:].copy()
    frames[:2] = _clip(99)[HALF:]
    new_states, *res = parallel.stabilize_chunk_streams_sharded(
        _copy(states[0]), frames, _mesh(4), PARAMS)
    assert not torch.equal(res[0].shards[0], results[1][0].shards[0])
    for k in range(1, 4):
        for g, w in zip(res, results[1]):
            assert torch.equal(g.shards[k], w.shards[k])
        for g, w in zip(tensor_leaves(new_states.shards[k]),
                        tensor_leaves(states[1].shards[k])):
            assert torch.equal(g, w)


def test_indivisible_stream_counts_raise():
    mesh = _mesh(2)
    with pytest.raises(ValueError, match="not divisible"):
        parallel.shard_streams(np.zeros((3, 2, 8, 8, 3), np.uint8), mesh)
    with pytest.raises(ValueError, match="not divisible"):
        parallel.init_sharded_stream_states(3, W, H, PARAMS, mesh)
    with pytest.raises(ValueError, match="not divisible"):
        parallel.stabilize_streams_sharded(
            np.zeros((5, 4, 48, 64, 3), np.uint8), _mesh(4), PARAMS)
    with pytest.raises(ValueError, match="not divisible"):
        parallel.make_global_stream_batch(
            np.zeros((3, 2, 8, 8, 3), np.uint8), mesh, 3)


def test_multihost_recipe_single_process(monkeypatch):
    """The recipe in one process (test_sharding.py:145-166): the slice is
    every stream, the batch built from the local streams gives the same
    output as the stream-split path on the whole array."""
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    parallel.initialize_multihost()        # no coordinator: a no-op
    assert not torch.distributed.is_initialized()
    mesh = parallel.multihost_mesh([CPU] * 8)
    assert mesh.size == 8
    sl = parallel.local_stream_slice(8)
    assert (sl.start, sl.stop) == (0, 8)
    clips = np.stack([synth_shaky_clip(8, 48, 64, seed=80 + s, jitter_px=0.5)
                      for s in range(8)])
    params = StabilizerParams(lag=2, smoother_memory=1, crop_pixels=4)
    global_batch = parallel.make_global_stream_batch(clips[sl], mesh, 8)
    assert global_batch.offsets == tuple(range(8))
    assert torch.equal(_cat(global_batch), torch.from_numpy(clips))
    out, _, _ = parallel.stabilize_streams_sharded(global_batch, mesh,
                                                   params)
    out2, _, _ = parallel.stabilize_streams_sharded(clips, mesh, params)
    assert torch.equal(_cat(out), _cat(out2))


def test_multihost_smoke_two_processes(smoke):
    out, _ = smoke.communicate(timeout=120)
    assert smoke.returncode == 0, out
    assert "multihost smoke OK" in out
    assert out.count("match the single-process pipeline") == 2


def test_dryrun_multichip():
    graft_entry.dryrun_multichip(2, devices=[CPU] * 2)


def test_scale_out_without_a_card_raises(monkeypatch):
    """No silent fall-back to the CPU: the dry run and the default meshes
    want CUDA devices."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="need 2 CUDA devices"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.multihost_mesh()


def test_exports_match_jax():
    assert parallel.__all__ == jparallel.__all__
    for name in parallel.__all__:
        assert callable(getattr(parallel, name))


def test_seed61_stream_matches_jax(clips, runs):
    """The sharded run's seed-61 stream against the JAX package's chunked
    path over the same two chunks (Pallas output warp in interpret mode),
    with test_torch_chunked.py's bars (``_assert_close_to_jax``): ok equal,
    TX/TY 0.1 px, A/B 6e-4, >= 99 % of pixels within 1 LSB."""
    frames = clips[0]
    state = jax.jit(jchunked.init_stream_state, static_argnums=(0, 1, 2, 3))(
        W, H, JPARAMS, 3)
    outs, metas, oks = [], [], []
    for c in range(2):
        state, out, meas, ok, valid = jchunked._stabilize_chunk_jit(
            state, frames[c * HALF:(c + 1) * HALF], JPARAMS, W, H)
        outs.append(np.asarray(out)[np.asarray(valid)])
        metas.append(np.asarray(meas))
        oks.append(np.asarray(ok))
    want_out, want_meas, want_ok = (np.concatenate(outs),
                                    np.concatenate(metas),
                                    np.concatenate(oks))

    _, results = runs("chunked", 4, False)
    got_out = np.concatenate(
        [out.shards[0][0][valid.shards[0][0]].numpy()
         for out, _, _, valid in results])
    got_meas = np.concatenate([m.shards[0][0].numpy()
                               for _, m, _, _ in results])
    got_ok = np.concatenate([k.shards[0][0].numpy()
                             for _, _, k, _ in results])
    np.testing.assert_array_equal(got_ok, want_ok)
    np.testing.assert_allclose(got_meas[..., 2:], want_meas[..., 2:],
                               atol=0.1)
    np.testing.assert_allclose(got_meas[..., :2], want_meas[..., :2],
                               atol=6e-4)
    assert got_out.shape == want_out.shape
    assert np.mean(_lsb_diff(got_out, want_out) <= 1) >= 0.99
