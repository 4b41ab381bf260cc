"""The clip path's, the dense-LK metric's and the sweeps' programs on the
CPU.

The JAX package jits its clip path (models/batch.py:232, 383, 395 and
models/homography_aligner.py:326, 436, 449), its dense-LK jitter metric
(utils/flow.py:141, 154) and the sweeps' bodies (apps/grid_search_align.py
:103, apps/grid_search_smoother.py:61, 75). The port's counterparts are
programs of ``utils/graphs.py``; here the stand-in backend of
``test_torch_graphs.py`` captures and replays them, and each is held
byte-equal to its un-captured composition. Parity with the JAX package is
held by ``test_torch_sweeps.py``, ``test_torch_metrics.py``,
``test_torch_apps.py`` and ``test_torch_homography_chunked.py``."""

import contextlib
import dataclasses
import gc
import io
import json
import weakref

import pytest
import torch

from test_torch_graphs import (  # noqa: F401 (the stand_in fixture)
    CPU, PARAMS, PARAMS_H, H, W, assert_same, clip, stand_in)
from video_stabilizer_tpu_torch import parallel
from video_stabilizer_tpu_torch.apps import app_cost
from video_stabilizer_tpu_torch.apps import grid_search_align as gsa
from video_stabilizer_tpu_torch.apps import grid_search_smoother as gss
from video_stabilizer_tpu_torch.config import StabilizerParams
from video_stabilizer_tpu_torch.models import batch
from video_stabilizer_tpu_torch.models import homography_aligner as ha
from video_stabilizer_tpu_torch.models.aligner import DynAlignParams
from video_stabilizer_tpu_torch.utils import flow, graphs, io as vio

torch.set_num_threads(1)

MODELS = [("similarity", PARAMS), ("homography", PARAMS_H)]
MODEL_IDS = ["similarity", "homography"]
# The JAX names of each model's clip programs: the homography family's are
# the same programs keyed on model="homography".
ALIGN = {"similarity": batch._align_clip_jit,
         "homography": ha._align_clip_h_jit}
ENTRY = {"similarity": (batch.stabilize_streams, batch.stabilize_clip),
         "homography": (ha.stabilize_streams_homography,
                        ha.stabilize_clip_homography)}


def dyn_of(thresholds):
    c = len(thresholds)
    return DynAlignParams(torch.tensor(thresholds),
                          torch.full((c,), 0.8), torch.full((c,), 10.0))


@pytest.mark.parametrize("model, params", MODELS, ids=MODEL_IDS)
@pytest.mark.parametrize("dyn", [None, (0.1, 0.2, 0.05, 0.4)],
                         ids=["no_dyn", "dyn4"])
def test_align_clip_program(stand_in, model, params, dyn):
    """``_align_clip_jit`` (``_align_clip_h_jit``), with no ``dyn`` through
    the entry point, with (4,) fields directly: the capture's and the
    replay's results equal ``align_clip_impl`` un-captured."""
    frames = clip(1, 4, 71)[0]
    dyn = dyn and dyn_of(dyn)
    want = batch.align_clip_impl(frames, params.aligner, W, H, dyn=dyn,
                                 model=model)
    for _ in range(2):
        if dyn is None:
            got = batch.align_clip(frames, params.aligner, CPU, model)
        else:
            got = ALIGN[model](frames, params.aligner, W, H, dyn)
        assert_same(got, want)
    prog = batch._align_clip_jit
    assert (prog.captures, prog.replays, stand_in.replays) == (1, 1, 1)


def test_align_clip_key_holds_t_and_c(stand_in):
    """A new clip length or a new combo count C is a new key and captures
    once more; the same call again replays. The program keeps one key per
    card: each new key first drops and releases the one before (nothing
    holds its static input after), so a key called again after another
    captures anew."""
    prog = batch._align_clip_jit
    frames = clip(1, 4, 73)[0]
    al = PARAMS.aligner
    calls = [(frames[:2], None), (frames, None),
             (frames[:2], dyn_of((0.1,) * 2)),
             (frames[:2], dyn_of((0.1,) * 3))]
    for k, (f, d) in enumerate(calls):
        held = [weakref.ref(e.static_in[0]) for e in prog._cache.values()]
        for _ in range(2):
            prog(f, al, W, H, d)
        gc.collect()
        assert all(r() is None for r in held)
        assert (prog.captures, prog.replays, prog.evictions) == (k + 1,
                                                                 k + 1, k)
        assert len(prog._cache) == 1 and stand_in.released == k
    prog(*calls[0][:1], al, W, H, None)
    assert (prog.captures, prog.replays) == (5, 4)


@pytest.mark.parametrize("model, params", MODELS, ids=MODEL_IDS)
@pytest.mark.parametrize("warp", ["auto", "fir"])
def test_clip_programs(stand_in, model, params, warp):
    """``stabilize_streams`` and ``stabilize_clip`` of either model (their
    entry points) against ``stabilize_clip_core`` + ``warp_delayed``:
    captured, then replayed, equal."""
    params = dataclasses.replace(params, output_warp=warp)
    frames = clip(2, 3, 81)                     # odd T: the padded pair

    def uncaptured(x):
        core = batch.stabilize_clip_core(x, params, W, H, model)
        return (batch.warp_delayed(*core[:2], params, W, H, model),
                *core[2:])
    # One stream alone: torch's CPU atan2 rounds by batch size, so a
    # stream's bits depend on the streams beside it (test_torch_parallel).
    want, want_one = uncaptured(frames), uncaptured(frames[1:])
    streams, one = ENTRY[model]
    for _ in range(2):
        assert_same(streams(frames, params, CPU), want)
    for _ in range(2):
        assert_same(one(frames[1], params, CPU), [x[0] for x in want_one])
    # One clip is the streams program on one stream: a second key, which
    # drops the first.
    prog = batch._stabilize_streams_jit
    assert (prog.captures, prog.replays, prog.evictions) == (2, 2, 1)
    assert stand_in.replays == 2


def test_dense_lk_programs(stand_in):
    """``median_jitter_px_device_impl`` (its ``median_flow_px`` inline) and
    ``median_flow_px`` called alone: captured, replayed, equal to their
    un-captured functions."""
    gray = flow.gray_f32(clip(2, 4, 91))
    pair = (gray[0, :-1], gray[0, 1:])
    with graphs.eager():
        want = flow.median_jitter_px_device_impl(gray)
        want_pair = flow.median_flow_px(*pair, crop=4)
    for _ in range(2):
        assert_same(flow.median_jitter_px_device_impl(gray), want)
        assert_same(flow.median_flow_px(*pair, crop=4), want_pair)
    assert flow.median_jitter_px_device_impl.replays == 1
    assert (flow.median_flow_px.captures, flow.median_flow_px.replays) == (1,
                                                                           1)


SWEEP = StabilizerParams(aligner=gsa.widened_aligner()[0],
                         enable_smoother=False, crop_pixels=gsa.CROP, lag=2,
                         smoother_memory=1)


def test_sweep_programs(stand_in):
    """``run_combos`` (its align inline) and ``eval_combos``: captured,
    replayed, equal to their un-captured bodies; a new C captures again."""
    frames = clip(1, 4, 101)[0]
    gray = torch.from_numpy(gsa.host_gray(frames.numpy()))
    dyn = gsa.dyn_params(gsa.combo_grid()[:2], CPU)
    with graphs.eager():
        want = gsa.run_combos(gray, frames, dyn, SWEEP)
    for _ in range(2):
        assert_same(gsa.run_combos(gray, frames, dyn, SWEEP), want)
    gsa.run_combos(gray, frames, gsa.dyn_params(gsa.combo_grid()[:1], CPU),
                   SWEEP)
    assert (gsa.run_combos.captures, gsa.run_combos.replays) == (2, 1)
    assert batch._align_clip_jit.captures == 0

    meas, ok = want[1][0], want[2][0]
    lams = torch.tensor([1.0, 4.0])
    decays = torch.tensor([[48.0, 64.0, 0.9, 0.7], [32.0, 48.0, 0.95, 0.8]])
    params = StabilizerParams(lag=3, smoother_memory=2)
    with graphs.eager():
        want = gss.eval_combos(frames, meas, ok, params, lams, decays)
    for _ in range(2):
        assert_same(gss.eval_combos(frames, meas, ok, params, lams, decays),
                    want)
    assert gss.eval_combos.replays == 1


def test_sharded_clip_replays_one_graph_per_device(stand_in):
    """``stabilize_streams_sharded`` over ``[cpu] * 2``: each shard equals
    the clip body on its own stream; both shards share one key (one
    device), so the second replays the first's graph."""
    mesh = parallel.make_mesh([CPU] * 2)
    frames = clip(2, 5, 111)
    got = parallel.stabilize_streams_sharded(frames, mesh, PARAMS)
    for k in range(2):
        want = batch._stabilize_streams_body(frames[k:k + 1], PARAMS, W, H)
        assert_same([g.shards[k] for g in got], want)
    prog = batch._stabilize_streams_jit
    assert (prog.captures, prog.replays) == (1, 1)


def run_main(module, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        module.main(argv)


def test_grid_search_align_app_reaches_its_programs(stand_in, monkeypatch):
    """The app's sweep (three of its combos here) replays ``run_combos``,
    and ``--device-metric`` the dense-LK metric's program."""
    grid = gsa.combo_grid()[:3]
    monkeypatch.setattr(gsa, "combo_grid", lambda: grid)
    run_main(gsa, ["--device", "cpu", "--device-metric", "--frames", "12",
                   "--size", "96x128"])
    assert gsa.run_combos.captures == 1
    # The input clip's metric and the combos' outputs: two keys.
    assert flow.median_jitter_px_device_impl.captures == 2


@pytest.mark.skipif(not vio.HAS_CV2, reason="cv2 unavailable")
def test_grid_search_smoother_app_reaches_its_programs(stand_in,
                                                       monkeypatch):
    """The app's one align replays ``_align_clip_jit`` and each (lag,
    memory) pair (two of them here, one lambda) ``eval_combos``."""
    for name, grid in (("LAGS", (6,)), ("MEMORIES", (3, 5)),
                       ("LAMBDAS", (1.0,))):
        monkeypatch.setattr(gss, name, grid)
    run_main(gss, ["--device", "cpu", "--frames", "12", "--size", "96x128"])
    assert batch._align_clip_jit.captures == 1
    assert gss.eval_combos.captures == 2


@pytest.mark.skipif(not vio.HAS_CV2, reason="cv2 unavailable")
def test_app_cost_times_an_app_and_its_functions(monkeypatch, capsys):
    """``app_cost`` runs the smoother sweep (two pairs here) in this
    process: its last line counts and times each ``eval_combos`` call, and
    the app's function is its own again afterwards."""
    for name, grid in (("LAGS", (6,)), ("MEMORIES", (3, 5)),
                       ("LAMBDAS", (1.0,))):
        monkeypatch.setattr(gss, name, grid)
    program = gss.eval_combos
    app_cost.main(["--time", "eval_combos", "grid_search_smoother", "--",
                   "--device", "cpu", "--frames", "12", "--size", "96x128"])
    got = json.loads(capsys.readouterr().out.splitlines()[-1])
    timed = got["timed"]["eval_combos"]
    assert (got["app"], got["device"], timed["calls"]) == (
        "grid_search_smoother", "cpu", 2)
    assert 0 < timed["total_s"] <= got["wall_s"]
    assert gss.eval_combos is program
