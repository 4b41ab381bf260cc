"""The port's host I/O and apps on the CPU: the native mirror
(``utils/native.py``) and ``utils/io.py`` held to the JAX package's on the
same files (``.y4m`` through the native reader, mp4 through cv2), and each
app of ``video_stabilizer_tpu_torch/apps`` run end to end at 96x128 with
``--device cpu``, printing the JAX app's lines."""

import contextlib
import io as pyio
import re

import numpy as np
import pytest
import torch

from video_stabilizer_tpu.utils import io as jio
from video_stabilizer_tpu.utils import native as jnative
from video_stabilizer_tpu.utils.jitter import median_jitter_px as j_jitter
from video_stabilizer_tpu_torch.apps import (
    align_test, eval_jitter, grid_search_align, grid_search_smoother,
    lanczos2_opt, video_test)
from video_stabilizer_tpu_torch.utils import io, native

torch.set_num_threads(1)

needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native framepipe unavailable")
needs_cv2 = pytest.mark.skipif(not io.HAS_CV2, reason="cv2 unavailable")


def write_y4m(path, gray_frames):
    """A 420jpeg YUV4MPEG2 file of gray frames (chroma 128), as
    tests/test_native.py writes one."""
    t, h, w = gray_frames.shape
    chroma = np.full((h // 2, w // 2), 128, np.uint8)
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 C420jpeg\n".encode())
        for y in gray_frames:
            f.write(b"FRAME\n" + y.tobytes() + chroma.tobytes()
                    + chroma.tobytes())


def run_app(module, argv):
    """(return value, stdout lines) of an app's main."""
    out = pyio.StringIO()
    with contextlib.redirect_stdout(out):
        ret = module.main(argv)
    return ret, out.getvalue().splitlines()


@needs_native
def test_native_mirror_matches_jax(tmp_path):
    """The ctypes mirror loads the same library: the same gray, the same
    staged batches and Y4M frames as the JAX package's binding."""
    rng = np.random.default_rng(3)
    bgr = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    np.testing.assert_array_equal(native.bgr_to_gray(bgr),
                                  jnative.bgr_to_gray(bgr))
    stager = native.BatchStager(24, 32, batch_frames=2)
    try:
        frames = [rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
                  for _ in range(2)]
        for f in frames:
            stager.submit(f)
        batch = stager.pop()
        np.testing.assert_array_equal(batch, np.stack(frames))
        stager.recycle(batch)
        with pytest.raises(ValueError):
            stager.submit(bgr[:, :16])
    finally:
        stager.close()
    gray = rng.integers(16, 235, (3, 24, 32), dtype=np.uint8)
    write_y4m(tmp_path / "g.y4m", gray)
    r, rj = native.Y4MReader(str(tmp_path / "g.y4m")), jnative.Y4MReader(
        str(tmp_path / "g.y4m"))
    try:
        got, want = list(r.frames_gray()), list(rj.frames_gray())
    finally:
        r.close()
        rj.close()
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    np.testing.assert_array_equal(np.stack(got), gray)


@needs_native
def test_read_video_y4m_matches_jax(tmp_path):
    """``.y4m`` through the native reader: the JAX package's frames, which
    for gray content with neutral chroma are the gray in every channel."""
    gray = io.synth_shaky_clip(6, 48, 64, seed=5, color=False)
    write_y4m(tmp_path / "c.y4m", gray)
    path = str(tmp_path / "c.y4m")
    got = np.stack(list(io.read_video(path)))
    np.testing.assert_array_equal(got, np.stack(list(jio.read_video(path))))
    np.testing.assert_array_equal(got, io.gray_to_bgr(gray))
    assert len(list(io.read_video(path, max_frames=4))) == 4


@needs_cv2
def test_mp4_round_trip_and_helpers_match_jax(tmp_path):
    """An mp4 written by the port reads back through both packages'
    ``read_video`` as the same frames, and as the frames of the JAX
    package's writer; ``ensure_test_clip``, ``gray_to_bgr`` and
    ``make_textured_image`` give the JAX package's."""
    clip = io.synth_shaky_clip(6, 48, 64, seed=6)
    with io.VideoWriter(str(tmp_path / "p.mp4")) as w:
        for f in clip:
            w.write(f)
    with jio.VideoWriter(str(tmp_path / "j.mp4")) as w:
        for f in clip:
            w.write(f)
    got = np.stack(list(io.read_video(str(tmp_path / "p.mp4"))))
    assert got.shape == clip.shape
    np.testing.assert_array_equal(
        got, np.stack(list(jio.read_video(str(tmp_path / "p.mp4")))))
    np.testing.assert_array_equal(
        got, np.stack(list(io.read_video(str(tmp_path / "j.mp4")))))
    p = io.ensure_test_clip(str(tmp_path / "t" / "clip.mp4"), 4, 48, 64)
    pj = jio.ensure_test_clip(str(tmp_path / "tj" / "clip.mp4"), 4, 48, 64)
    np.testing.assert_array_equal(np.stack(list(io.read_video(p))),
                                  np.stack(list(io.read_video(pj))))
    gray = clip[0, ..., 0]
    np.testing.assert_array_equal(io.gray_to_bgr(gray),
                                  jio.gray_to_bgr(gray))
    np.testing.assert_array_equal(io.make_textured_image(40, 56, seed=2),
                                  jio.make_textured_image(40, 56, seed=2))


VIDEO_LINE = re.compile(
    r"synthetic_0: 16 frames in [\d.]+s \([\d.]+ fps\), align failures "
    r"(\d+), jitter ([\d.]+) -> ([\d.]+) px \(ratio ([\d.]+)\) -> .*"
    r"processed_synthetic_0\.mp4")


@needs_cv2
@pytest.mark.parametrize("mode", ["streaming", "batch", "chunked"])
def test_video_test_app(tmp_path, mode):
    """``video_test --synthetic 1`` in each mode: the JAX app's lines, no
    align failure, the output mp4 written and its jitter below 0.6x the
    input's (crop 0, as video_test.cpp:54)."""
    _, lines = run_app(video_test, [
        "--device", "cpu", "--synthetic", "1", "--frames", "16", "--size",
        "96x128", "--mode", mode, "--out", str(tmp_path)])
    assert lines[0] == "no recordings found — synthesizing 1 clips"
    m = VIDEO_LINE.fullmatch(lines[1])
    assert m, lines
    assert int(m.group(1)) == 0 and float(m.group(4)) < 0.6
    outs = list(io.read_video(str(tmp_path / "processed_synthetic_0.mp4")))
    assert len(outs) == 6 and outs[0].shape == (96, 128, 3)


@needs_cv2
def test_eval_jitter_app(tmp_path):
    """``eval_jitter`` on an mp4 and a y4m: the JAX app's line per video,
    with the JAX package's metric value."""
    clip = io.synth_shaky_clip(5, 48, 64, seed=8)
    with io.VideoWriter(str(tmp_path / "a.mp4")) as w:
        for f in clip:
            w.write(f)
    paths = [str(tmp_path / "a.mp4")]
    if native.available():
        write_y4m(tmp_path / "b.y4m", clip[..., 0])
        paths.append(str(tmp_path / "b.y4m"))
    _, lines = run_app(eval_jitter, ["--device", "cpu", "--dir",
                                     str(tmp_path)])
    assert len(lines) == len(paths)
    for line, path in zip(lines, paths):
        assert line == (f"{path}: median_jitter_px = "
                        f"{j_jitter(jio.read_video(path)):.4f}")


def test_grid_search_align_app_device_metric():
    """``grid_search_align --device-metric``: the JAX app's lines, the
    window margin widened to 22 for max_displacement 20, all 27 combos
    scored in one sweep."""
    _, lines = run_app(grid_search_align, [
        "--device", "cpu", "--device-metric", "--frames", "12", "--size",
        "96x128"])
    assert re.fullmatch(r"input: 12 frames 128x96, jitter [\d.]+px",
                        lines[0])
    assert lines[1] == ("widening window_margin 12 -> 22 to cover "
                        "max_displacement=20.0")
    assert re.fullmatch(r"phase_correlate=False: 27 combos in [\d.]+s",
                        lines[2])
    assert lines[4] == (" top 10 combos (out/in jitter ratio, align "
                        "failures):")
    rows = [re.fullmatch(r"  ratio=([\d.]+) fail=\s*(\d+)  phase=False "
                         r"threshold=[\d.]+ fraction=[\d.]+ max_disp=[\d.]+",
                         ln) for ln in lines[5:15]]
    assert all(rows) and float(rows[0].group(1)) < 0.6
    assert lines[16].startswith("best: phase_correlate=False threshold=")


@needs_cv2
def test_grid_search_smoother_app():
    """``grid_search_smoother``: the JAX app's lines over the 8 valid
    (lag, memory) pairs x 12 (lambda, decay) combos."""
    _, lines = run_app(grid_search_smoother, [
        "--device", "cpu", "--frames", "18", "--size", "96x128"])
    assert re.fullmatch(r"input: 18 frames 128x96, jitter [\d.]+px",
                        lines[0])
    assert lines[1] == "aligned once: 0 failures"
    assert re.fullmatch(r"swept 96 combos in [\d.]+s", lines[2])
    assert lines[4] == " top 10 combos:"
    assert all(re.fullmatch(r"  ratio=[\d.]+  lag=\d+ memory=\d+ "
                            r"lambda=[\d.]+ decay=\(.*\)", ln)
               for ln in lines[5:15])


@needs_cv2
def test_align_test_app(tmp_path):
    """``align_test`` passes every check and writes its image dumps."""
    ret, lines = run_app(align_test, ["--device", "cpu", "--out",
                                      str(tmp_path)])
    assert ret == 0 and lines[-1] == "0 failure(s)", lines
    assert (tmp_path / "aligned.png").exists()
    assert (tmp_path / "pyramid_0.png").exists()


def test_lanczos2_opt_app():
    """``lanczos2_opt``: the JAX app's degree-12 least-squares fit (max
    error 5.5e-4 on its dense grid, the reference's published fit 3.84e-4),
    the shipped coefficients within 1e-3 of it, the port's windows timed;
    ``--sweep`` prints one row per degree."""
    _, lines = run_app(lanczos2_opt, ["--device", "cpu"])
    assert lines[0] == "degree-12 even polynomial fit of lanczos2 on [-2, 2]"
    assert float(lines[1].split()[3]) < 1e-3
    drift = [ln for ln in lines if ln.startswith("max drift vs shipped")]
    assert drift and float(drift[0].split()[-1]) < 1e-3
    assert lines[-1].startswith("port on cpu: poly ")
    _, lines = run_app(lanczos2_opt, ["--sweep"])
    assert len(lines) == 7


@pytest.mark.parametrize("module,argv", [
    (video_test, ["--synthetic", "1"]),
    (grid_search_align, ["--device-metric"]),
    (grid_search_smoother, []),
    (lanczos2_opt, []),
])
def test_apps_default_to_the_card(monkeypatch, module, argv):
    """Without ``--device`` an app runs on the CUDA card, and raises when
    there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_app(module, argv)


def test_models_and_utils_exports_match_jax():
    """``models`` and ``utils`` export the JAX package's names, in order."""
    from video_stabilizer_tpu import models as jmodels
    from video_stabilizer_tpu import utils as jutils
    from video_stabilizer_tpu_torch import models as tmodels
    from video_stabilizer_tpu_torch import utils as tutils

    assert tmodels.__all__ == jmodels.__all__
    assert tutils.__all__ == jutils.__all__
    for mod in (tmodels, tutils):
        for name in mod.__all__:
            assert getattr(mod, name) is not None
