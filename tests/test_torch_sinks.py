"""The torch port's frame sinks on the CPU, held against the JAX package:
``CropSink`` and ``apply_crop_rect``, ``PreviewSink``, the headless
``--display``, the ``--debug`` HUD (``pipeline/debug.py``) and the
streaming render's ``DeviceReduceSink``, alone (exact) and inside the
renders that use them: the two-phase and streaming rotation renders and
``encode_2d`` with ``--crop`` and ``--debug``, their frames within one
count of the JAX render's on the same trajectory, and the device sink's
checksum."""

import importlib
import os
from fractions import Fraction

import numpy as np
import pytest
import torch

from test_torch_pipeline import PRESET, read_frames
from test_torch_streaming import assert_same_video, few_threads, replay_analyser  # noqa: F401
from video_annotator_tpu.camera import CameraPreset as JCameraPreset
from video_annotator_tpu.io import prefetch as jprefetch
from video_annotator_tpu.io.video import VideoMeta as JVideoMeta
from video_annotator_tpu.pipeline import debug as jdebug
from video_annotator_tpu.pipeline.render import RenderOptions as JRenderOptions
from video_annotator_tpu.pipeline.render import render as jrender
from video_annotator_tpu_torch.camera import CameraPreset
from video_annotator_tpu_torch.io import prefetch as tprefetch
from video_annotator_tpu_torch.io.video import VideoMeta, open_writer
from video_annotator_tpu_torch.pipeline import debug as tdebug
from video_annotator_tpu_torch.pipeline import render as trender
from video_annotator_tpu_torch.pipeline import streaming
from video_annotator_tpu_torch.pipeline.trajectory import Trajectory, trajectory_path

jrender_mod = importlib.import_module("video_annotator_tpu.pipeline.render")

SRC = "synthetic://shaky?w=192&h=144&n=8&seed=3&shake=0.004"
STREAM_SRC = "synthetic://shaky?w=256&h=192&n=12&seed=5&shake=0.004&pan=0.0"


MAX_DIFFERING = 0.01  # share of values one count apart in a rendered plane


def assert_within_one(got, want):
    """Within one count, at most MAX_DIFFERING of the values apart: a
    cropped chroma plane can hold 1500 values, where the uncropped
    renders' 99.9% bar (test_torch_pipeline) would allow one."""
    d = np.abs(np.asarray(got, np.int16) - np.asarray(want, np.int16))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= MAX_DIFFERING, (d > 0).mean()


def planes(w, h, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w), dtype=np.uint8),
            rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
            rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))


class Recorder:
    def __init__(self):
        self.frames = []
        self.closed = False

    def write(self, p):
        self.frames.append(tuple(np.array(a) for a in p))

    def close(self):
        self.closed = True


# --- the sinks alone --------------------------------------------------------


@pytest.mark.parametrize("rect", [(40, 60, 8, 10), (30, 50, 3, 5), (41, 61, 7, 1),
                                  (96, 128, 0, 0), (2, 2, 95, 127)])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_crop_sink_matches_jax(rect, as_tensor):
    """The same planes from either sink, odd offsets and sizes included
    (the chroma rows and columns floor-halve as in JAX), whether the port
    slices numpy planes or tensors."""
    frame = planes(128, 96, 1)
    want, got = Recorder(), Recorder()
    jrender_mod.CropSink(want, rect).write(frame)
    sink = trender.CropSink(got, rect)
    sink.write(tuple(torch.from_numpy(p) for p in frame) if as_tensor else frame)
    sink.close()
    assert got.closed
    for g, w in zip(got.frames[0], want.frames[0]):
        assert g.shape == w.shape and np.array_equal(g, w)


@pytest.mark.parametrize("spec", [None, "", "iw/2:ih/2", "100:60:13:7", "iw:ih", "2:2:500:500"])
def test_apply_crop_rect_matches_jax(spec):
    o = dict(crop_rect=spec)
    jmeta, jrect = jrender_mod.apply_crop_rect(JVideoMeta(192, 144, Fraction(30), 9),
                                               JRenderOptions(**o))
    tmeta, trect = trender.apply_crop_rect(VideoMeta(192, 144, Fraction(30), 9),
                                           trender.RenderOptions(**o))
    assert trect == jrect
    assert (tmeta.width, tmeta.height, tmeta.fps, tmeta.num_frames) == \
        (jmeta.width, jmeta.height, jmeta.fps, jmeta.num_frames)


def test_preview_sink_writes_jax_pngs(tmp_path):
    """Every ``every``-th frame as a PNG of the same name and pixels; every
    frame passes through."""
    import cv2

    frames = [planes(64, 48, s) for s in range(5)]
    jrec, trec = Recorder(), Recorder()
    jsink = jrender_mod.PreviewSink(jrec, str(tmp_path / "jax"), every=2)
    tsink = trender.PreviewSink(trec, str(tmp_path / "torch"), every=2)
    for f in frames:
        jsink.write(f)
        tsink.write(f)
    tsink.close()
    assert trec.closed and len(trec.frames) == len(jrec.frames) == 5
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch")) == [
        "preview_000000.png", "preview_000002.png", "preview_000004.png"]
    for n in names:
        assert np.array_equal(cv2.imread(str(tmp_path / "torch" / n)),
                              cv2.imread(str(tmp_path / "jax" / n)))


def test_make_display_sink_keeps_jax_headless_behaviour(capsys):
    """Without a GUI both warn once and return the sink unchanged; where a
    GUI works both wrap it."""
    jsink, tsink = object(), object()
    jout = jrender_mod.make_display_sink(jsink)
    jerr = capsys.readouterr().err
    tout = trender.make_display_sink(tsink)
    assert capsys.readouterr().err == jerr
    assert trender.gui_available() == jrender_mod.gui_available()
    if jout is jsink:
        assert tout is tsink and "no usable GUI" in jerr
    else:
        assert isinstance(tout, trender.DisplaySink)


@pytest.mark.parametrize("curves", [False, True])
def test_debug_overlay_writer_matches_jax(curves):
    """The same HUD bytes for the same planes, curves and text."""
    rng = np.random.default_rng(4)
    mats = np.asarray([np.eye(3)] * 6, np.float32)
    mats[:, 0, 1] = rng.normal(size=6) * 0.02
    mats[:, 1, 0] = -mats[:, 0, 1]
    np.testing.assert_array_equal(tdebug.rotation_angles_deg(mats),
                                  jdebug.rotation_angles_deg(mats))
    kw = {}
    if curves:
        kw = dict(total=6, curves={"measured deg": rng.uniform(0, 2, 6),
                                   "correction deg": rng.uniform(0, 1, 6)})
    jrec, trec = Recorder(), Recorder()
    jsink = jdebug.DebugOverlayWriter(jrec, **kw)
    tsink = tdebug.DebugOverlayWriter(trec, **kw)
    for k in range(6):
        jsink.text[k] = tsink.text[k] = f"frame {k}  correction {k * 0.5:.2f} deg"
    del jsink.text[3], tsink.text[3]  # the default line
    for k in range(6):
        f = planes(320, 240, k)
        jsink.write(f)
        tsink.write(f)
    tsink.close()
    assert trec.closed
    for g, w in zip(trec.frames, jrec.frames):
        for gp, wp in zip(g, w):
            assert np.array_equal(gp, wp)
    assert not np.array_equal(trec.frames[0][0], planes(320, 240, 0)[0])


def jax_checksum(frames):
    s = jprefetch.DeviceReduceSink()
    for f in frames:
        s.write(f)
    s.close()
    return s.checksum


def port_checksum(frames):
    s = tprefetch.DeviceReduceSink()
    for f in frames:
        s.write(tuple(torch.from_numpy(np.ascontiguousarray(p)) for p in f))
    s.close()
    return s.checksum


@pytest.mark.parametrize("case", ["small", "wraps", "wraps_twice"])
def test_device_reduce_sink_matches_jax(case):
    """The JAX package's int32 checksum, bit for bit: one 3840x2880 luma
    plane of 255 sums past 2**31, three of them past 2**32."""
    if case == "small":
        frames = [planes(64, 48, s) for s in range(3)]
    else:
        y = np.full((2880, 3840), 255, np.uint8)
        c = np.full((1440, 1920), 255, np.uint8)
        frames = [(y, c, c)] * (1 if case == "wraps" else 3)
    want = jax_checksum(frames)
    assert port_checksum(frames) == want
    total = sum(int(p.sum(dtype=np.int64)) for f in frames for p in f)
    assert want == (total + 2**31) % 2**32 - 2**31
    if case != "small":
        assert total >= 2**31 and want != total
    empty = tprefetch.DeviceReduceSink()
    empty.close()
    assert empty.checksum == 0


# --- the renders ------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_trajectories(tmp_path_factory):
    """The JAX analysers' trajectory files for SRC: rotation, similarity
    (vidstab) and translation (deshake)."""
    d = tmp_path_factory.mktemp("trajectories")
    out = {}
    for family in ("rotation", "vidstab", "deshake"):
        dest = str(d / f"{family}.y4m")
        jrender(SRC, dest, JRenderOptions(stabilise="smooth", analyse_only=True,
                                          filter=family, preset=JCameraPreset(PRESET)))
        out[family] = trajectory_path(dest)
    return out


def encode_both(tmp_path, traj_file, family, **kw):
    """Encode SRC with both packages from the same trajectory file."""
    jdest, tdest = tmp_path / "jax.y4m", tmp_path / "torch.y4m"
    for dest in (jdest, tdest):
        os.link(traj_file, trajectory_path(str(dest)))
    preview = kw.pop("preview", None)
    jkw, tkw = dict(kw), dict(kw)
    if preview:
        jkw["preview"], tkw["preview"] = str(tmp_path / "jpre"), str(tmp_path / "tpre")
    jrender(SRC, str(jdest), JRenderOptions(stabilise="smooth", encode_only=True,
                                            filter=family, preset=JCameraPreset(PRESET),
                                            **jkw))
    trender.render(SRC, str(tdest), trender.RenderOptions(
        stabilise="smooth", encode_only=True, filter=family, preset=CameraPreset(PRESET),
        **tkw), device="cpu")
    return read_frames(jdest), read_frames(tdest)


def cropped_size(src, spec, family="rotation"):
    """(w, h) of the ``spec`` rectangle on the stabilised render's frame."""
    from video_annotator_tpu_torch.io.video import open_reader

    r = open_reader(src)
    meta = r.meta
    r.close()
    if family == "rotation":
        warper = trender.FrameWarper(*trender.build_cameras(meta, trender.RenderOptions(
            stabilise="smooth", preset=CameraPreset(PRESET))), device="cpu")
        w, h = warper.out_w, warper.out_h
    else:
        w, h = meta.width // 2 * 2, meta.height // 2 * 2
    ch, cw, _, _ = trender.parse_crop_rect(spec, w, h)
    return cw, ch


CASES = [
    ("rotation", dict(crop_rect="iw/2:ih/2:(iw-ow)/2:(ih-oh)/2")),
    ("rotation", dict(crop_rect="100:60:13:7")),
    ("rotation", dict(debug=True, roll=10.0)),
    ("rotation", dict(debug=True, roll=10.0, crop_rect="120:90", preview=True,
                      preview_every=3)),
    ("rotation", dict(debug=True, roll=-10.0, rolling_shutter=0.75)),
    ("vidstab", dict(crop_rect="iw-40:ih-30")),
    ("vidstab", dict(debug=True, crop_rect="150:100:5:5")),
    ("deshake", dict(debug=True)),
    ("deshake", dict(crop_rect="min(iw,ih):min(iw,ih)")),
]


@pytest.mark.parametrize("family,kw", CASES)
def test_encode_with_crop_and_debug_matches_jax(tmp_path, jax_trajectories, family, kw):
    """Two-phase ``encode`` and ``encode_2d`` from the JAX analysers'
    trajectory: the cropped size, frames within one count (the HUD drawn
    on the cropped frame in both), and the preview PNGs. The rotation
    HUD prints and plots arccos((trace - 1) / 2) of float32 matrices,
    which one ulp of the trace moves by 1e-3 deg at the clip's 0.4 deg
    corrections: a 10 deg roll keeps the printed and plotted angles
    where the two packages' corrections, equal to float rounding, give
    the same pixels."""
    import cv2

    (jmeta, jframes), (tmeta, tframes) = encode_both(
        tmp_path, jax_trajectories[family], family, **kw)
    assert (tmeta.width, tmeta.height, len(tframes)) == (jmeta.width, jmeta.height, 8)
    if "crop_rect" in kw:
        assert (tmeta.width, tmeta.height) == cropped_size(SRC, kw["crop_rect"], family)
        assert tframes[0][0].shape == (tmeta.height, tmeta.width)
    for tf, jf in zip(tframes, jframes):
        for tp, jp in zip(tf, jf):
            assert tp.shape == jp.shape
            assert_within_one(tp, jp)
    if kw.get("preview"):
        names = sorted(os.listdir(tmp_path / "jpre"))
        assert names == sorted(os.listdir(tmp_path / "tpre")) == [
            f"preview_{i:06d}.png" for i in (0, 3, 6)]
        for n in names:
            got, want = cv2.imread(str(tmp_path / "tpre" / n)), cv2.imread(
                str(tmp_path / "jpre" / n))
            assert got.shape == (90, 120, 3)
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 2


def test_crop_equals_the_uncropped_window(tmp_path, jax_trajectories):
    """The port's cropped frames are the uncropped render's window, byte
    for byte (the crop slices the device's planes before the readback)."""
    full, cropped = tmp_path / "full.y4m", tmp_path / "cropped.y4m"
    for dest in (full, cropped):
        os.link(jax_trajectories["rotation"], trajectory_path(str(dest)))
    o = dict(stabilise="smooth", encode_only=True, preset=CameraPreset(PRESET))
    trender.render(SRC, str(full), trender.RenderOptions(**o), device="cpu")
    spec = "iw/2:ih/2:(iw-ow)/2:(ih-oh)/2"
    trender.render(SRC, str(cropped), trender.RenderOptions(crop_rect=spec, **o),
                   device="cpu")
    (fmeta, fframes), (cmeta, cframes) = read_frames(full), read_frames(cropped)
    ch, cw, cy, cx = trender.parse_crop_rect(spec, fmeta.width, fmeta.height)
    assert (cmeta.width, cmeta.height) == (cw, ch)
    for f, c in zip(fframes, cframes):
        assert np.array_equal(c[0], f[0][cy:cy + ch, cx:cx + cw])
        for k in (1, 2):
            assert np.array_equal(c[k], f[k][cy // 2:(cy + ch) // 2, cx // 2:(cx + cw) // 2])


@pytest.mark.parametrize("kw", [dict(crop_rect="iw/2:ih/2:(iw-ow)/2:(ih-oh)/2"),
                                dict(debug=True, roll=10.0),
                                dict(debug=True, roll=10.0, crop_rect="200:150")])
def test_streaming_with_crop_and_debug_matches_jax(tmp_path, monkeypatch, kw):
    """The streaming render with the JAX render's measured rotations
    replayed through the port's ring: the cropped size, and frames within
    one count of the JAX render's (the HUD text-only in both; rolled for
    the reason test_encode_with_crop_and_debug_matches_jax gives)."""
    jdest, tdest = str(tmp_path / "jax.y4m"), str(tmp_path / "torch.y4m")
    base = dict(stabilise="smooth", streaming=True, stabilise_radius=4, warp_batch=5,
                analysis_mode="tracked")
    jrender(STREAM_SRC, jdest, JRenderOptions(preset=JCameraPreset(PRESET), **base, **kw))
    replay = replay_analyser(Trajectory.load(trajectory_path(jdest)).rotations())
    monkeypatch.setattr(streaming, "Tracker", replay)
    monkeypatch.setattr(streaming, "PairTracker", replay)
    trender.render(STREAM_SRC, tdest, trender.RenderOptions(
        preset=CameraPreset(PRESET), **base, **kw), device="cpu")
    jmeta, _ = read_frames(jdest)
    tmeta, _ = read_frames(tdest)
    assert (tmeta.width, tmeta.height) == (jmeta.width, jmeta.height)
    if "crop_rect" in kw:
        assert (tmeta.width, tmeta.height) == cropped_size(STREAM_SRC, kw["crop_rect"])
    assert_same_video(tdest, jdest)


def write_constant_clip(path, n=6, w=192, h=144):
    """Frames of constant planes, a different value in each: any warp that
    stays inside the frame returns them exactly."""
    wr = open_writer(path, VideoMeta(w, h, Fraction(30, 1), n))
    for t in range(n):
        wr.write((np.full((h, w), 40 + 7 * t, np.uint8),
                  np.full((h // 2, w // 2), 128 - t, np.uint8),
                  np.full((h // 2, w // 2), 90 + 3 * t, np.uint8)))
    wr.close()


def checksums(monkeypatch):
    """Record the checksum of every DeviceReduceSink either package closes."""
    seen = {"jax": [], "torch": []}

    def recording(cls, key):
        class Recording(cls):
            def close(self):
                super().close()
                seen[key].append(self.checksum)
        return Recording

    monkeypatch.setattr(jprefetch, "DeviceReduceSink",
                        recording(jprefetch.DeviceReduceSink, "jax"))
    monkeypatch.setattr(streaming, "DeviceReduceSink",
                        recording(tprefetch.DeviceReduceSink, "torch"))
    return seen


def int32_sum(path):
    _, frames = read_frames(path)
    total = sum(int(p.sum(dtype=np.int64)) for f in frames for p in f)
    return (total + 2**31) % 2**32 - 2**31


@pytest.mark.parametrize("src", ["constant", STREAM_SRC])
def test_streaming_device_sink_gives_the_jax_checksum(tmp_path, monkeypatch, src):
    """A streaming render with ``device_sink``, the JAX render's measured
    rotations replayed: no file written, and the checksum of each package
    is the int32 sum of the frames its own written render gives. On a
    clip of constant frames cropped to the covered region both write the
    same bytes, so the two checksums are equal; on the synthetic clip its
    frames are within one count of JAX's (the other tests here)."""
    if src == "constant":
        src = str(tmp_path / "constant.y4m")
        write_constant_clip(src)
    constant = src.endswith(".y4m")
    # The constant clip's canvas: the covered region zoomed in 1.4x (a
    # negative stabilise buffer), so that no output pixel's taps reach
    # past the frame's edge under the clip's corrections.
    base = dict(stabilise="smooth", streaming=True, stabilise_radius=4, warp_batch=5,
                analysis_mode="tracked", crop_borders=constant,
                stabilise_buffer=-30.0 if constant else 20.0)
    jdest, tdest = str(tmp_path / "jax.y4m"), str(tmp_path / "torch.y4m")
    jrender(src, jdest, JRenderOptions(preset=JCameraPreset(PRESET), **base))
    replay = replay_analyser(Trajectory.load(trajectory_path(jdest)).rotations())
    monkeypatch.setattr(streaming, "Tracker", replay)
    monkeypatch.setattr(streaming, "PairTracker", replay)
    trender.render(src, tdest, trender.RenderOptions(preset=CameraPreset(PRESET), **base),
                   device="cpu")
    seen = checksums(monkeypatch)
    sink = dict(no_output=True, device_sink=True)
    jrender(src, None, JRenderOptions(preset=JCameraPreset(PRESET), **base, **sink))
    trender.render(src, None, trender.RenderOptions(preset=CameraPreset(PRESET), **base,
                                                    **sink), device="cpu")
    assert len(seen["jax"]) == len(seen["torch"]) == 1
    assert seen["jax"][0] == int32_sum(jdest)
    assert seen["torch"][0] == int32_sum(tdest)
    if constant:
        assert seen["torch"][0] == seen["jax"][0]
        assert read_frames(tdest)[1][0][0].std() == 0  # the frames stayed constant
