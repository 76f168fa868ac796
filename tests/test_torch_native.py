"""The torch port's native (C++/libav) video IO held against the JAX
package's: decoded planes, trimmed seeks, the libx264 default, the MP4
tracks and GPMF samples the writer copies over a trim window, a render to
``.mp4`` through the CLI's options, and the ``--no-native-io`` route.

Both packages load the same ``native/*.so``; the tests skip only where
the port's own binding finds them unbuilt (``make -C native``)."""

from fractions import Fraction

import numpy as np
import pytest

from test_torch_streaming import few_threads  # noqa: F401 (autouse fixture)
from video_annotator_tpu.io import native as jnative
from video_annotator_tpu.io import video as jvideo
from video_annotator_tpu.pipeline.render import RenderOptions as JRenderOptions
from video_annotator_tpu.pipeline.render import _passthrough_kwargs as jpassthrough
from video_annotator_tpu_torch import cli as tcli
from video_annotator_tpu_torch.io import native as tnative
from video_annotator_tpu_torch.io import video as tvideo
from video_annotator_tpu_torch.io.gpmf import build_gpmf_payload
from video_annotator_tpu_torch.io.mp4 import (
    find_gpmf_track,
    mux_gpmf_track,
    parse_tracks,
    read_track_samples,
    write_gpmf_mp4,
)
from video_annotator_tpu_torch.pipeline import render as trender

PRESET = "gopro_h4b_wide43_measured"


@pytest.fixture(autouse=True)
def native_built():
    if not (tnative.native_available() and tnative.native_writer_available()):
        pytest.skip("native libraries not built (make -C native)")


def write_clip(path, w=128, h=96, n=12, seed=0):
    wr = tvideo.open_writer(str(path), tvideo.VideoMeta(w, h, Fraction(30, 1)),
                            encoder="libx264")
    assert isinstance(wr, tnative.NativeVideoWriter)
    rng = np.random.default_rng(seed)
    for i in range(n):
        y = (rng.uniform(0, 255, (h, w)) * 0.3 + i * 15).astype(np.uint8)
        u = np.full((h // 2, w // 2), 120 + i, np.uint8)
        v = np.full((h // 2, w // 2), 130 - i, np.uint8)
        wr.write((y, u, v))
    wr.close()
    return str(path)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return write_clip(tmp_path_factory.mktemp("native") / "clip.mp4")


def gpmf_payloads(n=5):
    """``n`` GPMF samples, each a distinct gyro block."""
    return [build_gpmf_payload(np.full((8, 3), [0.1 * k, 0.2, 0.3], np.float32))
            for k in range(n)]


def decode(reader):
    frames = [tuple(np.array(p) for p in f) for f in reader]
    reader.close()
    return frames


def test_decoded_planes_equal_jax(clip):
    got = tnative.NativeVideoSource(clip)
    want = jnative.NativeVideoSource(clip)
    assert (got.meta.width, got.meta.height, got.meta.fps, got.meta.num_frames) == \
        (want.meta.width, want.meta.height, want.meta.fps, want.meta.num_frames)
    got_frames, want_frames = decode(got), decode(want)
    assert len(got_frames) == len(want_frames) == 12
    for g, w in zip(got_frames, want_frames):
        for gp, wp in zip(g, w):
            np.testing.assert_array_equal(gp, wp)


def test_open_reader_routes_compressed_files_to_the_native_loader(clip):
    reader = tvideo.open_reader(clip)
    assert isinstance(reader, tnative.NativeVideoSource)
    reader.close()
    reader = tvideo.open_reader(clip, prefer_native=False)
    assert isinstance(reader, tvideo._CvSource)
    reader.close()


@pytest.mark.parametrize("start", [1, 5, 11])
def test_trimmed_seek_starts_at_the_same_frame(clip, start):
    got = tvideo.open_reader(clip, start_frame=start)
    want = jvideo.open_reader(clip, start_frame=start)
    assert got.start_frame == want.start_frame == start
    got_frames, want_frames = decode(got), decode(want)
    whole = decode(tnative.NativeVideoSource(clip))
    assert len(got_frames) == len(want_frames) == 12 - start
    for g, w, full in zip(got_frames, want_frames, whole[start:]):
        for gp, wp, fp in zip(g, w, full):
            np.testing.assert_array_equal(gp, wp)
            np.testing.assert_array_equal(gp, fp)


def test_default_encoder_is_libx264():
    assert tvideo.default_encoder() == jvideo.default_encoder() == "libx264"
    args = tcli.build_parser().parse_args(["render", "in.mp4", "out.mp4"])
    assert tcli._render_options(args).encoder == "libx264"


@pytest.mark.parametrize("encoder,native_name", [
    ("libx264", "libx264"), ("h264", "libx264"), ("mpeg4", "mpeg4")])
def test_native_encoders_round_trip(tmp_path, encoder, native_name, monkeypatch):
    """The libav names and their aliases reach the native writer under
    their libav name, and the file decodes back at full length."""
    names = []
    real = tnative.NativeVideoWriter.__init__

    def spy(self, path, meta, encoder="libx264", **kw):
        names.append(encoder)
        real(self, path, meta, encoder=encoder, **kw)

    monkeypatch.setattr(tnative.NativeVideoWriter, "__init__", spy)
    path = str(tmp_path / "rt.mp4")
    w, h, n = 64, 48, 10
    wr = tvideo.open_writer(path, tvideo.VideoMeta(w, h, Fraction(30, 1)), encoder=encoder)
    y = np.tile(np.arange(w, dtype=np.uint8) * 3, (h, 1))
    for i in range(n):
        wr.write((y + i, np.full((h // 2, w // 2), 128, np.uint8),
                  np.full((h // 2, w // 2), 128, np.uint8)))
    wr.close()
    assert names == [native_name]
    frames = decode(tvideo.open_reader(path))
    assert len(frames) == n and frames[0][0].shape == (h, w)


@pytest.mark.parametrize("opts", [
    dict(), dict(start=1.0, end=3.5), dict(start=0.5, duration=2.0), dict(native_io=False)])
@pytest.mark.parametrize("source", ["in.mp4", "in.y4m", "synthetic://shaky?n=4"])
def test_passthrough_kwargs_match_jax(source, opts):
    got = trender._passthrough_kwargs(source, trender.RenderOptions(**opts))
    want = jpassthrough(source, jvideo.VideoMeta(64, 48, Fraction(30, 1), 10),
                        JRenderOptions(**opts))
    assert got == want


def write_trimmed(open_writer, meta_cls, out, src):
    """75 frames (2.5 s) written with ``src``'s streams over [1.0, 3.5)."""
    w, h = 128, 96
    wr = open_writer(out, meta_cls(w, h, Fraction(30, 1)), encoder="libx264",
                     copy_streams_from=src, trim_start=1.0, trim_end=3.5)
    for i in range(75):
        wr.write((np.full((h, w), (i * 3) % 255, np.uint8),
                  np.full((h // 2, w // 2), 128, np.uint8),
                  np.full((h // 2, w // 2), 128, np.uint8)))
    wr.close()
    return out


def samples(path):
    track = find_gpmf_track(path)
    assert track is not None, path
    return [(bytes(s), t) for s, t in read_track_samples(path, track)]


def test_written_mp4_tracks_and_gpmf_match_jax(tmp_path):
    src = str(tmp_path / "src.mp4")
    payloads = gpmf_payloads()
    write_gpmf_mp4(src, payloads)  # samples at 0, 1.001, 2.002, 3.003, 4.004 s
    got = write_trimmed(tvideo.open_writer, tvideo.VideoMeta, str(tmp_path / "t.mp4"), src)
    want = write_trimmed(jvideo.open_writer, jvideo.VideoMeta, str(tmp_path / "j.mp4"), src)
    kinds = [t.handler_type for t in parse_tracks(got)]
    assert kinds == [t.handler_type for t in parse_tracks(want)]
    assert b"vide" in kinds and b"meta" in kinds
    got_s, want_s = samples(got), samples(want)
    assert got_s == want_s
    assert [s for s, _ in got_s] == payloads[1:4]
    assert got_s[0][1] == pytest.approx(0.001, abs=0.05)
    assert len(decode(tvideo.open_reader(got))) == 75


def gopro_like(tmp_path, n=16):
    """A GoPro-shaped file: a libx264 video of ``n`` frames of a textured
    pattern and a GPMF track of one sample per second."""
    w, h = 160, 120
    video = str(tmp_path / "v.mp4")
    wr = tvideo.open_writer(video, tvideo.VideoMeta(w, h, Fraction(30, 1)),
                            encoder="libx264")
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        y = (((xx + i) // 8 + yy // 8) % 2 * 160 + 40).astype(np.uint8)
        wr.write((y, np.full((h // 2, w // 2), 128, np.uint8),
                  np.full((h // 2, w // 2), 128, np.uint8)))
    wr.close()
    src = str(tmp_path / "gopro.mp4")
    mux_gpmf_track(video, gpmf_payloads(2), src)
    return src


def cli_render(src, dest, *flags):
    """``render src dest --preset ... flags`` through the CLI's own option
    mapping, on the CPU (the CLI itself renders on a card)."""
    args = tcli.build_parser().parse_args(["render", src, dest, "--preset", PRESET, *flags])
    trender.render(src, dest, tcli._render_options(args), device="cpu")


def test_cli_render_to_mp4_keeps_the_gpmf_track(tmp_path):
    src = gopro_like(tmp_path)
    dest = str(tmp_path / "out.mp4")
    cli_render(src, dest)
    assert b"meta" in [t.handler_type for t in parse_tracks(dest)]
    assert [s for s, _ in samples(dest)] == [s for s, _ in samples(src)]
    reader = tvideo.open_reader(dest)
    assert isinstance(reader, tnative.NativeVideoSource)
    frames = decode(reader)
    assert len(frames) == 16


def test_stock_render_trim_window_cuts_the_gpmf_track(tmp_path):
    """The stock command with a trim start: libx264, and the GPMF samples
    from the trim start on."""
    src = gopro_like(tmp_path, n=45)  # 1.5 s: GPMF samples at 0 and 1.001 s
    dest = str(tmp_path / "out.mp4")
    cli_render(src, dest, "--stabilise", "smooth", "--start", "0.5", "--encoder", "libx264")
    got = samples(dest)
    assert [s for s, _ in got] == [s for s, _ in samples(src)][1:]
    assert len(decode(tvideo.open_reader(dest))) == 30


def test_no_native_io_routes_through_cv2(tmp_path, monkeypatch):
    src = gopro_like(tmp_path)
    opened = []
    for cls in (tnative.NativeVideoSource, tnative.NativeVideoWriter,
                tvideo._CvSource, tvideo._CvSink):
        real = cls.__init__

        def spy(self, *a, _real=real, _name=cls.__name__, **kw):
            opened.append(_name)
            _real(self, *a, **kw)

        monkeypatch.setattr(cls, "__init__", spy)
    dest = str(tmp_path / "cv.mp4")
    cli_render(src, dest, "--no-native-io")
    assert "NativeVideoSource" not in opened and "NativeVideoWriter" not in opened
    assert "_CvSource" in opened and "_CvSink" in opened
    assert b"meta" not in [t.handler_type for t in parse_tracks(dest)]
    opened.clear()
    cli_render(src, str(tmp_path / "native.mp4"))
    assert "_CvSource" not in opened and "_CvSink" not in opened
    assert "NativeVideoSource" in opened and "NativeVideoWriter" in opened


def test_native_concat_matches_jax(tmp_path):
    parts = [write_clip(tmp_path / f"p{i}.mp4", n=6, seed=i) for i in range(2)]
    got, want = str(tmp_path / "t.mp4"), str(tmp_path / "j.mp4")
    tnative.native_concat(parts, got)
    jnative.native_concat(parts, want)
    got_frames = decode(tnative.NativeVideoSource(got))
    want_frames = decode(jnative.NativeVideoSource(want))
    assert len(got_frames) == len(want_frames) == 12
    for g, w in zip(got_frames, want_frames):
        for gp, wp in zip(g, w):
            np.testing.assert_array_equal(gp, wp)
