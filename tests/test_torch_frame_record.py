"""``AsyncFrameWriter``'s two paths to its sink.

``record``: a y4m sink with nothing wrapped around it takes each frame as
one host buffer laid out as the frame's record (``FRAME`` line, Y, U, V)
and writes it with ``os.write`` on the file descriptor. ``planes``: every
other sink gets numpy planes. Checked on the CPU at small sizes, one torch
thread a test: the record path writes the bytes ``Y4MWriter.write`` writes,
into a file and into a FIFO, with partial writes and a slow reader; a
reader that dies makes the writer raise; the host wrappers and the other
sinks keep the planes path and their bytes; a render into ``.y4m`` counts
every frame under ``record``. The card case (a 32-frame warp batch through
the pinned record) skips without a CUDA device. This file imports neither
JAX nor the JAX package.
"""

import os
import sys
import threading
import time
from fractions import Fraction

import numpy as np
import pytest
import torch

from video_annotator_tpu_torch.camera import (
    CameraPreset,
    get_output_camera,
    get_preset_camera,
)
from video_annotator_tpu_torch.io import video as tvideo
from video_annotator_tpu_torch.io import y4m as ty4m
from video_annotator_tpu_torch.io.prefetch import AsyncFrameWriter
from video_annotator_tpu_torch.io.video import VideoMeta, open_writer
from video_annotator_tpu_torch.pipeline import render as trender
from video_annotator_tpu_torch.pipeline.debug import DebugOverlayWriter
from video_annotator_tpu_torch.pipeline.profiler import StageProfiler

W, H, N = 48, 32, 5
META = VideoMeta(W, H, Fraction(30, 1), N)
RECORD = len(ty4m.FRAME_MARKER) + W * H * 3 // 2
TIMEOUT = 60


@pytest.fixture(autouse=True)
def few_threads():
    """The writer runs torch on a thread of its own: one intra-op thread
    each keeps parallel test workers off each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_frames(n=N, w=W, h=H, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [tuple(torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)
                  for shape in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
            for _ in range(n)]


def planes_y4m(path, frames, w=W, h=H):
    """The bytes of the planes path: ``Y4MWriter.write`` of numpy planes."""
    out = ty4m.Y4MWriter(str(path), w, h, META.fps)
    for f in frames:
        out.write(*(np.asarray(p) for p in f))
    out.close()
    return path.read_bytes()


def through_writer(sink, frames):
    prof = StageProfiler()
    writer = AsyncFrameWriter(sink, profiler=prof)
    for f in frames:
        writer.write(f)
    writer.close()
    return prof


class FifoReader:
    """A thread that reads a FIFO to its end, ``chunk`` bytes a read."""

    def __init__(self, path, chunk=1 << 16, pause=0.0):
        self.data = bytearray()
        self._path, self._chunk, self._pause = path, chunk, pause
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    def _read(self):
        fd = os.open(self._path, os.O_RDONLY)
        try:
            while True:
                b = os.read(fd, self._chunk)
                if not b:
                    return
                self.data += b
                time.sleep(self._pause)
        finally:
            os.close(fd)

    def join(self):
        self._thread.join(timeout=TIMEOUT)
        assert not self._thread.is_alive()
        return bytes(self.data)


class Forward:
    """A host wrapper of the plainest kind: it only passes frames on."""

    def __init__(self, sink):
        self._sink = sink

    def write(self, planes):
        self._sink.write(planes)

    def close(self):
        self._sink.close()


@pytest.mark.parametrize("layout", ["whole", "strided"])
def test_record_bytes_equal_the_planes_path_in_a_file(tmp_path, layout):
    """``strided``: the planes are windows of larger tensors, as
    ``--crop`` hands them to the writer."""
    frames = make_frames()
    if layout == "strided":
        frames = [tuple(torch.nn.functional.pad(p, (3, 5, 2, 4))[2:2 + p.shape[0], 3:3 + p.shape[1]]
                        for p in f) for f in frames]
        assert not frames[0][0].is_contiguous()
    prof = through_writer(open_writer(str(tmp_path / "rec.y4m"), META), frames)
    assert dict(prof.counts()) == {"record": N}  # a regular file: no pipe to note
    assert (tmp_path / "rec.y4m").read_bytes() == planes_y4m(tmp_path / "ref.y4m", frames)
    secs, calls = prof.all_totals()
    assert calls["readback"] == calls["sink"] == N


def test_record_bytes_equal_the_planes_path_through_a_fifo(tmp_path):
    frames = make_frames()
    fifo = tmp_path / "out.y4m"
    os.mkfifo(fifo)
    reader = FifoReader(fifo)
    prof = through_writer(open_writer(str(fifo), META), frames)
    assert reader.join() == planes_y4m(tmp_path / "ref.y4m", frames)
    counts = prof.counts()
    assert counts["record"] == N and "planes" not in counts
    assert counts["pipe_bytes"] >= 4096
    assert "counts: record 5, pipe_bytes" in prof.report()


def test_grow_pipe_raises_a_pipe_and_leaves_a_file(tmp_path):
    r, w = os.pipe()
    try:
        import fcntl

        got = ty4m.grow_pipe(w)
        assert got == fcntl.fcntl(w, fcntl.F_GETPIPE_SZ)
        assert got >= 65536
    finally:
        os.close(r)
        os.close(w)
    with open(tmp_path / "f", "wb") as f:
        assert ty4m.grow_pipe(f.fileno()) is None


def test_partial_writes_are_finished(tmp_path, monkeypatch):
    """Every ``os.write`` takes at most 777 bytes: each record is finished
    over many calls, in order."""
    calls = []

    class ShortWrites:
        def __getattr__(self, name):
            return getattr(os, name)

        @staticmethod
        def write(fd, data):
            calls.append(len(data))
            return os.write(fd, memoryview(data)[:777])

    monkeypatch.setattr(ty4m, "os", ShortWrites())
    frames = make_frames()
    through_writer(open_writer(str(tmp_path / "rec.y4m"), META), frames)
    assert len(calls) == N * -(-RECORD // 777)
    assert (tmp_path / "rec.y4m").read_bytes() == planes_y4m(tmp_path / "ref.y4m", frames)


def test_a_slow_reader_of_a_small_pipe_gets_every_byte(tmp_path, monkeypatch):
    """The pipe stays at one page and the reader drains 500 bytes at a
    time with pauses: each record crosses in many wakeups."""
    monkeypatch.setattr(ty4m, "pipe_max_size", lambda: 4096)
    frames = make_frames(n=3, w=96, h=64)
    fifo = tmp_path / "out.y4m"
    os.mkfifo(fifo)
    reader = FifoReader(fifo, chunk=500, pause=0.0005)
    prof = through_writer(open_writer(str(fifo), VideoMeta(96, 64, META.fps, 3)), frames)
    assert reader.join() == planes_y4m(tmp_path / "ref.y4m", frames, 96, 64)
    assert prof.counts()["pipe_bytes"] == 4096


@pytest.mark.parametrize("path", ["record", "planes"])
def test_a_reader_that_dies_makes_the_writer_raise(tmp_path, path):
    """The reader takes one byte and closes the FIFO: a write after that
    fails, and the failure comes out of ``write`` or ``close``."""
    fifo = tmp_path / "out.y4m"
    os.mkfifo(fifo)
    gone = threading.Event()

    def read_one_byte():
        fd = os.open(fifo, os.O_RDONLY)
        os.read(fd, 1)
        os.close(fd)
        gone.set()

    reader = threading.Thread(target=read_one_byte, daemon=True)
    reader.start()
    sink = open_writer(str(fifo), META)
    prof = StageProfiler()
    writer = AsyncFrameWriter(sink if path == "record" else Forward(sink), profiler=prof)
    frame = make_frames(n=1)[0]
    with pytest.raises(OSError):
        for _ in range(100_000):
            if gone.is_set():
                break
            writer.write(frame)
        assert gone.wait(TIMEOUT)
        for _ in range(3):
            writer.write(frame)
        writer.close()
    reader.join(timeout=TIMEOUT)
    assert not reader.is_alive()
    assert set(prof.counts()) <= {path, "pipe_bytes"}


def fake_ffmpeg(tmp_path, body):
    """An executable standing in for ``ffmpeg``: ``body`` runs with the
    output path, the last argument, as ``out``."""
    exe = tmp_path / "ffmpeg"
    exe.write_text(f"#!{sys.executable}\nimport shutil, sys\nout = sys.argv[-1]\n{body}\n")
    exe.chmod(0o755)
    return str(exe)


def test_a_delegated_encoders_pipe_takes_the_record_path(tmp_path):
    """``_FfmpegSink`` pipes y4m into the encoder's standard input: the
    record path, and the encoder reads the bytes of the planes path."""
    exe = fake_ffmpeg(tmp_path, "shutil.copyfileobj(sys.stdin.buffer, open(out, 'wb'))")
    frames = make_frames()
    sink = tvideo._FfmpegSink(str(tmp_path / "out.mkv"), META, "h264_nvenc", binary=exe)
    prof = through_writer(sink, frames)
    counts = prof.counts()
    assert counts["record"] == N and counts["pipe_bytes"] >= 4096
    assert (tmp_path / "out.mkv").read_bytes() == planes_y4m(tmp_path / "ref.y4m", frames)


def test_a_delegated_encoder_that_exits_early_raises(tmp_path):
    exe = fake_ffmpeg(tmp_path, "sys.exit(3)")
    sink = tvideo._FfmpegSink(str(tmp_path / "out.mkv"), META, "h264_nvenc", binary=exe)
    writer = AsyncFrameWriter(sink)
    frame = make_frames(n=1, w=512, h=512)[0]
    with pytest.raises(RuntimeError, match="exited early"):
        for _ in range(20):
            writer.write(frame)
        writer.close()


def test_crop_in_front_of_the_writer_takes_the_record_path(tmp_path):
    """``--crop`` slices the device's planes before the writer, which sees
    the y4m sink alone: the record path, with the bytes of cropping the
    read-back planes."""
    rect = (20, 30, 6, 10)  # (ch, cw, cy, cx)
    frames = make_frames()
    prof = StageProfiler()
    writer = trender.CropSink(AsyncFrameWriter(
        open_writer(str(tmp_path / "rec.y4m"), VideoMeta(30, 20, META.fps, N)),
        profiler=prof), rect)
    for f in frames:
        writer.write(f)
    writer.close()
    ref = trender.CropSink(tvideo._Y4MSink(str(tmp_path / "ref.y4m"),
                                           VideoMeta(30, 20, META.fps, N)), rect)
    for f in frames:
        ref.write(tuple(p.numpy() for p in f))
    ref.close()
    assert dict(prof.counts()) == {"record": N}
    assert (tmp_path / "rec.y4m").read_bytes() == (tmp_path / "ref.y4m").read_bytes()


def wrapped(kind, path, tmp_path, tag):
    """A sink of ``kind`` writing to ``path``."""
    if kind == "hud":
        return DebugOverlayWriter(open_writer(str(path), META))
    if kind == "preview":
        return trender.PreviewSink(open_writer(str(path), META), str(tmp_path / f"pv_{tag}"),
                                   every=2)
    if kind == "display":  # a window closed by its user: frames pass through
        sink = trender.DisplaySink(open_writer(str(path), META))
        sink._open = False
        return sink
    if kind == "cv2":
        return open_writer(str(path), META, encoder="MJPG")
    if kind == "native":
        return open_writer(str(path), META, encoder="libx264")
    return open_writer(None, META)


@pytest.mark.parametrize("kind,suffix", [("hud", ".y4m"), ("preview", ".y4m"), ("display", ".y4m"),
                                         ("cv2", ".avi"), ("native", ".mp4"), ("null", "")])
def test_wrappers_and_other_sinks_keep_the_planes_path(tmp_path, kind, suffix):
    """Each through the writer against the same sink given the read-back
    numpy planes directly (the planes path as it was): the same bytes."""
    frames = make_frames()
    got, want = tmp_path / f"got{suffix}", tmp_path / f"want{suffix}"
    prof = through_writer(wrapped(kind, got, tmp_path, "got"), frames)
    ref = wrapped(kind, want, tmp_path, "want")
    for f in frames:
        ref.write(tuple(p.numpy() for p in f))
    ref.close()
    assert dict(prof.counts()) == {"planes": N}
    if suffix:
        assert got.read_bytes() == want.read_bytes()
    if kind == "preview":
        names = sorted(os.listdir(tmp_path / "pv_got"))
        assert names == sorted(os.listdir(tmp_path / "pv_want")) and len(names) == 3
        for name in names:
            assert ((tmp_path / "pv_got" / name).read_bytes()
                    == (tmp_path / "pv_want" / name).read_bytes())


RENDER_FRAMES = 12
SRC = f"synthetic://shaky?w=192&h=144&n={RENDER_FRAMES}&seed=5&shake=0.004&pan=0.0"


@pytest.mark.parametrize("streaming", [True, False])
def test_render_into_y4m_writes_every_frame_as_a_record(tmp_path, monkeypatch, streaming):
    """Every frame of a render into ``.y4m`` takes the record path, and the
    file is the one the planes path writes (the y4m sink without
    ``write_record``)."""
    opts = trender.RenderOptions(stabilise="smooth", stabilise_radius=4, warp_batch=5,
                                 streaming=streaming, analysis_mode="paired",
                                 analysis_chunk=4,
                                 preset=CameraPreset.GOPRO_H4B_WIDE43_MEASURED)
    prof = StageProfiler()
    trender.render(SRC, str(tmp_path / "rec.y4m"), opts, profiler=prof, device="cpu")
    assert dict(prof.counts()) == {"record": RENDER_FRAMES}
    writer_lines = prof.report().split("[frame-writer]")[1]
    assert f"counts: record {RENDER_FRAMES}" in writer_lines

    monkeypatch.delattr(tvideo._Y4MSink, "write_record")
    prof = StageProfiler()
    trender.render(SRC, str(tmp_path / "planes.y4m"), opts, profiler=prof, device="cpu")
    assert dict(prof.counts()) == {"planes": RENDER_FRAMES}
    assert (tmp_path / "rec.y4m").read_bytes() == (tmp_path / "planes.y4m").read_bytes()


@pytest.mark.cuda
def test_card_warp_batch_through_the_pinned_record(tmp_path):
    """A 32-frame warp batch on the card, made on a stream of its own,
    through the pinned record: the bytes of ``p.cpu().numpy()``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (320, 240))
    warper = trender.FrameWarper(in_cam, get_output_camera(in_cam, zoom=1.0 / 1.2))
    g = torch.Generator().manual_seed(3)
    ys = torch.randint(0, 256, (32, 240, 320), generator=g, dtype=torch.uint8).to(dev)
    us, vs = (torch.randint(0, 256, (32, 120, 160), generator=g, dtype=torch.uint8).to(dev)
              for _ in range(2))
    angles = torch.randn(32, 3, generator=g) * 0.02
    from video_annotator_tpu_torch import so3

    rots = so3.exp(angles).to(dev)
    meta = VideoMeta(warper.out_w, warper.out_h, META.fps, 32)
    prof = StageProfiler()
    writer = AsyncFrameWriter(open_writer(str(tmp_path / "rec.y4m"), meta), profiler=prof)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        outs = warper.warp_yuv_batch(ys, us, vs, rots)
        for triple in outs:
            writer.write(triple)
    buf = writer._record[0]
    writer.close()
    assert torch.from_numpy(buf).is_pinned()
    torch.cuda.synchronize()
    want = planes_y4m(tmp_path / "ref.y4m", [tuple(p.cpu() for p in t) for t in outs],
                      warper.out_w, warper.out_h)
    assert dict(prof.counts()) == {"record": 32}
    assert (tmp_path / "rec.y4m").read_bytes() == want
