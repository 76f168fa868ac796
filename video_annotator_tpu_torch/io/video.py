"""Video reader/writer front-ends yielding planar YUV 4:2:0 numpy frames.

Port of ``video_annotator_tpu/io/video.py``:

- ``.y4m``: pure-Python, lossless raw;
- ``synthetic://...``: the ground-truth generator (``io/synthetic.py``),
  rendered on the device the caller names;
- anything else decodes through the threaded libav loader of ``native/``
  (``io/native.py``) when it is built, else through OpenCV's FFMPEG
  backend;
- compressed output: the libav encoder names (``libx264`` at QP 19, the
  default when the native writer is built, ``libx265``, ``mpeg4`` and
  their aliases) go to the native writer, which also stream-copies the
  source's audio and GPMF tracks over the trim window; 4-character names
  go to OpenCV's fourcc writers; any other name (``h264_nvenc``,
  ``hevc_vaapi``, ...) is piped as y4m to an ``ffmpeg`` binary on PATH.

``prefer_native=False`` / ``allow_native=False`` (the CLI's
``--no-native-io``) route around the native libraries. Where they are
not built, both directions fall back to OpenCV as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import os
from fractions import Fraction
from typing import Iterator, Optional, Tuple

import numpy as np

from video_annotator_tpu_torch.io import y4m as y4m_mod

Planes = Tuple[np.ndarray, np.ndarray, np.ndarray]


@dataclasses.dataclass
class VideoMeta:
    width: int
    height: int
    fps: Fraction
    num_frames: Optional[int] = None


def bgr_to_yuv420(bgr: np.ndarray) -> Planes:
    import cv2

    h, w = bgr.shape[:2]
    flat = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV_I420).reshape(-1)
    cs = (h // 2) * (w // 2)
    return (flat[: h * w].reshape(h, w),
            flat[h * w: h * w + cs].reshape(h // 2, w // 2),
            flat[h * w + cs:].reshape(h // 2, w // 2))


def yuv420_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    import cv2

    h, w = y.shape
    flat = np.concatenate(
        [np.ascontiguousarray(p, np.uint8).reshape(-1) for p in (y, u, v)])
    return cv2.cvtColor(flat.reshape(h * 3 // 2, w), cv2.COLOR_YUV2BGR_I420)


class _Y4MSource:
    def __init__(self, path: str, start_frame: int = 0):
        self._r = y4m_mod.Y4MReader(path)
        h = self._r.header
        header_len = self._r._f.tell()
        fsz = os.path.getsize(path)
        marker = self._r._f.readline()
        self._r._f.seek(header_len)
        mlen = len(marker) if marker.startswith(b"FRAME") else 6
        frame_bytes = h.width * h.height * 3 // 2 + mlen
        self.meta = VideoMeta(h.width, h.height, h.fps,
                              int(max(fsz - header_len, 0) // frame_bytes))
        self.start_frame = 0
        if start_frame > 0:
            pos = header_len + start_frame * frame_bytes
            self._r._f.seek(pos)
            if self._r._f.read(5) == b"FRAME":
                self._r._f.seek(pos)
                self.start_frame = start_frame
            else:
                self._r._f.seek(header_len)

    def __iter__(self) -> Iterator[Planes]:
        return iter(self._r)

    def close(self):
        self._r.close()


class _CvSource:
    def __init__(self, path: str, start_frame: int = 0):
        import cv2

        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise FileNotFoundError(f"cannot open video: {path}")
        w = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        fps = self._cap.get(cv2.CAP_PROP_FPS) or 30.0
        n = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.meta = VideoMeta(w, h, Fraction(fps).limit_denominator(1001), n or None)
        self.start_frame = 0
        if start_frame > 0 and self._cap.set(cv2.CAP_PROP_POS_FRAMES, start_frame) \
                and int(self._cap.get(cv2.CAP_PROP_POS_FRAMES)) == start_frame:
            self.start_frame = start_frame

    def __iter__(self) -> Iterator[Planes]:
        while True:
            ok, bgr = self._cap.read()
            if not ok:
                return
            yield bgr_to_yuv420(bgr)

    def close(self):
        self._cap.release()


def open_reader(path: str, start_frame: int = 0, device="cpu",
                prefer_native: bool = True):
    """Open a source; the reader has ``.meta``, ``.start_frame`` (index of
    the first yielded frame) and yields (y, u, v) uint8 numpy planes.
    ``device`` is where a synthetic source renders its frames.

    ``start_frame`` requests a trim seek, honoured exactly by the native
    loader (keyframe seek and a pts drop window), OpenCV
    (``CAP_PROP_POS_FRAMES``) and y4m (fixed-size frames). A source that
    cannot seek reports ``start_frame == 0`` and the caller skips frames.
    A compressed file goes to the native loader first when
    ``prefer_native`` and it is built, else to OpenCV."""
    if path.startswith("synthetic://"):
        from video_annotator_tpu_torch.io.synthetic import SyntheticSource

        return SyntheticSource.from_uri(path, device=device)
    if path.endswith(".y4m"):
        return _Y4MSource(path, start_frame=start_frame)
    if prefer_native:
        from video_annotator_tpu_torch.io.native import NativeVideoSource, native_available

        if native_available():
            try:
                return NativeVideoSource(path, start_frame=start_frame)
            except (FileNotFoundError, RuntimeError, OSError):
                pass
    return _CvSource(path, start_frame=start_frame)


class _Y4MSink:
    """Raw y4m into a file or a FIFO. Besides ``write`` (numpy planes) it
    takes whole frame records (``write_record``, :meth:`Y4MWriter.write_record`),
    which :class:`~video_annotator_tpu_torch.io.prefetch.AsyncFrameWriter`
    reads back into when nothing sits between it and this sink."""

    def __init__(self, path: str, meta: VideoMeta):
        self._w = y4m_mod.Y4MWriter(path, meta.width, meta.height, meta.fps)

    def write(self, planes: Planes):
        self._w.write(*planes)

    def write_record(self, record):
        self._w.write_record(record)

    @property
    def pipe_bytes(self) -> Optional[int]:
        return self._w.pipe_bytes

    def close(self):
        self._w.close()


class _FfmpegSink:
    """Encoders this host cannot drive natively (``h264_vaapi``,
    ``h264_nvenc``, ``hevc_*``): y4m piped into an ``ffmpeg`` binary on
    PATH that owns the hardware encoder."""

    def __init__(self, path: str, meta: VideoMeta, encoder: str,
                 qp: int = 19, binary: Optional[str] = None):
        import shutil
        import subprocess

        ffmpeg = binary or shutil.which("ffmpeg")
        if ffmpeg is None:
            raise ValueError(
                f"encoder {encoder!r} is not built in (native: libx264/"
                f"libx265/mpeg4; cv2 fourcc: 4-char names) and no ffmpeg "
                f"binary is on PATH to delegate to")
        cmd = [ffmpeg, "-y", "-loglevel", "error"]
        if "vaapi" in encoder:
            cmd += ["-vaapi_device", "/dev/dri/renderD128"]
        cmd += ["-f", "yuv4mpegpipe", "-i", "pipe:0"]
        if "vaapi" in encoder:
            cmd += ["-vf", "format=nv12,hwupload"]
        cmd += ["-c:v", encoder, "-qp", str(qp), path]
        self._proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)
        self._path = path
        self._pipe = y4m_mod.Y4MWriter(self._proc.stdin, meta.width, meta.height, meta.fps)

    def write(self, planes: Planes):
        try:
            self._pipe.write(*planes)
        except BrokenPipeError:
            self._exited_early()

    def write_record(self, record):
        """A whole y4m frame record into the pipe, as :class:`_Y4MSink`."""
        try:
            self._pipe.write_record(record)
        except BrokenPipeError:
            self._exited_early()

    @property
    def pipe_bytes(self) -> Optional[int]:
        return self._pipe.pipe_bytes

    def _exited_early(self):
        self._proc.wait()
        raise RuntimeError(f"delegated ffmpeg encoder exited early "
                           f"(rc={self._proc.returncode}) writing {self._path}")

    def close(self):
        if self._proc is None:
            return
        proc, self._proc = self._proc, None
        try:
            self._pipe.close()
        except BrokenPipeError:
            pass
        rc = proc.wait()
        if rc != 0:
            raise RuntimeError(f"delegated ffmpeg encode of {self._path} failed (rc={rc})")


class _CvSink:
    """OpenCV's FFMPEG writer by fourcc: bitrate-default, no QP, no stream
    passthrough."""

    def __init__(self, path: str, meta: VideoMeta, fourcc: str = "mp4v"):
        import cv2

        self._wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc),
                                   float(meta.fps), (meta.width, meta.height))
        if not self._wr.isOpened():
            raise RuntimeError(f"cannot open encoder for {path} ({fourcc})")

    def write(self, planes: Planes):
        self._wr.write(yuv420_to_bgr(*planes))

    def close(self):
        self._wr.release()


class _NullSink:
    def write(self, planes: Planes):
        pass

    def close(self):
        pass


# Encoder names routed to the native libav writer (libx264 at constant
# QP 19). 4-character fourcc names (mp4v, avc1, ...) go through OpenCV.
_NATIVE_ENCODERS = {"libx264", "x264", "h264", "libx265", "hevc", "mpeg4"}
# Fourccs and common names to libav encoder names: the C side's lookup
# would otherwise miss them and substitute libx264.
_NATIVE_ALIASES = {"x264": "libx264", "h264": "libx264", "avc1": "libx264",
                   "mp4v": "mpeg4", "hevc": "libx265", "hvc1": "libx265",
                   "x265": "libx265"}


def default_encoder() -> str:
    """``libx264`` (QP 19) when the native writer is built, as in the JAX
    package; OpenCV's ``mp4v`` otherwise."""
    from video_annotator_tpu_torch.io.native import native_writer_available

    return "libx264" if native_writer_available() else "mp4v"


def open_writer(path: Optional[str], meta: VideoMeta, encoder: str = "mp4v",
                copy_streams_from: Optional[str] = None,
                trim_start: float = 0.0, trim_end: float = -1.0,
                allow_native: bool = True):
    """Open a frame sink: ``None`` discards, ``.y4m`` writes raw, anything
    else encodes (module docstring). ``copy_streams_from`` stream-copies
    that file's audio and GPMF data tracks into the output, restricted to
    the ``[trim_start, trim_end)`` source window in seconds: the native
    writer only, which also takes a fourcc that has a libav name when
    there are streams to copy."""
    if path is None:
        return _NullSink()
    if path.endswith(".y4m"):
        return _Y4MSink(path, meta)
    native_name = _NATIVE_ALIASES.get(
        encoder, encoder if encoder in _NATIVE_ENCODERS else None)
    if allow_native and (encoder in _NATIVE_ENCODERS
                         or (copy_streams_from is not None and native_name is not None)):
        from video_annotator_tpu_torch.io.native import (
            NativeVideoWriter,
            native_writer_available,
        )

        try:
            if native_writer_available():
                return NativeVideoWriter(path, meta, encoder=native_name, qp=19,
                                         copy_streams_from=copy_streams_from,
                                         trim_start=trim_start, trim_end=trim_end)
        except (RuntimeError, OSError) as e:
            import sys

            print(f"warning: native writer unavailable for {path} ({e}); falling "
                  "back to cv2 (bitrate-default, no stream passthrough)",
                  file=sys.stderr)
    if encoder not in _NATIVE_ENCODERS and len(encoder) != 4:
        # Neither built in nor a fourcc: a hardware encoder name. Delegate
        # rather than let the C side substitute libx264.
        if copy_streams_from is not None:
            import sys

            print(f"warning: --encoder {encoder!r} is not a built-in codec; "
                  "encoding WITHOUT audio/GPMF stream passthrough", file=sys.stderr)
        return _FfmpegSink(path, meta, encoder)
    return _CvSink(path, meta, fourcc=encoder if len(encoder) == 4 else "mp4v")
