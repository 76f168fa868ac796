"""Video reader/writer front-ends yielding planar YUV 4:2:0 numpy frames.

Port of ``video_annotator_tpu/io/video.py`` for the sources and sinks the
port's path uses:

- ``.y4m``: pure-Python, lossless raw;
- ``synthetic://...``: the ground-truth generator (``io/synthetic.py``),
  rendered on the device the caller names;
- anything else: OpenCV's FFMPEG backend, imported only when such a file
  is opened.

The threaded libav loader/writer of ``native/`` and the delegated ffmpeg
encoder are not ported yet (ROADMAP.md); compressed output goes through
OpenCV's fourcc writers.
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


def open_reader(path: str, start_frame: int = 0, device="cpu"):
    """Open a source; the reader has ``.meta``, ``.start_frame`` (index of
    the first yielded frame) and yields (y, u, v) uint8 numpy planes.
    ``device`` is where a synthetic source renders its frames."""
    if path.startswith("synthetic://"):
        from video_annotator_tpu_torch.io.synthetic import SyntheticSource

        return SyntheticSource.from_uri(path, device=device)
    if path.endswith(".y4m"):
        return _Y4MSource(path, start_frame=start_frame)
    return _CvSource(path, start_frame=start_frame)


class _Y4MSink:
    def __init__(self, path: str, meta: VideoMeta):
        self._w = y4m_mod.Y4MWriter(path, meta.width, meta.height, meta.fps)

    def write(self, planes: Planes):
        self._w.write(*planes)

    def close(self):
        self._w.close()


class _CvSink:
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


def default_encoder() -> str:
    """OpenCV's mp4v: the native libx264 writer is not ported yet."""
    return "mp4v"


def open_writer(path: Optional[str], meta: VideoMeta, encoder: str = "mp4v"):
    """Open a frame sink: ``None`` discards, ``.y4m`` writes raw, anything
    else encodes through an OpenCV 4-character fourcc."""
    if path is None:
        return _NullSink()
    if path.endswith(".y4m"):
        return _Y4MSink(path, meta)
    if len(encoder) != 4:
        raise NotImplementedError(
            f"encoder {encoder!r} needs the native libav writer, which is not "
            "ported to the torch package yet (ROADMAP.md); use a .y4m output "
            "or a 4-character OpenCV fourcc")
    return _CvSink(path, meta, fourcc=encoder)
