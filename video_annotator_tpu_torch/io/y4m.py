"""Pure-Python YUV4MPEG2 (.y4m) reader/writer.

Port of ``video_annotator_tpu/io/y4m.py`` (numpy only): a dependency-free
lossless interchange format for raw 4:2:0 video.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class Y4MHeader:
    width: int
    height: int
    fps: Fraction
    colorspace: str = "420jpeg"


def _parse_header(line: bytes) -> Y4MHeader:
    if not line.startswith(b"YUV4MPEG2"):
        raise ValueError("not a YUV4MPEG2 stream")
    w = h = None
    fps = Fraction(30, 1)
    cs = "420jpeg"
    for tok in line.split()[1:]:
        c, v = tok[:1], tok[1:].decode()
        if c == b"W":
            w = int(v)
        elif c == b"H":
            h = int(v)
        elif c == b"F":
            num, den = v.split(":")
            fps = Fraction(int(num), int(den))
        elif c == b"C":
            cs = v
    if w is None or h is None:
        raise ValueError("y4m header missing W/H")
    if not cs.startswith("420"):
        raise ValueError(f"only 4:2:0 y4m supported, got C{cs}")
    return Y4MHeader(w, h, fps, cs)


class Y4MReader:
    def __init__(self, path: str):
        self._f = open(path, "rb")
        self.header = _parse_header(self._f.readline())

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        w, h = self.header.width, self.header.height
        ysize, csize = w * h, (w // 2) * (h // 2)
        while True:
            marker = self._f.readline()
            if not marker:
                return
            if not marker.startswith(b"FRAME"):
                raise ValueError(f"bad frame marker: {marker[:20]!r}")
            buf = self._f.read(ysize + 2 * csize)
            if len(buf) < ysize + 2 * csize:
                return
            y = np.frombuffer(buf, np.uint8, ysize).reshape(h, w)
            u = np.frombuffer(buf, np.uint8, csize, ysize).reshape(h // 2, w // 2)
            v = np.frombuffer(buf, np.uint8, csize, ysize + csize).reshape(
                h // 2, w // 2
            )
            yield y, u, v

    def close(self):
        self._f.close()


class Y4MWriter:
    def __init__(self, path, width: int, height: int, fps=Fraction(30, 1)):
        # ``path`` may be a filename/PathLike or an open binary file
        # object (e.g. a subprocess stdin pipe for delegated encoders).
        import os

        self._f = (open(path, "wb")
                   if isinstance(path, (str, os.PathLike)) else path)
        fps = Fraction(fps).limit_denominator(65536)
        self._f.write(
            f"YUV4MPEG2 W{width} H{height} F{fps.numerator}:{fps.denominator}"
            " Ip A1:1 C420jpeg\n".encode()
        )
        self.width, self.height = width, height

    def write(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        assert y.shape == (self.height, self.width), y.shape
        self._f.write(b"FRAME\n")
        self._f.write(np.ascontiguousarray(y, np.uint8).tobytes())
        self._f.write(np.ascontiguousarray(u, np.uint8).tobytes())
        self._f.write(np.ascontiguousarray(v, np.uint8).tobytes())

    def close(self):
        self._f.close()
