"""Pure-Python YUV4MPEG2 (.y4m) reader/writer.

Port of ``video_annotator_tpu/io/y4m.py`` (numpy only): a dependency-free
lossless interchange format for raw 4:2:0 video.
"""

from __future__ import annotations

import dataclasses
import os
import stat
from fractions import Fraction
from typing import Iterator, Optional, Tuple

import numpy as np

# The line in front of each frame's planes; with Y, U and V after it, back
# to back, it makes a frame record.
FRAME_MARKER = b"FRAME\n"


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


def pipe_max_size() -> int:
    """The largest pipe buffer an unprivileged process may set (Linux's
    ``fs.pipe-max-size``; 1 MiB where it cannot be read)."""
    try:
        with open("/proc/sys/fs/pipe-max-size") as f:
            return int(f.read())
    except (OSError, ValueError):
        return 1 << 20


def grow_pipe(fd: int) -> Optional[int]:
    """Raise the buffer of the pipe or FIFO that ``fd`` writes into to
    :func:`pipe_max_size`, so that a frame of megabytes crosses in a few
    wakeups of its reader instead of one per 64 KiB. Returns the buffer's
    size afterwards, or None where ``fd`` is not a pipe."""
    if not stat.S_ISFIFO(os.fstat(fd).st_mode):
        return None
    import fcntl

    try:
        fcntl.fcntl(fd, fcntl.F_SETPIPE_SZ, pipe_max_size())
    except OSError:
        pass  # EPERM (over the user's pipe quota) or EBUSY: any size works
    return fcntl.fcntl(fd, fcntl.F_GETPIPE_SZ)


class Y4MWriter:
    def __init__(self, path, width: int, height: int, fps=Fraction(30, 1)):
        # ``path`` may be a filename/PathLike or an open binary file
        # object (e.g. a subprocess stdin pipe for delegated encoders).
        self._f = (open(path, "wb")
                   if isinstance(path, (str, os.PathLike)) else path)
        fps = Fraction(fps).limit_denominator(65536)
        self._f.write(
            f"YUV4MPEG2 W{width} H{height} F{fps.numerator}:{fps.denominator}"
            " Ip A1:1 C420jpeg\n".encode()
        )
        self.width, self.height = width, height
        self._fd: Optional[int] = None
        # The pipe's buffer in bytes once write_record has raised it; None
        # before the first record and for a regular file.
        self.pipe_bytes: Optional[int] = None

    def write(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        assert y.shape == (self.height, self.width), y.shape
        self._f.write(FRAME_MARKER)
        self._f.write(np.ascontiguousarray(y, np.uint8).tobytes())
        self._f.write(np.ascontiguousarray(u, np.uint8).tobytes())
        self._f.write(np.ascontiguousarray(v, np.uint8).tobytes())

    def write_record(self, record):
        """Write one frame record, :data:`FRAME_MARKER` then the Y, U and V
        bytes back to back (the bytes :meth:`write` writes), straight to
        the file descriptor: no copy, one ``write`` call for as much as the
        file takes at a time, the interpreter lock released while it
        blocks. Whatever the file object holds (the header) goes first;
        the first record raises a pipe's buffer (:func:`grow_pipe`)."""
        self._f.flush()
        if self._fd is None:
            self._fd = self._f.fileno()
            self.pipe_bytes = grow_pipe(self._fd)
        view = memoryview(record).cast("B")
        while view:
            view = view[os.write(self._fd, view):]

    def close(self):
        self._f.close()
