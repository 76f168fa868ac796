"""ctypes bindings for the native (C++/libav) decode, encode and concat.

Port of ``video_annotator_tpu/io/native.py``. The shared libraries are the
ones ``make -C native`` builds beside both packages (``native/loader.cpp``,
``native/writer.cpp``, ``native/concat.cpp``):

- :class:`NativeVideoSource`: demux and decode on a thread of its own
  (plus libavcodec's frame threads) into a ring of planar YUV 4:2:0
  frames, with a demuxer seek for a trim start;
- :class:`NativeVideoWriter`: libx264 at constant QP 19 by default, the
  source's audio and GPMF data tracks stream-copied over the trim window;
- :func:`native_concat`: the lossless stream-copy concat of ``join``.

A missing library is built once, on first use, with ``make -C native
all`` (``VAT_NATIVE_AUTOBUILD=0`` turns that off); where it still cannot
load, the ``*_available()`` probes return False and ``io/video.py`` falls
back to OpenCV, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import os
import threading
from fractions import Fraction
from typing import Iterator, Optional, Tuple

import numpy as np

from video_annotator_tpu_torch.io.video import VideoMeta

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(NATIVE_DIR, "libvaloader.so")
_WRITER_LIB_PATH = os.path.join(NATIVE_DIR, "libvawriter.so")
_CONCAT_LIB_PATH = os.path.join(NATIVE_DIR, "libvaconcat.so")

_u8p = ctypes.POINTER(ctypes.c_uint8)

# One signature table per shared library: {symbol: (restype, argtypes)}.
# A symbol prefixed with '?' is optional (older builds of the .so).
_LOADER_SIG = {
    "va_open": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int]),
    "?va_open_seek": (
        ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int, ctypes.c_long]),
    "?va_start_frame": (ctypes.c_long, [ctypes.c_void_p]),
    "va_meta": (
        ctypes.c_int,
        [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int)] * 4
        + [ctypes.POINTER(ctypes.c_long)]),
    "va_next": (ctypes.c_int, [ctypes.c_void_p] + [_u8p] * 3),
    "va_close": (None, [ctypes.c_void_p]),
    "va_frame_index": (ctypes.c_long, [ctypes.c_void_p]),
    "va_error": (ctypes.c_char_p, [ctypes.c_void_p]),
}
_WRITER_SIG = {
    "vaw_open": (
        ctypes.c_void_p,
        [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
         ctypes.c_double, ctypes.c_double, ctypes.c_int]),
    "vaw_write": (ctypes.c_int, [ctypes.c_void_p] + [_u8p] * 3),
    "vaw_close": (ctypes.c_int, [ctypes.c_void_p]),
    "vaw_error": (ctypes.c_char_p, [ctypes.c_void_p]),
}
_CONCAT_SIG = {
    "va_concat": (
        ctypes.c_int,
        [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_char_p]),
    "va_concat_error": (ctypes.c_char_p, []),
}

_lib_cache: dict = {}
_build_attempted = False
# What the one-shot build said: None before it ran or when it was skipped,
# else (return code, last line of its output).
build_status: Optional[Tuple[int, str]] = None


def _try_build() -> None:
    """One-shot ``make -C native all`` when a library is missing.

    The shared libraries are build artifacts (``native/.gitignore``); a
    fresh checkout builds them on first use. Needs the libav development
    files (``pkg-config`` libavformat, libavcodec, libavutil, libswscale)."""
    global _build_attempted, build_status
    if _build_attempted:
        return
    _build_attempted = True
    if os.environ.get("VAT_NATIVE_AUTOBUILD", "1") == "0":
        return
    import subprocess
    import sys

    print(f"[vat] native libs missing; building (make -C {NATIVE_DIR}; "
          "set VAT_NATIVE_AUTOBUILD=0 to skip)", file=sys.stderr)
    try:
        res = subprocess.run(["make", "-C", NATIVE_DIR, "all"],
                             capture_output=True, timeout=120, check=False)
        out = (res.stdout + res.stderr).decode(errors="replace").strip().splitlines()
        build_status = (res.returncode, out[-1] if out else "")
        if res.returncode != 0:
            print(f"[vat] native build FAILED: {build_status[1] or res.returncode}",
                  file=sys.stderr)
    except (OSError, subprocess.TimeoutExpired) as e:
        build_status = (-1, repr(e))
        print(f"[vat] native build FAILED: {e!r}", file=sys.stderr)


def _load(path: str, signatures: dict):
    """CDLL + bind the signature table; None (cached) if absent/unloadable."""
    if path in _lib_cache:
        return _lib_cache[path]
    if not os.path.exists(path):
        _try_build()
    lib = None
    if os.path.exists(path):
        try:
            lib = ctypes.CDLL(path)
            for name, (restype, argtypes) in signatures.items():
                optional = name.startswith("?")
                sym = name[1:] if optional else name
                if optional and not hasattr(lib, sym):
                    continue
                fn = getattr(lib, sym)
                fn.restype = restype
                fn.argtypes = argtypes
        except OSError:
            lib = None
    _lib_cache[path] = lib
    return lib


def load_library():
    return _load(_LIB_PATH, _LOADER_SIG)


def native_available() -> bool:
    return load_library() is not None


def load_writer_library():
    return _load(_WRITER_LIB_PATH, _WRITER_SIG)


def native_writer_available() -> bool:
    return load_writer_library() is not None


def load_concat_library():
    return _load(_CONCAT_LIB_PATH, _CONCAT_SIG)


def native_concat_available() -> bool:
    return load_concat_library() is not None


class NativeVideoSource:
    """Reader backed by the C++ loader, yielding (y, u, v) uint8 planes.

    ``start_frame`` trims at the demuxer: a keyframe-backward seek plus a
    pts-exact decode-and-drop window in C (ffmpeg's ``-ss``). Iteration
    then begins at source frame ``self.start_frame``."""

    def __init__(self, path: str, ring_frames: int = 8, start_frame: int = 0):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native loader not built (make -C native)")
        self._lib = lib
        # Serialises va_next against va_close: closing frees the C-side
        # ring, mutex and condvar, so it must never run while a va_next is
        # blocked inside it. The decode thread keeps pushing frames (or
        # EOF), so a pending va_next always returns.
        self._lock = threading.Lock()
        if start_frame > 0 and hasattr(lib, "va_open_seek"):
            self._h = lib.va_open_seek(path.encode(), ring_frames, int(start_frame))
            self.start_frame = int(start_frame)
        else:
            self._h = lib.va_open(path.encode(), ring_frames)
            self.start_frame = 0
        if not self._h:
            raise FileNotFoundError(f"native loader cannot open {path}")
        w, h, fn, fd = (ctypes.c_int() for _ in range(4))
        n = ctypes.c_long()
        lib.va_meta(self._h, w, h, fn, fd, n)
        self.meta = VideoMeta(w.value, h.value,
                              Fraction(fn.value or 30, fd.value or 1), n.value or None)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        w, h = self.meta.width, self.meta.height
        while True:
            y = np.empty((h, w), np.uint8)
            u = np.empty((h // 2, w // 2), np.uint8)
            v = np.empty((h // 2, w // 2), np.uint8)
            with self._lock:
                if not self._h:  # closed meanwhile: end the iteration
                    return
                r = self._lib.va_next(self._h, y.ctypes.data_as(_u8p),
                                      u.ctypes.data_as(_u8p), v.ctypes.data_as(_u8p))
                if r < 0:
                    # A decode error must not pass as a clean end of file:
                    # a truncated file would render a short output.
                    err = self._lib.va_error(self._h)
                    raise RuntimeError(
                        f"native decode failed: {err.decode() if err else r}")
            if r != 1:
                return
            yield y, u, v

    def close(self):
        with self._lock:
            if self._h:
                self._lib.va_close(self._h)
                self._h = None


class NativeVideoWriter:
    """Sink backed by the C++ encoder (libx264 at QP 19 by default).

    ``copy_streams_from`` stream-copies that file's audio and GPMF data
    tracks into the output, restricted to the source-time window
    ``[trim_start, trim_end)`` in seconds (``trim_end < 0``: to the end)."""

    def __init__(self, path: str, meta: VideoMeta, encoder: str = "libx264",
                 qp: int = 19, copy_streams_from: Optional[str] = None,
                 trim_start: float = 0.0, trim_end: float = -1.0,
                 ring_frames: int = 8):
        lib = load_writer_library()
        if lib is None:
            raise RuntimeError("native writer not built (make -C native)")
        self._lib = lib
        self._w, self._h2 = meta.width, meta.height
        # The C ABI takes the rate as int32 num/den: a float fps like 29.97
        # has a 50-bit exact numerator that ctypes would silently cut, so
        # bound the fraction (1001 covers the NTSC family) and check it.
        fps = Fraction(meta.fps).limit_denominator(1001)
        if not (0 < fps.numerator < 2**31 and 0 < fps.denominator < 2**31):
            raise ValueError(f"unrepresentable fps {meta.fps!r}")
        self._handle = lib.vaw_open(
            path.encode(), meta.width, meta.height, fps.numerator, fps.denominator,
            encoder.encode(), qp,
            copy_streams_from.encode() if copy_streams_from else None,
            float(trim_start), float(trim_end), ring_frames)
        if not self._handle:
            raise RuntimeError(f"native writer cannot open {path} ({encoder})")

    def write(self, planes):
        y, u, v = (np.ascontiguousarray(p, np.uint8) for p in planes)
        # The C side copies w*h (and w*h/4) bytes from each pointer: an
        # undersized plane would be read out of bounds.
        if (y.shape != (self._h2, self._w)
                or u.shape != (self._h2 // 2, self._w // 2)
                or v.shape != (self._h2 // 2, self._w // 2)):
            raise ValueError(
                f"plane shapes {y.shape}/{u.shape}/{v.shape} do not match "
                f"writer geometry {self._w}x{self._h2}")
        r = self._lib.vaw_write(self._handle, y.ctypes.data_as(_u8p),
                                u.ctypes.data_as(_u8p), v.ctypes.data_as(_u8p))
        if r != 1:
            err = self._lib.vaw_error(self._handle)
            raise RuntimeError(f"native encode failed: {err.decode() if err else r}")

    def close(self):
        if self._handle:
            h, self._handle = self._handle, None
            status = self._lib.vaw_close(h)
            if status != 0:
                raise RuntimeError(f"native writer close failed ({status})")


def native_concat(segments, output: str) -> None:
    """Lossless stream-copy concat of homogeneous segments (video, audio
    and GPMF data tracks), without an ffmpeg binary."""
    lib = load_concat_library()
    if lib is None:
        raise RuntimeError("native concat not built (make -C native)")
    arr = (ctypes.c_char_p * len(segments))(*[s.encode() for s in segments])
    if lib.va_concat(arr, len(segments), output.encode()) != 0:
        err = lib.va_concat_error()
        raise RuntimeError(f"native concat failed: {err.decode() if err else 'unknown'}")
