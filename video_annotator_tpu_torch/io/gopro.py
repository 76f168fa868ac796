"""GoPro chaptered-file discovery and joining.

Port of ``video_annotator_tpu/io/gopro.py``, the reference's ``join``
command (``src/join.ts``): GoPro splits a recording into ``GOPR<code>.MP4``
and ``GP01<code>.MP4``, ``GP02<code>.MP4``, ... (``src/join.ts:8-34``),
which the reference concatenates with ffmpeg's concat demuxer, copying
the video, audio and GPMF metadata (``"\\tGoPro MET"``) streams.

Routes, best first (each failure warns and takes the next):

1. ``native``: the libav stream copy of ``native/`` (``io/native.py``),
   lossless, with the audio and GPMF tracks;
2. ``ffmpeg``: the ``ffmpeg`` binary's concat-demuxer stream copy;
3. ``y4m``: raw concatenation of ``.y4m`` chapters (or into a ``.y4m``);
4. ``reencode``: decode and encode through the writers of ``io/video.py``
   (lossy; a warning is printed).

All of it is host IO: no device is involved.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import List


def find_source_segments(code: str, directory: str = ".") -> List[str]:
    """The chapter files of a recording code, in order (``src/join.ts:8-34``)."""
    first = ext = None
    for e in (".MP4", ".mp4", ".y4m"):
        cand = os.path.join(directory, f"GOPR{code}{e}")
        if os.path.exists(cand):
            first, ext = cand, e
            break
    if first is None:
        raise FileNotFoundError(f"no segments found for code {code!r} in {directory!r}")
    segments = [first]
    i = 1
    while True:
        nxt = os.path.join(directory, f"GP{i:02d}{code}{ext}")
        if not os.path.exists(nxt):
            break
        segments.append(nxt)
        i += 1
    return segments


def count_frames(path: str) -> int:
    """Total frame count, for progress reporting (``src/join.ts:36-41``):
    the container's count, else the frames decoded."""
    from video_annotator_tpu_torch.io.video import open_reader

    r = open_reader(path)
    n = r.meta.num_frames
    r.close()
    if n:
        return n
    r = open_reader(path)
    n = sum(1 for _ in r)
    r.close()
    return n


def _join_ffmpeg(segments: List[str], output: str) -> None:
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        for s in segments:
            f.write(f"file '{os.path.abspath(s)}'\n")
        listfile = f.name
    try:
        # Video, audio and the GPMF data track (src/join.ts:59-82).
        subprocess.run(
            ["ffmpeg", "-y", "-f", "concat", "-safe", "0", "-i", listfile,
             "-map", "0:v?", "-map", "0:a?", "-map", "0:d?", "-c", "copy", output],
            check=True, capture_output=True)
    finally:
        os.unlink(listfile)


def _join_decode_encode(segments: List[str], output: str) -> None:
    """Every chapter's frames into one writer (the y4m and re-encode routes)."""
    from video_annotator_tpu_torch.io.video import open_reader, open_writer

    first = open_reader(segments[0])
    writer = open_writer(output, first.meta)
    try:
        for planes in first:
            writer.write(planes)
        first.close()
        for seg in segments[1:]:
            r = open_reader(seg)
            try:
                for planes in r:
                    writer.write(planes)
            finally:
                r.close()
    finally:
        writer.close()


def join(code: str, output: str, directory: str = ".") -> str:
    """Join the chapters of a recording into one file; returns the route
    taken (``native``, ``ffmpeg``, ``y4m`` or ``reencode``)."""
    segments = find_source_segments(code, directory)
    all_y4m = all(s.endswith(".y4m") for s in segments)
    if not output.endswith(".y4m") and not all_y4m:
        try:
            from video_annotator_tpu_torch.io.native import (
                native_concat,
                native_concat_available,
            )

            if native_concat_available():
                native_concat(segments, output)
                return "native"
        except (RuntimeError, OSError) as e:
            print(f"warning: native concat failed ({e}); falling back")
    if shutil.which("ffmpeg") and not output.endswith(".y4m"):
        _join_ffmpeg(segments, output)
        return "ffmpeg"
    if all_y4m or output.endswith(".y4m"):
        _join_decode_encode(segments, output)
        return "y4m"
    print("warning: no ffmpeg binary for lossless stream copy; re-encoding "
          "through OpenCV")
    _join_decode_encode(segments, output)
    return "reencode"
