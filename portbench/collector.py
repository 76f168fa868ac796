"""The render's sink: reads each job's y4m output from a FIFO.

Run as its own process (``python3 portbench/collector.py``), numpy only, so
that reading the frames takes no time of the process under test. It
stands in for the external encoder that reads a render's y4m pipe.

Protocol, one JSON object a line on standard input:

- ``{"fifo": PATH, "sample": [i, ...]}``: open the FIFO (this waits for
  the render to open it for writing), read the header and every frame to
  the end, stamp each frame's arrival on the monotonic clock, keep the
  frames whose indices are listed and drop the rest;
- ``{"stop": true}``: write to standard output one JSON line, a list with
  one summary per job (``frames``, ``width``, ``height``, ``bad``: frames
  cut short or without their marker, ``t_first``, ``t_last``, ``kept``:
  the indices kept), then the kept frames' bytes in that order, and exit.
"""

from __future__ import annotations

import json
import os
import sys
import time

MARKER = b"FRAME\n"


def read_exact(fd: int, view: memoryview) -> int:
    got = 0
    while got < len(view):
        n = os.readv(fd, [view[got:]])
        if n == 0:
            break
        got += n
    return got


def read_line(fd: int, limit: int = 4096) -> bytes:
    out = bytearray()
    while len(out) < limit:
        b = os.read(fd, 1)
        if not b:
            break
        out += b
        if b == b"\n":
            break
    return bytes(out)


def parse_header(line: bytes):
    if not line.startswith(b"YUV4MPEG2"):
        return None
    fields = {tok[:1]: tok[1:] for tok in line.split()[1:]}
    return int(fields[b"W"]), int(fields[b"H"])


def collect(path: str, sample: set, kept: list) -> dict:
    fd = os.open(path, os.O_RDONLY)
    try:
        size = parse_header(read_line(fd))
        summary = {"frames": 0, "width": 0, "height": 0, "bad": 0, "t_first": None,
                   "t_last": None, "kept": []}
        if size is None:
            summary["bad"] = 1
            return summary
        w, h = size
        summary["width"], summary["height"] = w, h
        buf = bytearray(w * h * 3 // 2)
        view = memoryview(buf)
        marker = bytearray(len(MARKER))
        while True:
            n = read_exact(fd, memoryview(marker))
            if n == 0:
                break
            if n < len(MARKER) or bytes(marker) != MARKER or read_exact(fd, view) < len(buf):
                summary["bad"] += 1
                break
            now = time.monotonic()
            if summary["t_first"] is None:
                summary["t_first"] = now
            summary["t_last"] = now
            if summary["frames"] in sample:
                kept.append(bytes(buf))
                summary["kept"].append(summary["frames"])
            summary["frames"] += 1
        return summary
    finally:
        os.close(fd)


def main() -> int:
    jobs, kept = [], []
    for line in sys.stdin:
        cmd = json.loads(line)
        if cmd.get("stop"):
            break
        jobs.append(collect(cmd["fifo"], set(cmd.get("sample", ())), kept))
    out = sys.stdout.buffer
    out.write((json.dumps(jobs) + "\n").encode())
    for frame in kept:
        out.write(frame)
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
