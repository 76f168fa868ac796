"""Host decode feed: how many 4K60 streams can this host decode?

Port of ``benchmarks/host_feed.py``. 8 x 4K60 needs the host to decode
about 8 x 60 x 16.6 MB/s of I420 pixels before the card sees a frame;
``tools/run.py``'s ``8x4k60_multistream`` measures the card's half. This
tool measures the host's:

- encode a textured synthetic clip with the native writer (libx264);
- decode it with K ``NativeVideoSource`` instances at once (each a
  demux and decode thread with libavcodec's frame threads, the render's
  feed path), for K in ``--loaders`` (1, 2, 4): aggregate and per-loader
  frames/s and GB/s.

No kernel runs. It needs the native libraries (``make -C native``, libav
development files): without them it says so and exits 1.

Usage::

    python -m video_annotator_tpu_torch.tools.host_feed [--w 3840 --h 2880 --frames 96]
        [--loaders 1 2 4] [--device cuda|cpu] [--out PATH]

Prints one JSON line per row and writes the stamped rows to ``--out``
(default ``chiprun_out/host_feed.json`` in the checkout). ``--device``
names the machine the stamp records (the card's, or ``cpu``); without a
card it exits 1 unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time
from fractions import Fraction
from pathlib import Path

import numpy as np
import torch

from video_annotator_tpu_torch.tools.provenance import stamp

REPO = Path(__file__).resolve().parents[2]


def clip_frames(w: int, h: int, frames: int):
    """The clip's (y, u, v) uint8 frames: a shifted sinusoid field plus
    fixed noise (flat frames compress to nothing and decode unrealistically
    fast), chroma flat."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 96.0 + 48.0 * np.sin(xx / 17.0) + 32.0 * np.cos(yy / 23.0 + xx / 41.0)
    noise = rng.normal(0.0, 12.0, size=(h, w)).astype(np.float32)
    for i in range(frames):
        y = np.clip(np.roll(base, 3 * i, axis=1) + noise, 0, 255).astype(np.uint8)
        u = np.full((h // 2, w // 2), 110 + (i % 16), np.uint8)
        v = np.full((h // 2, w // 2), 140, np.uint8)
        yield y, u, v


def make_clip(path: str, w: int, h: int, frames: int) -> None:
    """Encode :func:`clip_frames` with the native writer (libx264)."""
    from video_annotator_tpu_torch.io.native import NativeVideoWriter
    from video_annotator_tpu_torch.io.video import VideoMeta

    wr = NativeVideoWriter(path, VideoMeta(w, h, Fraction(60, 1)))
    try:
        for planes in clip_frames(w, h, frames):
            wr.write(planes)
    finally:
        wr.close()


def decode_all(path: str, counter: list, idx: int) -> None:
    from video_annotator_tpu_torch.io.native import NativeVideoSource

    src = NativeVideoSource(path, ring_frames=8)
    n = 0
    try:
        for _ in iter(src):
            n += 1
    finally:
        src.close()
    counter[idx] = n


def bench_parallel(path: str, k: int, w: int, h: int) -> dict:
    counts = [0] * k
    threads = [threading.Thread(target=decode_all, args=(path, counts, i)) for i in range(k)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    frames = sum(counts)
    bytes_total = frames * (w * h * 3 // 2)
    return {
        "config": f"host_feed_x{k}",
        "loaders": k,
        "frames": frames,
        "metric": "aggregate_decode_fps",
        "value": round(frames / dt, 2),
        "unit": "fps",
        "per_loader_fps": round(frames / dt / k, 2),
        "aggregate_GBps": round(bytes_total / dt / 1e9, 3),
        "streams_4k60_per_core_equiv": round(frames / dt / k / 60.0, 3),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="host decode feed")
    ap.add_argument("--w", type=int, default=3840)
    ap.add_argument("--h", type=int, default=2880)
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--loaders", type=int, nargs="*", default=[1, 2, 4])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the machine the stamp names: cuda (default; exits 1 without a "
                         "card) or cpu")
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "host_feed.json"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("host_feed: no CUDA device (--device cpu runs it here)", file=sys.stderr)
        return 1

    from video_annotator_tpu_torch.io.native import native_available, native_writer_available

    if not (native_available() and native_writer_available()):
        print("host_feed: native loader and writer not built (make -C native)",
              file=sys.stderr)
        return 1

    results = []
    with tempfile.TemporaryDirectory() as td:
        clip = os.path.join(td, "feed.mp4")
        t0 = time.perf_counter()
        make_clip(clip, args.w, args.h, args.frames)
        enc_dt = time.perf_counter() - t0
        meta = {
            "config": "host_feed_clip",
            "w": args.w, "h": args.h, "frames": args.frames,
            "encode_fps": round(args.frames / enc_dt, 2),
            "clip_MB": round(os.path.getsize(clip) / 1e6, 1),
            "cpus": os.cpu_count(),
        }
        results.append(meta)
        print(json.dumps(meta), flush=True)
        for k in args.loaders:
            row = bench_parallel(clip, k, args.w, args.h)
            results.append(row)
            print(json.dumps(row), flush=True)
    for row in results:
        stamp(row, args.device)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
