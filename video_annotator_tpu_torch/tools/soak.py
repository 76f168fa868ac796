"""Sustained end-to-end soak: a long render through the whole pipeline.

Port of ``benchmarks/soak.py``. It drives the render path (decode,
prefetch, the paired analyse on the card, smoothing, K1's uint8 batch,
the y4m sink; ``--encoder libx264`` adds the native encoder) in child
processes of ``python -m video_annotator_tpu_torch render ... --device
<device>`` and reports:

- ``segment_fps``: three sequential renders, each a third of the clip;
  ``decay_free`` is false only for a strictly monotone decline that ends
  under 0.7 of the first segment;
- RSS from 1 Hz ``/proc`` timelines of the children: the peak, the
  plateau (median of the last third of samples), the late slope (MB/min
  over the second half), ``peak_rss_ok`` against ``--max-rss-mb``;
- ``rss_attribution``: the same render with ``--device cpu`` at two frame
  counts (``cpu_backend``); flat steady RSS across them
  (``cpu_rss_flat``) and a late slope under 0.5 MB a frame
  (``cpu_slope_ok``) are the leak evidence; the card children's own peak
  over the CPU baseline and late slope per frame
  (``card_excess_mb_per_frame``, ``card_slope_mb_per_frame``) are
  attributed, not gated;
- ``rss_ok``: the ceiling and the leak evidence together.

An untimed warm-up render first builds the kernels and fills the caches.

The input (``--source``) is the JAX tool's procedural clip: an H.264 MP4
through the native writer (``mp4``, the default; it needs the native
libraries), or the same frames as raw y4m through ``io/y4m.py``
(``y4m``). Nothing switches the source on its own.

Usage::

    python -m video_annotator_tpu_torch.tools.soak [--frames 600]
        [--width 1920 --height 1440] [--source mp4|y4m] [--device cuda|cpu]
        [--no-attribution] [--out PATH]

Prints one stamped JSON line and writes it to ``--out`` (default
``chiprun_out/soak.json`` in the checkout). Without a card it exits 1
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
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


def input_frames(n: int, w: int, h: int):
    """The soak clip's n (y, u, v) uint8 frames, in numpy: crossed
    sinusoids (trackable corners without the everything-matches motion
    search a rolled checkerboard hands x264), shifted a few pixels a
    frame."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = (
        128
        + 55 * np.sin(xx / 23.0) * np.cos(yy / 31.0)
        + 45 * np.sin((xx + yy) / 57.0)
    )
    grad = (xx * 255.0 / max(w - 1, 1))
    rng = np.random.default_rng(0)
    for i in range(n):
        dx = int(8 * np.sin(i / 9.0) + rng.normal() * 3)
        dy = int(6 * np.cos(i / 7.0) + rng.normal() * 3)
        y = np.clip(np.roll(np.roll(base, dy, axis=0), dx, axis=1), 0, 255).astype(np.uint8)
        u = np.roll(grad, dx, axis=1)[::2, ::2].astype(np.uint8)
        v = np.roll(grad[::-1], dy, axis=0)[::2, ::2].astype(np.uint8)
        yield y, u, v


def make_input(path: str, n: int, w: int, h: int) -> None:
    """Write the soak clip to ``path``: raw y4m (``io/y4m.py``) for a
    ``.y4m`` path, else H.264 through the native writer, which must be
    built."""
    if path.endswith(".y4m"):
        from video_annotator_tpu_torch.io.y4m import Y4MWriter

        sink = Y4MWriter(path, w, h, Fraction(30, 1))
        try:
            for planes in input_frames(n, w, h):
                sink.write(*planes)
        finally:
            sink.close()
        return
    from video_annotator_tpu_torch.io.native import NativeVideoWriter
    from video_annotator_tpu_torch.io.video import VideoMeta

    sink = NativeVideoWriter(path, VideoMeta(w, h, Fraction(30, 1), n), encoder="libx264")
    try:
        for planes in input_frames(n, w, h):
            sink.write(planes)
    finally:
        sink.close()


def write_once(path: str, write) -> bool:
    """Call ``write(part)`` for a file under a temporary name beside
    ``path`` (same extension) and rename it to ``path`` once written,
    unless ``path`` is there already: a run cut short leaves no partial
    file that a later run would take for the whole clip. Returns whether
    it wrote."""
    if os.path.exists(path):
        return False
    root, ext = os.path.splitext(path)
    part = f"{root}.part{os.getpid()}{ext}"
    try:
        write(part)
        os.replace(part, path)
    finally:
        if os.path.exists(part):
            os.unlink(part)
    return True


def _run_render(args, env) -> dict:
    """Run one render child, sampling its RSS timeline from /proc.

    Returns ``{dt, peak_mb, steady_mb, slope_mb_per_min}``: ``steady_mb``
    is the median of the final third of samples (the plateau after
    imports, builds and ring fill), the slope the growth over the second
    half of the timeline."""
    samples: list = []
    t0 = time.time()
    p = subprocess.Popen(args, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)

    def sample():
        while p.poll() is None:
            try:
                with open(f"/proc/{p.pid}/status") as f:
                    for line in f:
                        if line.startswith("VmRSS"):
                            samples.append(int(line.split()[1]) // 1024)
                            break
            except FileNotFoundError:
                return
            time.sleep(1.0)

    th = threading.Thread(target=sample)
    th.start()
    out, _ = p.communicate()
    th.join()
    dt = time.time() - t0
    if p.returncode != 0:
        print(out[-3000:], file=sys.stderr)
        raise SystemExit(f"soak render failed (rc={p.returncode})")
    tail = samples[-max(1, len(samples) // 3):] or [0]
    half = samples[len(samples) // 2:]
    if len(half) >= 4:
        q = len(half) // 2
        slope = (
            (sorted(half[q:])[len(half[q:]) // 2] - sorted(half[:q])[q // 2])
            / max(len(half) / 2.0 / 60.0, 1e-9)
        )
    else:
        slope = 0.0
    return {
        "dt": dt,
        "peak_mb": max(samples) if samples else 0,
        "steady_mb": sorted(tail)[len(tail) // 2],
        "slope_mb_per_min": round(slope, 1),
    }


def run_soak(frames: int, w: int, h: int, keep: bool = False, encoder: str = "y4m",
             max_rss_mb: float = 4096.0, attribution: bool = True, device="cuda",
             source: str = "mp4") -> dict:
    tmp = tempfile.gettempdir()
    src = os.path.join(tmp, f"soak_in_{w}x{h}_{frames}.{source}")
    dst = os.path.join(tmp, "soak_out.y4m" if encoder == "y4m" else "soak_out.mp4")
    t0 = time.time()
    if write_once(src, lambda part: make_input(part, frames, w, h)):
        print(f"# input written in {time.time() - t0:.0f}s "
              f"({os.path.getsize(src) / 1e6:.0f} MB)", file=sys.stderr)

    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")

    def render_args(start_f: int, dur_f: int, dev=device):
        a = [
            sys.executable, "-m", "video_annotator_tpu_torch", "render",
            src, dst, "--stabilise", "smooth", "--stabilise-radius", "30",
            "-s", str(start_f / 30.0), "-d", str(dur_f / 30.0),
            # Pinned: auto resolves to paired on a card but tracked on the
            # CPU, and the attribution children must run the same pipeline.
            "--analysis-mode", "paired", "--device", dev,
        ]
        if encoder != "y4m":
            a += ["--encoder", encoder]
        return a

    warm_frames = max(16, frames // 10)
    wres = _run_render(render_args(0, warm_frames), env)
    print(f"# warmup {warm_frames}f in {wres['dt']:.0f}s", file=sys.stderr)

    nseg = 3
    seg_frames = frames // nseg
    segs = []
    t_all = time.time()
    for s in range(nseg):
        segs.append(_run_render(render_args(s * seg_frames, seg_frames), env))
    wall = time.time() - t_all
    fps = [seg_frames / r["dt"] for r in segs]
    peak = max(r["peak_mb"] for r in segs)
    steady = max(r["steady_mb"] for r in segs)
    slope = max(r["slope_mb_per_min"] for r in segs)
    # No compounding monotone decline: fail only when fps strictly
    # decreases across every segment and ends under 0.7 of the first.
    monotone_decline = all(a > b for a, b in zip(fps, fps[1:]))
    decay_free = not (monotone_decline and fps[-1] < 0.7 * fps[0])

    attrib = None
    if attribution:
        # The low count matches the segments' frames a child, so the card
        # children's excess divides like for like; the high one spreads
        # about 2.5x above it for the flatness claim.
        counts = sorted({seg_frames, min(frames, max(500, round(2.5 * seg_frames)))})
        if len(counts) < 2:
            counts = sorted({max(1, seg_frames // 2), seg_frames})
        cpu_runs = {}
        for c in counts:
            r = _run_render(render_args(0, c, "cpu"), env)
            cpu_runs[str(c)] = {
                "steady_rss_mb": r["steady_mb"],
                "peak_rss_mb": r["peak_mb"],
                "fps": round(c / r["dt"], 2),
                "slope_mb_per_min": r["slope_mb_per_min"],
                "slope_mb_per_frame": round(
                    r["slope_mb_per_min"] / max(60.0 * c / r["dt"], 1e-9), 3),
            }
            print(f"# cpu {c}f: steady {r['steady_mb']} MB, peak {r['peak_mb']} MB, "
                  f"slope {r['slope_mb_per_min']} MB/min", file=sys.stderr)
        lo, hi = cpu_runs[str(counts[0])], cpu_runs[str(counts[-1])]
        flat = (hi["steady_rss_mb"] - lo["steady_rss_mb"]
                <= max(0.15 * lo["steady_rss_mb"], 150))
        # 0.5 MB a frame: an eighth of a 1920x1440 YUV frame, well under a
        # buffer leaked a frame, well over sampling noise.
        cpu_slope_ok = all(r["slope_mb_per_frame"] <= 0.5 for r in cpu_runs.values())
        card_slope_pf = max(
            r["slope_mb_per_min"] / max(60.0 * seg_frames / r["dt"], 1e-9) for r in segs)
        attrib = {
            "cpu_backend": cpu_runs,
            "cpu_rss_flat": bool(flat),
            "cpu_slope_ok": bool(cpu_slope_ok),
            "card_excess_mb_per_frame": round(
                max(0.0, (peak - lo["peak_rss_mb"]) / max(seg_frames, 1)), 2),
            "card_slope_mb_per_frame": round(card_slope_pf, 2),
        }
    out = {
        "metric": "soak_fps",
        "frames": frames,
        "width": w,
        "height": h,
        "source": source,
        "device": device,
        "value": round(frames / wall, 1),
        "segment_fps": [round(f, 2) for f in fps],
        "segment_spread": round(max(fps) / max(min(fps), 1e-9), 2),
        "decay_free": bool(decay_free),
        "peak_rss_mb": peak,
        "steady_rss_mb": steady,
        "rss_late_slope_mb_per_min": slope,
        "rss_ceiling_mb": max_rss_mb,
        "peak_rss_ok": bool(peak <= max_rss_mb),
    }
    if attrib is not None:
        out["rss_attribution"] = attrib
    out["rss_ok"] = bool(
        out["peak_rss_ok"]
        and (attrib is None or (attrib["cpu_rss_flat"] and attrib["cpu_slope_ok"])))
    if not keep and os.path.exists(dst):
        os.unlink(dst)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="sustained end-to-end soak")
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1440)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--encoder", default="y4m",
                    help="y4m (raw sink, default: measures the pipeline) "
                         "or a libav encoder name (adds it to the loop)")
    ap.add_argument("--max-rss-mb", type=float, default=4096.0,
                    help="RSS ceiling per render child; exceeding it records rss_ok=false")
    ap.add_argument("--no-attribution", dest="attribution", action="store_false",
                    help="skip the --device cpu RSS comparison renders")
    ap.add_argument("--source", choices=("mp4", "y4m"), default="mp4",
                    help="the input clip: H.264 through the native writer (default) or y4m")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; exits 1 without a card) or cpu (the plain versions)")
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "soak.json"),
                    help="also write the JSON record here ('' disables)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("soak: no CUDA device (--device cpu runs the plain versions)", file=sys.stderr)
        return 1
    result = run_soak(args.frames, args.width, args.height, keep=args.keep,
                      encoder=args.encoder, max_rss_mb=args.max_rss_mb,
                      attribution=args.attribution, device=args.device, source=args.source)
    stamp(result, args.device)
    print(json.dumps(result))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
