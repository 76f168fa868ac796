"""Bracketed A/B in one process: row 6's steady state against the 8 x 4K60
multistream fps.

Port of ``benchmarks/bracket.py``. It alternates ``--pairs`` captures of

  (a) the float frame batch's steady-state slope, ``(t(16) - t(4)) / 12``
      ms a frame, through ``ops/warp_kernel.py::warp_frames_f32`` (row 6,
      the counterpart of JAX's ``warp_frames_pallas``): the per-frame
      cost with the launch's constant cost taken out, also given per
      output megapixel; and
  (b) ``tools/run.py``'s ``8x4k60_multistream`` aggregate fps (K1's uint8
      batch, 8 streams x 4 frames a dispatch, two in flight),

so that each multistream figure sits between two slope readings taken
seconds around it: if the pairs move together, the card's state moved
both. ``row6_bound_ms_per_frame`` is row 6's byte bound for one frame
(each float32 input and output pixel once at the card's memory rate).

Usage::

    python -m video_annotator_tpu_torch.tools.bracket [--pairs 4] [--trials 3]
        [--size 3840x2880] [--device cuda|cpu] [--out PATH]

Writes the stamped result to ``--out`` (default ``chiprun_out/bracket.json``
in the checkout) and prints it. Without a card it exits 1 unless
``--device cpu`` is given (the plain versions, at a small ``--size``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from video_annotator_tpu_torch.tools.provenance import stamp
from video_annotator_tpu_torch.tools.roofline import HBM_BYTES_PER_S
from video_annotator_tpu_torch.tools.run import multistream, stock_warper

REPO = Path(__file__).resolve().parents[2]
B_BIG, B_SMALL = 16, 4


def _time_batched(fn, *args, reps=5, depth=2, dev=torch.device("cuda")):
    """Best seconds a call of ``fn(*args)`` over ``reps`` readings of
    ``2 * depth`` calls queued back to back, then synchronised."""
    fn(*args)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(depth * 2):
            fn(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        best = min(best, (time.perf_counter() - t0) / (depth * 2))
    return best


def main(argv=None) -> int:
    from video_annotator_tpu_torch import so3
    from video_annotator_tpu_torch.ops import warp_kernel

    ap = argparse.ArgumentParser(description="row 6's slope against the multistream fps")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--trials", type=int, default=3,
                    help="multistream best-of trials per capture")
    ap.add_argument("--size", default="3840x2880", help="input WxH (the stock 4K default)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; exits 1 without a card) or cpu (the plain versions)")
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "bracket.json"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bracket: no CUDA device (--device cpu runs the plain versions)",
              file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    w, h = (int(v) for v in args.size.split("x"))
    in_cam, warper = stock_warper(w, h, dev)
    out_cam = warper.out_cam
    size = (warper.out_h, warper.out_w)
    out_mpix = size[0] * size[1] / 1e6

    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.integers(0, 255, (h, w), dtype=np.uint8)).to(dev)
    rot = so3.exp(torch.tensor([0.02, -0.02, 0.01], dtype=torch.float32, device=dev))
    big = (img.to(torch.float32).expand(B_BIG, h, w).contiguous(), rot.expand(B_BIG, 3, 3))
    small = (big[0][:B_SMALL].contiguous(), rot.expand(B_SMALL, 3, 3))

    def row6(frames, rots):
        return warp_kernel.warp_frames_f32(frames, rots, out_cam, in_cam, size)

    def capture_slope_ms():
        dt_b = _time_batched(row6, *big, dev=dev)
        dt_s = _time_batched(row6, *small, dev=dev)
        return (dt_b - dt_s) / (B_BIG - B_SMALL) * 1e3

    run_multistream, n_frames = multistream(dev, w, h)

    def capture_multistream():
        best = float("inf")
        for t in range(args.trials):
            t0 = time.perf_counter()
            run_multistream()
            best = min(best, time.perf_counter() - t0)
        return n_frames / best

    # Warm both paths before the first capture.
    capture_slope_ms()
    run_multistream()

    t_start = time.time()
    pairs = []
    for _ in range(args.pairs):
        ms = capture_slope_ms()
        t_ms = time.time() - t_start
        fps = capture_multistream()
        t_fps = time.time() - t_start
        ms2 = capture_slope_ms()
        t_ms2 = time.time() - t_start
        ms_mid = 0.5 * (ms + ms2)
        pairs.append({
            "slope_ms_per_frame_before": round(ms, 5),
            "t_before_s": round(t_ms, 1),
            "multistream_fps": round(fps, 2),
            "t_fps_s": round(t_fps, 1),
            "slope_ms_per_frame_after": round(ms2, 5),
            "t_after_s": round(t_ms2, 1),
            "slope_ms_per_output_mpix": round(ms_mid / out_mpix, 5),
            "t_frame_ms": round(1e3 / fps, 3),
        })
        print(json.dumps(pairs[-1]), file=sys.stderr, flush=True)

    mids = [0.5 * (p["slope_ms_per_frame_before"] + p["slope_ms_per_frame_after"])
            for p in pairs]
    fpss = [p["multistream_fps"] for p in pairs]
    out = {
        "metric": "bracketed_8x4k60_vs_row6_slope",
        "geometry": f"{w}x{h}",
        "output": f"{size[1]}x{size[0]}",
        "pairs": pairs,
        "window_s": round(time.time() - t_start, 1),
        "slope_spread": round(max(mids) / min(mids), 3),
        "fps_spread": round(max(fpss) / min(fpss), 3),
        "corr_inv_fps_vs_slope": round(float(np.corrcoef(
            1.0 / np.asarray(fpss), np.asarray(mids))[0, 1]), 3) if len(pairs) >= 3 else None,
        "row6_bound_ms_per_frame": round((h * w + size[0] * size[1]) * 4
                                         / HBM_BYTES_PER_S * 1e3, 5),
        "best_multistream_fps": round(max(fpss), 2),
        "target_fps": 480.0,
    }
    stamp(out, args.device)
    print(json.dumps(out, indent=2))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
