"""Device op micro-benchmarks, the ``OpenClTest`` analogue: port of
``video_annotator_tpu/benchtool.py``.

The reference ships a micro-benchmark of its core image ops across
execution paths, mean and standard deviation over repeated runs
(``opencv/OpenClTest.cpp:65-427``). This tool times the port's hot ops on
one device, each hand-written kernel beside its plain PyTorch version:
the warp (K1's float mode, row 5), ``detect_corners``, pyramidal LK over
256 points (staged by K3, tracked by K2) and the Savitzky-Golay smoother.
On the CPU only the plain rows run. A row that fails prints its error and
the rest go on; the tool then exits non-zero.

Run: ``python -m video_annotator_tpu_torch.benchtool [--size WxH]
[--reps N] [--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
import traceback

import numpy as np
import torch

from video_annotator_tpu_torch import so3
from video_annotator_tpu_torch.camera import CameraPreset, get_output_camera, get_preset_camera
from video_annotator_tpu_torch.ops import warp_kernel
from video_annotator_tpu_torch.ops.corners import detect_corners
from video_annotator_tpu_torch.ops.lk_kernel import (
    pyramidal_lk_packed,
    pyramidal_lk_plain,
    stage_pyramid,
)
from video_annotator_tpu_torch.smoothing.savgol import smooth_rotations


def _time(fn, reps: int, sync):
    """(throughput ms, latency ms, its sd): calls issued back to back, then
    calls each waited for."""
    sync(fn())  # warm up
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = fn()
    sync(out)
    thru = (time.perf_counter() - t0) / reps * 1000.0

    times = []
    for _ in range(max(reps // 3, 2)):
        t0 = time.perf_counter()
        sync(fn())
        times.append((time.perf_counter() - t0) * 1000.0)
    return thru, statistics.fmean(times), statistics.stdev(times)


def pyramidal_lk(img, img2, pts, valid):
    """Track ``pts`` from ``img`` to ``img2`` (float32 frames): the
    pyramids staged by K3 and tracked by K2."""
    return pyramidal_lk_packed(stage_pyramid(img), stage_pyramid(img2), tuple(img.shape),
                               pts, valid)


def rows(device: torch.device, w: int, h: int) -> list:
    """(name, function) of every row on ``device``: a kernel's row only on
    a CUDA device."""
    cuda = device.type == "cuda"
    rng = np.random.default_rng(0)
    img, img2 = (torch.from_numpy(np.round(rng.uniform(0, 255, (h, w))).astype(np.float32))
                 .to(device) for _ in range(2))
    in_cam = get_preset_camera(CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (w, h))
    out_cam = get_output_camera(in_cam, crop_borders=True)
    size = (out_cam.height, out_cam.width)
    rot = so3.exp(torch.tensor([0.02, -0.01, 0.03])).to(device)
    out = []
    if cuda:
        out.append(("warp (K1, row 5)",
                    lambda: warp_kernel.warp_frame_f32(img, rot, out_cam, in_cam, size)))
    out.append(("warp (plain)", lambda: warp_kernel.warp_planes_f32_plain(
        img[None], rot, out_cam, in_cam, size)))
    out.append(("detect_corners", lambda: detect_corners(img)))
    pts, valid = detect_corners(img)
    out.append(("pyramidal_lk (256 pts, plain)",
                lambda: pyramidal_lk_plain(img, img2, pts, valid)))
    if cuda:
        out.append(("pyramidal_lk (K3 + K2)",
                    lambda: pyramidal_lk(img, img2, pts, valid)))
    traj = so3.exp(torch.from_numpy(rng.normal(size=(600, 3)) * 0.01).to(torch.float32)
                   ).to(device)
    out.append(("sg smooth (600 frames, r=90)", lambda: smooth_rotations(traj, radius=90)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Device op micro-benchmarks")
    ap.add_argument("--size", default="1920x1440")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    w, h = (int(v) for v in args.size.lower().split("x"))
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("benchtool: no CUDA device (--device cpu runs the plain rows)", file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    print(f"device: {name}, torch {torch.__version__}, {args.reps} reps, {w}x{h}")
    print(f"{'op':32s} {'throughput':>12s} {'latency':>18s}")
    failed = 0
    for label, fn in rows(device, w, h):
        try:
            thru, lat, sd = _time(fn, args.reps, lambda _: sync())
            print(f"{label:32s} {thru:9.3f} ms {lat:11.3f} ± {sd:5.2f} ms")
        except Exception as e:  # keep reporting the rest, then fail
            failed += 1
            print(f"{label:32s} FAILED: {str(e).splitlines()[0][:90]}")
            traceback.print_exc()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
