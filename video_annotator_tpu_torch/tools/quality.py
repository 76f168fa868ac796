"""Stabilisation quality on a synthetic clip with known motion.

Port of ``benchmarks/quality.py``. Each stabiliser family renders the
same shaky synthetic clip end to end through the port (analyse, smooth,
warp, write), and each output is scored on

- ``hf_shake``: the RMS high-frequency inter-frame motion of the output.
  Per frame, the median displacement of 64 corners of a central crop
  (an eighth off each side) tracked into the next frame with the plain
  :func:`~video_annotator_tpu_torch.ops.lk.pyramidal_lk`, on every device,
  as the JAX tool calls its XLA LK (on a card the detection and the LK
  replay as one CUDA graph, as the JAX tool jits them); the series is
  detrended with the smoother's own Savitzky-Golay window, so a pan is
  not shake. In px and in degrees at the output's centre focal.
- ``reduction_db``: ``20 log10(shake_unstabilised / shake_out)`` against
  the family's unstabilised render (same output camera).
- ``traj_rms_deg`` (rotation family): the RMS angle between the analysed
  trajectory and the synthetic ground truth.

The rotation configs render at a narrow ``--output-dfov`` (70 degrees) so
that every output pixel is valid in every frame; the 2D families keep the
input canvas. The 18 configs and their options are the JAX tool's.

On a card the renders analyse with K2 and K3 and encode with K1 (the
uint8 batch, its 4-tap, mip and per-tile-row modes, the one-frame form for
the similarity family); the analysers track every level the plain LK
tracks, K2 on the levels it can stage and the plain level on the others
(at 640x480 the third, 160x120; at ``--analysis-scale 0.25`` both of the
two). ``--device cpu`` runs the plain versions and tracks with the plain
LK.

Usage::

    python -m video_annotator_tpu_torch.tools.quality [--w 640 --h 480 --n 150 --radius 15]
        [--device cuda|cpu] [--out PATH]

Prints one JSON object per config and writes the stamped list to
``--out`` (default ``chiprun_out/quality.json`` in the checkout). Without
a card it exits 1 unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from fractions import Fraction
from pathlib import Path

import numpy as np
import torch

from video_annotator_tpu_torch import so3
from video_annotator_tpu_torch.camera import CameraPreset
from video_annotator_tpu_torch.io.synthetic import SyntheticSource
from video_annotator_tpu_torch.io.video import VideoMeta, open_reader
from video_annotator_tpu_torch.ops import cuda_lib
from video_annotator_tpu_torch.ops.corners import detect_corners
from video_annotator_tpu_torch.ops.lk import pyramidal_lk
from video_annotator_tpu_torch.pipeline import render as trender
from video_annotator_tpu_torch.pipeline.trajectory import Trajectory, trajectory_path
from video_annotator_tpu_torch.smoothing.savgol import savgol_weights
from video_annotator_tpu_torch.tools.provenance import stamp

REPO = Path(__file__).resolve().parents[2]


def track(prev: torch.Tensor, nxt: torch.Tensor):
    """64 corners of ``prev`` tracked into ``nxt``: ``(pts, new, ok)``."""
    pts, valid = detect_corners(prev, max_corners=64, min_distance=24, border=16)
    new, ok = pyramidal_lk(prev, nxt, pts, valid)
    return pts, new, ok


def measure_shake(path: str, radius: int, device="cpu") -> float:
    """RMS high-frequency inter-frame translation (px) of a video's luma."""
    dev = torch.device(device)
    reader = open_reader(path)
    shifts = []
    prev = tracker = None
    try:
        for y, _, _ in reader:
            # Central crop: the 2D families' border band swims with the
            # correction; the scene, not the border, is the signal.
            h, w = y.shape
            c = torch.from_numpy(
                np.ascontiguousarray(y[h // 8: h - h // 8, w // 8: w - w // 8])
            ).to(dev, torch.float32)
            if prev is not None:
                # On a card the detection and the LK replay as one CUDA graph.
                tracker = tracker or (cuda_lib.graphed(track, prev, c) if dev.type == "cuda"
                                      else track)
                pts, new, ok = tracker(prev, c)
                d = (new - pts).cpu().numpy()
                okn = ok.cpu().numpy()
                shifts.append(np.median(d[okn], axis=0) if okn.sum() >= 8 else np.zeros(2))
            prev = c
    finally:
        reader.close()
    d = np.asarray(shifts)  # (T-1, 2) per-frame (dx, dy)
    if len(d) < 3:
        return 0.0
    # Detrend with the smoother's SG window, replicate-padded: pans
    # survive, jitter remains.
    w_sg = np.asarray(savgol_weights(radius, 2), np.float64)
    r = len(w_sg) // 2
    padded = np.concatenate([np.repeat(d[:1], r, axis=0), d, np.repeat(d[-1:], r, axis=0)])
    trend = np.stack([np.convolve(padded[:, i], w_sg, mode="valid") for i in range(2)],
                     axis=-1)
    hf = d - trend
    return float(np.sqrt((hf ** 2).sum(axis=1).mean()))


def traj_rms_deg(dest: str, src: str) -> float:
    """RMS angle (deg) between the analysed trajectory and ground truth."""
    traj = Trajectory.load(trajectory_path(dest))
    cfg = SyntheticSource.from_uri(src).config
    r_true = cfg.rotations()  # R_t applied to rays; the camera is R_t^-1
    r_expect = r_true.transpose(0, 2, 1) @ r_true[0]
    r_est = traj.rotations()
    n = min(len(r_est), len(r_expect))
    errs = [float(torch.linalg.vector_norm(so3.log(torch.from_numpy(
        np.asarray(r_est[t] @ r_expect[t].T, np.float32)))))
        for t in range(n)]
    return float(np.degrees(np.sqrt(np.mean(np.square(errs)))))


def configs(dfov: float):
    """(name, options, baseline name or None) of each row, in order."""
    rot = dict(output_dfov=dfov)
    return [
        ("unstabilized", dict(stabilise="none", **rot), None),
        ("rotation_smooth_savgol", dict(stabilise="smooth", **rot), "unstabilized"),
        ("rotation_smooth_scale05", dict(stabilise="smooth", analysis_scale=0.5, **rot),
         "unstabilized"),
        ("rotation_smooth_scale025", dict(stabilise="smooth", analysis_scale=0.25, **rot),
         "unstabilized"),
        ("rotation_smooth_paired", dict(stabilise="smooth", analysis_mode="paired", **rot),
         "unstabilized"),
        ("rotation_smooth_paired_scale05",
         dict(stabilise="smooth", analysis_mode="paired", analysis_scale=0.5, **rot),
         "unstabilized"),
        ("rotation_smooth_paired_detect0",
         dict(stabilise="smooth", analysis_mode="paired", analysis_detect_level=0, **rot),
         "unstabilized"),
        ("rotation_smooth_paired_scale05_detect0",
         dict(stabilise="smooth", analysis_mode="paired", analysis_scale=0.5,
              analysis_detect_level=0, **rot),
         "unstabilized"),
        ("rotation_smooth_kalman", dict(stabilise="smooth", smoother="kalman", **rot),
         "unstabilized"),
        ("rotation_smooth_kalman_streaming",
         dict(stabilise="smooth", smoother="kalman", streaming=True, **rot), "unstabilized"),
        ("rotation_fixed", dict(stabilise="fixed", **rot), "unstabilized"),
        ("rotation_smooth_bicubic", dict(stabilise="smooth", interp="bicubic", **rot),
         "unstabilized"),
        ("rotation_smooth_lanczos", dict(stabilise="smooth", interp="lanczos", **rot),
         "unstabilized"),
        ("rotation_smooth_prefilter", dict(stabilise="smooth", prefilter="auto", **rot),
         "unstabilized"),
        # The synthetic source is global-shutter: this row scores the cost of
        # asserting a readout the sensor does not have.
        ("rotation_smooth_rollingshutter", dict(stabilise="smooth", rolling_shutter=0.5, **rot),
         "unstabilized"),
        ("unstabilized_2d", dict(filter="similarity", stabilise="none"), None),
        ("similarity_smooth", dict(filter="similarity", stabilise="smooth"), "unstabilized_2d"),
        ("deshake_smooth", dict(filter="deshake", stabilise="smooth"), "unstabilized_2d"),
    ]


def run(w: int, h: int, n: int, shake: float, radius: int, dfov: float, device="cuda",
        log=print) -> list:
    """Render and score every config; returns the rows (unstamped)."""
    src = f"synthetic://shaky?w={w}&h={h}&n={n}&seed=11&shake={shake}&pan=0.002"
    base = dict(
        preset=CameraPreset.GOPRO_H4B_WIDE43_MEASURED,
        stabilise_radius=radius,
        # Rows name their formulation: the sequential tracker unless a row
        # says paired, whatever "auto" resolves to on this device.
        analysis_mode="tracked",
        # No extra canvas, so every rotation config renders the same
        # output camera (the same px per degree).
        stabilise_buffer=0.0,
    )
    # px -> degrees at the output's centre: the narrow output camera's
    # focal for the rotation family, the input's for the 2D families.
    meta = VideoMeta(w, h, Fraction(30, 1), n)
    in_cam, rot_out_cam = trender.build_cameras(
        meta, trender.RenderOptions(**base, stabilise="none", output_dfov=dfov))
    px_per_rad = {"rotation": float(rot_out_cam.fx), "2d": float(in_cam.fx)}

    rows = []
    shakes = {}
    with tempfile.TemporaryDirectory() as td:
        for name, opts, baseline in configs(dfov):
            dest = os.path.join(td, f"{name}.y4m")
            trender.render(src, dest, trender.RenderOptions(**{**base, **opts}), device=device)
            shake = measure_shake(dest, radius, device)
            shakes[name] = shake
            fam = "rotation" if "output_dfov" in opts else "2d"
            row = {
                "config": name,
                "metric": "hf_shake_px_rms",
                "value": round(shake, 4),
                "unit": "px",
                "hf_shake_deg_rms": round(float(np.degrees(shake / px_per_rad[fam])), 4),
            }
            if baseline is not None:
                row["reduction_db"] = round(float(
                    20.0 * np.log10(max(shakes[baseline], 1e-9) / max(shake, 1e-9))), 2)
            if opts.get("stabilise") != "none" and opts.get("filter", "rotation") == "rotation":
                row["traj_rms_deg"] = round(traj_rms_deg(dest, src), 4)
            rows.append(row)
            log(json.dumps(row))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="stabilisation quality on a synthetic clip")
    ap.add_argument("--w", type=int, default=640)
    ap.add_argument("--h", type=int, default=480)
    ap.add_argument("--n", type=int, default=150)
    ap.add_argument("--shake", type=float, default=0.008)
    ap.add_argument("--radius", type=int, default=15)
    ap.add_argument("--dfov", type=float, default=70.0,
                    help="rotation-family output dfov (narrow: all output pixels valid)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; exits 1 without a card) or cpu (the plain versions)")
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "quality.json"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("quality: no CUDA device (--device cpu runs the plain versions)", file=sys.stderr)
        return 1
    rows = run(args.w, args.h, args.n, args.shake, args.radius, args.dfov, args.device,
               log=lambda line: print(line, flush=True))
    for row in rows:
        stamp(row, args.device)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
