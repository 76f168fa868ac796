"""Rolling-shutter correction: per-scanline warp rotations.

Port of ``video_annotator_tpu/smoothing/rolling.py``. CMOS action cameras
read sensor rows out sequentially over a large fraction of the frame
period, so fast rotation skews every frame ("jello"), which a warp with
one transform per frame cannot remove. The fused warp kernel (K1) takes
one rotation per 8-row output tile row instead: per-scanline correction
quantised to 8 rows (0.3% of the readout window at 4K). The tile-row
height 8 is part of the result (output row ``r`` takes rotation ``r //
8``), not tuning. On an NVIDIA H100 80GB HBM3 at 700.00 W a 4K warp
launch with a rotation per tile row took 1.01 to 1.03 times the same
launch with one rotation per frame in the uint8 mode, which the renders
run, and 1.05 to 1.07 times in the float mode
(``tools/time_warp_builds.py``; PERF.md, section 6, keeps the readings).

Model: frame ``t``'s rows are captured over ``[frame_time_t, frame_time_t
+ readout / fps)`` where ``readout`` is the CLI's ``--rolling-shutter``
fraction (GoPro HERO-era sensors measure about 0.75). The measured
trajectory ``M_t`` is referenced to scanline 0; the camera pose at scan
fraction ``f`` is approximated with the frame-rate angular velocity
``w_t = log(M_{t+1} M_t^T)``:

    M(t, f) ~= exp(f * readout * w_t) . M_t

so the warp rotation for an output tile row at fraction ``f`` becomes
``exp(f * readout * w_t) . corr_t``, for visual and gyro trajectories
alike (both provide per-frame measured rotations).
"""

from __future__ import annotations

import torch

from video_annotator_tpu_torch import so3
from video_annotator_tpu_torch.ops.warp_plain import TILE_ROWS
from video_annotator_tpu_torch.smoothing.gyro import integrate_gyro


def scan_fractions(out_camera, in_camera, ny: int) -> torch.Tensor:
    """(ny,) SOURCE scan fraction at each output tile-row centre.

    Output rows are not source rows: a cropped or zoomed output camera's
    row 0 maps well inside the sensor, so the output-row fraction would
    mis-time every scanline. The identity-correction map gives the source
    row each output tile centre samples; the per-frame correction
    perturbs it by at most the stabilisation amplitude (second order).
    """
    ys = torch.arange(ny, dtype=torch.float32) * float(TILE_ROWS) + TILE_ROWS / 2
    xs = torch.full((ny,), float(out_camera.cx), dtype=torch.float32)
    rays = out_camera.unproject(torch.stack([xs, ys], dim=-1))
    src = in_camera.project(rays)
    return torch.clamp(src[:, 1] / float(in_camera.height), 0.0, 1.0)


def rs_row_rotations_gyro(corrections: torch.Tensor, omega: torch.Tensor,
                          ts: torch.Tensor, frame_ts: torch.Tensor,
                          readout_s: float, fractions: torch.Tensor) -> torch.Tensor:
    """(T, ny, 3, 3) per-tile-row warp rotations, EXACT from telemetry.

    ``corrections`` (T, 3, 3) per-frame warp rotations, ``omega`` (S, 3)
    gyro rad/s with sample times ``ts``, ``frame_ts`` (T,) of the trimmed
    range, ``readout_s`` the readout time in SECONDS, ``fractions`` (ny,).
    Where :func:`rs_row_rotations` extrapolates each frame's pose with its
    frame-rate angular velocity (first order), this integrates the gyro
    stream at every scanline time, so acceleration within a frame (whip
    pans, impacts) is captured.
    """
    t = corrections.shape[0]
    ny = fractions.shape[0]
    times = (frame_ts[:, None]
             + fractions[None, :].to(frame_ts.dtype) * readout_s).reshape(-1)
    # One integration pass over frame starts + every scanline time, all
    # rebased at the first frame (the trajectory's reference).
    r = integrate_gyro(omega, ts, torch.cat([frame_ts, times]))
    m = so3.transpose(r)  # measured convention (cf. analyse_gyro)
    m_frames = m[:t]
    m_rows = m[t:].reshape(t, ny, 3, 3)
    delta = so3.matmul(m_rows, so3.transpose(m_frames)[:, None])
    return so3.matmul(delta, corrections.to(torch.float32)[:, None])


def rs_row_rotations(corrections: torch.Tensor, measured: torch.Tensor,
                     readout: float, fractions: torch.Tensor) -> torch.Tensor:
    """(T, ny, 3, 3) per-tile-row warp rotations from (T, 3, 3) per-frame
    warp rotations, the (T, 3, 3) measured trajectory, the readout as a
    fraction of 1 / fps and the (ny,) scan fractions."""
    t = corrections.shape[0]
    ny = fractions.shape[0]
    if t < 2:
        return corrections[:, None].expand(t, ny, 3, 3)
    m = measured.to(torch.float32)
    # Frame-rate angular velocity; the last frame reuses its predecessor's.
    w = so3.log(so3.matmul(m[1:], so3.transpose(m[:-1])))  # (T-1, 3)
    w = torch.cat([w, w[-1:]])  # (T, 3)
    f = fractions.to(torch.float32)
    ang = f[None, :, None] * float(readout) * w[:, None, :]  # (T, ny, 3)
    return so3.matmul(so3.exp(ang), corrections.to(torch.float32)[:, None])
