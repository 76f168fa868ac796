"""Gravity-referenced horizon lock (roll levelling).

Port of ``video_annotator_tpu/smoothing/horizon.py``. The accelerometer
gives an absolute gravity reference, which pins the *roll* degree of
freedom that pure stabilisation leaves floating (smoothing preserves
whatever slow roll drift the trajectory has).

Conventions (those of ``pipeline/render.py``): the measured trajectory
``M_t`` maps frame-0 camera rays to frame-t camera rays; camera axes are
x right, y down, z forward (image "up" is ``-y``).
"""

from __future__ import annotations

import numpy as np
import torch

from video_annotator_tpu_torch import so3
from video_annotator_tpu_torch.smoothing.gyro import integrate_gyro

GRAVITY = 9.80665  # m/s^2
DEFAULT_UP = (0.0, -1.0, 0.0)  # the first frame taken as level


def estimate_up_direction(omega, omega_ts, accl, accl_ts, t0: float,
                          sigma: float = 2.0, device="cuda") -> np.ndarray:
    """World "up" as a unit vector in FRAME-0 camera coordinates.

    ``omega`` (S, 3) gyro rad/s and ``accl`` (A, 3) accelerometer m/s^2,
    both in the camera frame, with their timestamps. Each accelerometer
    sample (which at rest reads +g opposite gravity, "up" in the sensor
    frame) is rotated into frame-0 coordinates by the gyro-integrated
    orientation at its timestamp, then the samples are averaged with
    weights that discount high-dynamics readings (|a| far from g: shakes
    and impacts, where the specific force is not gravity).
    """
    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    omega, omega_ts, accl, accl_ts = map(f32, (omega, omega_ts, accl, accl_ts))
    # integrate_gyro rebases its output so the FIRST resample time is the
    # identity; prepend t0 (the first video frame's timestamp) so frame 0
    # is the reference. R[1:] then maps frame-t rays to frame-0 rays (the
    # inverse of the measured trajectory, cf. analyse_gyro's rebase).
    times = torch.cat([f32([t0]), accl_ts])
    r = integrate_gyro(omega, omega_ts, times)
    a0 = (r[1:] * accl[:, None, :]).sum(dim=-1)

    mag = torch.linalg.vector_norm(accl, dim=1)
    w = torch.exp(-(((mag - GRAVITY) / sigma) ** 2))
    g0 = (a0 * w[:, None]).sum(dim=0) / torch.clamp(w.sum(), min=1e-6)
    n = torch.linalg.vector_norm(g0)
    up = torch.where(n > 1e-6, g0 / n, f32(DEFAULT_UP))
    return up.cpu().numpy().astype(np.float64)


def level_horizon(virtual: torch.Tensor, up0: torch.Tensor) -> torch.Tensor:
    """Roll-lock a virtual-camera trajectory against gravity.

    ``virtual`` (T, 3, 3) maps frame-0 rays to virtual-camera rays (the
    smoothed trajectory; identity rows for ``--stabilise fixed``). Each
    orientation is post-rolled about its optical axis so the world up
    vector projects onto the image's up direction (-y): the horizon stays
    level whatever roll drift is left. Degenerate poses (optical axis
    within about 0 of vertical, where "horizon" is undefined) keep their
    roll.
    """
    up0 = torch.as_tensor(up0, dtype=virtual.dtype, device=virtual.device)
    u = (virtual * up0).sum(dim=-1)
    # Roll angle of world-up away from image-up, about +z.
    theta = torch.atan2(u[:, 0], -u[:, 1])
    r = torch.hypot(u[:, 0], u[:, 1])
    theta = torch.where(r > 1e-6, theta, 0.0)
    c, s = torch.cos(-theta), torch.sin(-theta)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    rz = torch.stack([
        torch.stack([c, -s, z], dim=-1),
        torch.stack([s, c, z], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ], dim=-2)
    return so3.matmul(rz, virtual)
