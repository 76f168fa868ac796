"""Cameras of the benchmark's clips and of its reference warp.

A frozen copy of the fisheye and rectilinear parts of
``video_annotator_tpu_torch/camera.py`` at commit be9ce58 (``Camera``,
``get_preset_camera`` for the two GoPro HERO4 Black presets the
configurations name, ``get_output_camera``) and of
``ops/warp_plain.py::scaled_camera``: the intrinsics rounded to float32,
the equidistant fisheye with the ten-step fixed-point undistortion, and
the output camera fitted around the undistorted frame. Plain torch and
numpy; the benchmark keeps it so that neither the clip nor the reference
depends on the program under test.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

FISHEYE = "fisheye"
RECTILINEAR = "rectilinear"


def _f32(x) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    model: str
    dist: tuple = (0.0, 0.0, 0.0, 0.0)

    @staticmethod
    def make(fx, fy, cx, cy, width, height, model, dist=(0.0, 0.0, 0.0, 0.0)) -> "Camera":
        return Camera(_f32(fx), _f32(fy), _f32(cx), _f32(cy), int(width), int(height), model,
                      tuple(_f32(k) for k in dist))

    def project(self, rays: torch.Tensor) -> torch.Tensor:
        """(..., 3) camera-frame rays -> (..., 2) pixel coordinates."""
        x, y, z = rays[..., 0], rays[..., 1], rays[..., 2]
        inv_z = 1.0 / z
        a = x * inv_z
        b = y * inv_z
        if self.model == RECTILINEAR:
            return torch.stack([self.fx * a + self.cx, self.fy * b + self.cy], dim=-1)
        r = torch.sqrt(a * a + b * b)
        theta_d = _distort_theta(torch.atan(r), self.dist)
        scale = torch.where(r > 1e-8, theta_d / torch.clamp(r, min=1e-8), 1.0)
        return torch.stack([self.fx * a * scale + self.cx, self.fy * b * scale + self.cy],
                           dim=-1)

    def unproject(self, pixels: torch.Tensor) -> torch.Tensor:
        """(..., 2) pixels -> (..., 3) rays with z = 1."""
        xd = (pixels[..., 0] - self.cx) / self.fx
        yd = (pixels[..., 1] - self.cy) / self.fy
        one = torch.ones_like(xd)
        if self.model == RECTILINEAR:
            return torch.stack([xd, yd, one], dim=-1)
        theta_d = torch.sqrt(xd * xd + yd * yd)
        theta = _undistort_theta(theta_d, self.dist)
        r = torch.tan(theta)
        scale = torch.where(theta_d > 1e-8, r / torch.clamp(theta_d, min=1e-8), 1.0)
        return torch.stack([xd * scale, yd * scale, one], dim=-1)


def _distort_theta(theta, dist):
    k1, k2, k3, k4 = dist
    t2 = theta * theta
    return theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))


def _undistort_theta(theta_d, dist):
    k1, k2, k3, k4 = dist
    theta = theta_d
    for _ in range(10):
        t2 = theta * theta
        theta = theta_d / (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    return theta


# The measured intrinsics of the two HERO4 Black modes, at their calibration
# sizes: (cx, cy, fx, fy, calibration width, calibration height).
PRESETS = {
    "gopro_h4b_wide43_measured": (967.37, 711.07, 942.96, 942.53, 1920, 1440),
    "gopro_h4b_wide169_measured": (1361.80, 745.19, 1392.49, 1383.47, 2704, 1520),
}


def preset_camera(preset: str, width: int, height: int) -> Camera:
    """The preset's intrinsics scaled to ``width`` x ``height``: the centre
    by the width and height, both focal lengths by the height."""
    cx, cy, fx, fy, cw, ch = PRESETS[preset]
    return Camera.make(fx * height / ch, fy * height / ch, cx * width / cw, cy * height / ch,
                       width, height, FISHEYE)


def output_camera(in_cam: Camera, scale: float = 1.0, zoom: float = 1.0) -> Camera:
    """The rectilinear camera fitted around the undistorted input frame
    (corners and edge midpoints unprojected in float32), matched on the
    diagonal, then scaled and zoomed."""
    w, h = in_cam.width, in_cam.height
    cx, cy = in_cam.cx, in_cam.cy
    points = torch.tensor([[0.0, 0.0], [0.0, h - 1.0], [w - 1.0, 0.0], [w - 1.0, h - 1.0],
                           [cx, 0.0], [w - 1.0, cy], [cx, h - 1.0], [0.0, cy]],
                          dtype=torch.float32)
    extreme = in_cam.unproject(points)[:, :2].numpy()
    max_x, min_x = float(extreme[:, 0].max()), float(extreme[:, 0].min())
    max_y, min_y = float(extreme[:, 1].max()), float(extreme[:, 1].min())
    input_diag = math.hypot(w - 1.0, h - 1.0)
    output_diag = math.hypot(float(extreme[3, 0] - extreme[0, 0]),
                             float(extreme[3, 1] - extreme[0, 1]))
    s = scale * input_diag / output_diag
    return Camera.make(s, s, s * -min_x / zoom, s * -min_y / zoom,
                       int(s * (max_x - min_x) / zoom), int(s * (max_y - min_y) / zoom),
                       RECTILINEAR)


def half_camera(cam: Camera) -> Camera:
    """The camera of a 4:2:0 chroma plane: f' = f / 2, c' = (c + 0.5) / 2 -
    0.5, in float32."""
    f32, s = np.float32, np.float32(0.5)
    return Camera(float(f32(cam.fx) * s), float(f32(cam.fy) * s),
                  float((f32(cam.cx) + f32(0.5)) * s - f32(0.5)),
                  float((f32(cam.cy) + f32(0.5)) * s - f32(0.5)),
                  int(round(cam.width * 0.5)), int(round(cam.height * 0.5)), cam.model, cam.dist)
