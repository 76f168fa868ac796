"""Camera models: rectilinear pinhole and equidistant fisheye.

Port of ``video_annotator_tpu/camera.py``. A :class:`Camera` is a frozen
dataclass of plain Python numbers (intrinsics rounded to float32, as the
JAX package stores them), so it can be hashed, compared, and handed to a
CUDA kernel as scalar arguments. Projection runs on float32 tensors on
any device.

Only the RECTILINEAR and FISHEYE models project and unproject here; the
panoramic output models keep their enum values (so option parsing and
trajectory files stay compatible) but raise ``NotImplementedError`` until
the projection-modes item of ROADMAP.md lands.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Tuple

import numpy as np
import torch


class CameraModel(enum.Enum):
    RECTILINEAR = "rectilinear"
    FISHEYE = "fisheye"
    EQUIRECT = "equirect"
    STEREOGRAPHIC = "stereographic"
    MERCATOR = "mercator"
    BALL = "ball"
    HAMMER = "hammer"
    SINUSOIDAL = "sinusoidal"
    CYLINDRICAL = "cylindrical"
    PANNINI = "pannini"


_LONLAT_MODELS = frozenset({
    CameraModel.EQUIRECT, CameraModel.MERCATOR, CameraModel.SINUSOIDAL,
    CameraModel.CYLINDRICAL, CameraModel.HAMMER, CameraModel.PANNINI,
})
_PORTED_MODELS = frozenset({CameraModel.RECTILINEAR, CameraModel.FISHEYE})


class CameraPreset(enum.Enum):
    """GoPro Hero 4 Black presets."""

    GOPRO_H4B_WIDE43_PUBLISHED = "gopro_h4b_wide43_published"
    GOPRO_H4B_WIDE43_MEASURED = "gopro_h4b_wide43_measured"
    GOPRO_H4B_WIDE43_MEASURED_STABILISATION = "gopro_h4b_wide43_measured_stabilisation"
    GOPRO_H4B_WIDE169_PUBLISHED = "gopro_h4b_wide169_published"
    GOPRO_H4B_WIDE169_MEASURED = "gopro_h4b_wide169_measured"
    GOPRO_H4B_WIDE169_MEASURED_STABILISATION = "gopro_h4b_wide169_measured_stabilisation"


# Published GoPro FOVs in degrees, truncated to int like the reference.
_GOPRO_FOV_H_43W = int(122.6)
_GOPRO_FOV_V_43W = int(94.4)
_GOPRO_FOV_H_169W = int(118.2)
_GOPRO_FOV_V_169W = int(69.5)


def _f32(x) -> float:
    return float(np.float32(x))


def _not_ported(model: CameraModel):
    return NotImplementedError(
        f"camera model {model.value!r} is not ported to the torch package yet "
        "(ROADMAP.md, modules still to port: interp/projection/prefilter modes)"
    )


@dataclasses.dataclass(frozen=True)
class Camera:
    """Intrinsics + lens model + sensor size; ``dist`` is k1..k4."""

    fx: float
    fy: float
    cx: float
    cy: float
    dist: Tuple[float, float, float, float]
    width: int
    height: int
    model: CameraModel

    @staticmethod
    def make(fx, fy, cx, cy, width: int, height: int, model: CameraModel,
             dist=None) -> "Camera":
        dist = (0.0, 0.0, 0.0, 0.0) if dist is None else dist
        return Camera(
            fx=_f32(fx), fy=_f32(fy), cx=_f32(cx), cy=_f32(cy),
            dist=tuple(_f32(k) for k in np.asarray(dist).reshape(4)),
            width=int(width), height=int(height), model=CameraModel(model),
        )

    def project(self, rays: torch.Tensor) -> torch.Tensor:
        """(..., 3) camera-frame rays -> (..., 2) pixel coordinates."""
        if self.model not in _PORTED_MODELS:
            raise _not_ported(self.model)
        x, y, z = rays[..., 0], rays[..., 1], rays[..., 2]
        inv_z = 1.0 / z
        a = x * inv_z
        b = y * inv_z
        if self.model == CameraModel.RECTILINEAR:
            return torch.stack([self.fx * a + self.cx, self.fy * b + self.cy],
                               dim=-1)
        r = torch.sqrt(a * a + b * b)
        theta_d = _distort_theta(torch.atan(r), self.dist)
        scale = torch.where(r > 1e-8, theta_d / torch.clamp(r, min=1e-8), 1.0)
        u = self.fx * a * scale + self.cx
        v = self.fy * b * scale + self.cy
        return torch.stack([u, v], dim=-1)

    def unproject(self, pixels: torch.Tensor) -> torch.Tensor:
        """(..., 2) pixels -> (..., 3) rays with z == 1."""
        if self.model not in _PORTED_MODELS:
            raise _not_ported(self.model)
        xd = (pixels[..., 0] - self.cx) / self.fx
        yd = (pixels[..., 1] - self.cy) / self.fy
        one = torch.ones_like(xd)
        if self.model == CameraModel.RECTILINEAR:
            return torch.stack([xd, yd, one], dim=-1)
        theta_d = torch.sqrt(xd * xd + yd * yd)
        r = torch.tan(_undistort_theta(theta_d, self.dist))
        scale = torch.where(theta_d > 1e-8,
                            r / torch.clamp(theta_d, min=1e-8), 1.0)
        return torch.stack([xd * scale, yd * scale, one], dim=-1)

    def unproject_unit(self, pixels: torch.Tensor) -> torch.Tensor:
        rays = self.unproject(pixels)
        return rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)


def _distort_theta(theta, dist):
    k1, k2, k3, k4 = dist
    t2 = theta * theta
    return theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))


def _undistort_theta(theta_d, dist):
    """Fixed-point inverse of :func:`_distort_theta` (10 steps, like
    ``cv2.fisheye.undistortPoints``)."""
    k1, k2, k3, k4 = dist
    theta = theta_d
    for _ in range(10):
        t2 = theta * theta
        theta = theta_d / (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    return theta


def camera_to_numpy(cam: Camera) -> dict:
    """The camera's fields as numpy leaves, named like the JAX ``Camera``'s
    (``fx``/``fy``/``cx``/``cy`` float32 scalars, ``dist`` (4,) float32,
    ``width``/``height`` ints, ``model`` the enum's string value)."""
    return {
        "fx": np.float32(cam.fx), "fy": np.float32(cam.fy),
        "cx": np.float32(cam.cx), "cy": np.float32(cam.cy),
        "dist": np.asarray(cam.dist, np.float32),
        "width": int(cam.width), "height": int(cam.height),
        "model": cam.model.value,
    }


def camera_from_numpy(leaves: dict) -> Camera:
    """Inverse of :func:`camera_to_numpy`; ``model`` may be a string or any
    enum whose ``value`` is one (a JAX ``CameraModel`` works)."""
    model = leaves["model"]
    model = CameraModel(getattr(model, "value", model))
    return Camera.make(
        float(np.asarray(leaves["fx"])), float(np.asarray(leaves["fy"])),
        float(np.asarray(leaves["cx"])), float(np.asarray(leaves["cy"])),
        int(leaves["width"]), int(leaves["height"]), model,
        dist=np.asarray(leaves["dist"], np.float32),
    )


def get_preset_camera(preset: CameraPreset, size: Tuple[int, int]) -> Camera:
    """GoPro preset intrinsics scaled to ``size = (width, height)``."""
    w, h = size
    cx = (w - 1.0) / 2.0
    cy = (h - 1.0) / 2.0
    if preset == CameraPreset.GOPRO_H4B_WIDE43_PUBLISHED:
        fx = w / math.radians(_GOPRO_FOV_H_43W)
        fy = h / math.radians(_GOPRO_FOV_V_43W)
    elif preset == CameraPreset.GOPRO_H4B_WIDE169_PUBLISHED:
        fx = w / math.radians(_GOPRO_FOV_H_169W)
        fy = h / math.radians(_GOPRO_FOV_V_169W)
    elif preset == CameraPreset.GOPRO_H4B_WIDE43_MEASURED:
        cx = 967.37 * w / 1920
        cy = 711.07 * h / 1440
        fx = 942.96 * h / 1440
        fy = 942.53 * h / 1440
    elif preset == CameraPreset.GOPRO_H4B_WIDE43_MEASURED_STABILISATION:
        cx = 965.90 * w / 1920
        cy = 712.94 * h / 1440
        fx = 1045.58 * h / 1440
        fy = 1045.64 * h / 1440
    elif preset == CameraPreset.GOPRO_H4B_WIDE169_MEASURED:
        cx = 1361.80 * w / 2704
        cy = 745.19 * h / 1520
        fx = 1392.49 * h / 1520
        fy = 1383.47 * h / 1520
    elif preset == CameraPreset.GOPRO_H4B_WIDE169_MEASURED_STABILISATION:
        cx = 1357.49 * w / 2704
        cy = 736.74 * h / 1520
        fx = 1626.67 * h / 1520
        fy = 1619.46 * h / 1520
    else:
        raise ValueError(f"unknown preset {preset}")
    return Camera.make(fx, fy, cx, cy, w, h, CameraModel.FISHEYE)


def camera_from_dfov(dfov_degrees: float, size: Tuple[int, int],
                     model: CameraModel) -> Camera:
    """Camera from a diagonal field of view (same focal rules per model as
    the JAX package)."""
    w, h = size
    half_diag = math.hypot(w - 1.0, h - 1.0) / 2.0
    half_fov = math.radians(dfov_degrees) / 2.0
    if model in (CameraModel.PANNINI, CameraModel.STEREOGRAPHIC):
        hf = min(half_fov, math.radians(330.0) / 2.0)
        f = half_diag / (2.0 * math.tan(hf / 2.0))
    elif model == CameraModel.BALL:
        f = half_diag / math.sin(min(half_fov, math.pi) / 2.0)
    elif model == CameraModel.HAMMER:
        hf = min(half_fov, math.pi)
        r = (2.0 * math.sqrt(2.0) * math.sin(hf / 2.0)
             / math.sqrt(1.0 + math.cos(hf / 2.0)))
        f = half_diag / r
    elif model == CameraModel.FISHEYE or model in _LONLAT_MODELS:
        f = half_diag / half_fov
    else:
        f = half_diag / math.tan(half_fov)
    return Camera.make(f, f, (w - 1.0) / 2.0, (h - 1.0) / 2.0, w, h, model)


def get_output_camera(input_camera: Camera, scale: float = 1.0,
                      crop_borders: bool = False, zoom: float = 1.0) -> Camera:
    """Rectilinear output camera fitted around the undistorted input frame:
    unproject the corners and edge midpoints (float32, like the JAX
    package), bound them (corners dropped when ``crop_borders``), match the
    diagonal, then apply ``scale`` and ``zoom``."""
    w, h = input_camera.width, input_camera.height
    cx, cy = input_camera.cx, input_camera.cy
    points = torch.tensor(
        [[0.0, 0.0], [0.0, h - 1.0], [w - 1.0, 0.0], [w - 1.0, h - 1.0],
         [cx, 0.0], [w - 1.0, cy], [cx, h - 1.0], [0.0, cy]],
        dtype=torch.float32,
    )
    extreme = input_camera.unproject(points)[:, :2].numpy()
    start = 4 if crop_borders else 0
    max_x = float(extreme[start:, 0].max())
    min_x = float(extreme[start:, 0].min())
    max_y = float(extreme[start:, 1].max())
    min_y = float(extreme[start:, 1].min())
    input_diag = math.hypot(w - 1.0, h - 1.0)
    output_diag = math.hypot(float(extreme[3, 0] - extreme[0, 0]),
                             float(extreme[3, 1] - extreme[0, 1]))
    scale = scale * input_diag / output_diag
    return Camera.make(
        fx=scale, fy=scale,
        cx=scale * -min_x / zoom, cy=scale * -min_y / zoom,
        width=int(scale * (max_x - min_x) / zoom),
        height=int(scale * (max_y - min_y) / zoom),
        model=CameraModel.RECTILINEAR,
    )
