"""Camera models: rectilinear pinhole, equidistant fisheye and the v360
panoramic output family.

Port of ``video_annotator_tpu/camera.py``. A :class:`Camera` is a frozen
dataclass of plain Python numbers (intrinsics rounded to float32, as the
JAX package stores them), so it can be hashed, compared, and handed to a
CUDA kernel as scalar arguments. Projection runs on float32 or float64
tensors on any device, in the dtype of its input.

The rectilinear and fisheye models unproject to z = 1 rays. The lon/lat
models (equirect, mercator, sinusoidal, cylindrical, hammer, pannini) and
the radial full-sphere ones (stereographic, ball) unproject to direction
vectors; a pixel outside a model's valid region unprojects to
(0, 0, -1), which the warp's behind-camera mask renders as border.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple

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
# Pannini distance parameter: d = 1, the chart r = 2 tan(theta / 2) on the
# equator.
_PANNINI_D = 1.0


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
        x, y, z = rays[..., 0], rays[..., 1], rays[..., 2]
        if self.model in _LONLAT_MODELS:
            # lon/lat with lat positive downward (image y grows down)
            lon = torch.atan2(x, z)
            lat = torch.atan2(y, torch.sqrt(x * x + z * z))
            mx, my = _lonlat_chart(self.model, lon, lat)
            return torch.stack([self.fx * mx + self.cx, self.fy * my + self.cy], dim=-1)
        if self.model in (CameraModel.STEREOGRAPHIC, CameraModel.BALL):
            rho = torch.sqrt(x * x + y * y)
            theta = torch.atan2(rho, z)
            if self.model == CameraModel.STEREOGRAPHIC:
                r = 2.0 * torch.tan(torch.clamp(theta, max=3.1) / 2.0)
            else:
                r = torch.sin(theta / 2.0)
            scale = torch.where(rho > 1e-8, r / torch.clamp(rho, min=1e-8), 0.0)
            return torch.stack([self.fx * x * scale + self.cx,
                                self.fy * y * scale + self.cy], dim=-1)
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

    def unproject(self, pixels: torch.Tensor,
                  max_theta: Optional[float] = None) -> torch.Tensor:
        """(..., 2) pixels -> (..., 3) rays: z == 1 for the rectilinear and
        fisheye models, unit directions for the panoramic ones.
        ``max_theta`` clips a fisheye's angle from the axis before its
        ``tan`` (the JAX planner's ``unproject_np`` rule)."""
        xd = (pixels[..., 0] - self.cx) / self.fx
        yd = (pixels[..., 1] - self.cy) / self.fy
        if self.model in _LONLAT_MODELS:
            lon, lat, bad = _lonlat_inverse(self.model, xd, yd)
            cl = torch.cos(lat)
            dirs = torch.stack([cl * torch.sin(lon), torch.sin(lat), cl * torch.cos(lon)],
                               dim=-1)
            return _backward_where(bad, dirs)
        if self.model in (CameraModel.STEREOGRAPHIC, CameraModel.BALL):
            rd = torch.sqrt(xd * xd + yd * yd)
            if self.model == CameraModel.STEREOGRAPHIC:
                theta = 2.0 * torch.atan(rd / 2.0)
                bad = torch.zeros_like(xd, dtype=torch.bool)
            else:  # r = sin(theta / 2) covers the sphere at r == 1
                theta = 2.0 * torch.asin(torch.clamp(rd, max=1.0))
                bad = rd > 1.0
            scale = torch.where(rd > 1e-8, torch.sin(theta) / torch.clamp(rd, min=1e-8), 0.0)
            dirs = torch.stack([xd * scale, yd * scale, torch.cos(theta)], dim=-1)
            return _backward_where(bad, dirs)
        one = torch.ones_like(xd)
        if self.model == CameraModel.RECTILINEAR:
            return torch.stack([xd, yd, one], dim=-1)
        theta_d = torch.sqrt(xd * xd + yd * yd)
        theta = _undistort_theta(theta_d, self.dist)
        if max_theta is not None:
            theta = torch.clamp(theta, 0.0, max_theta)
        r = torch.tan(theta)
        scale = torch.where(theta_d > 1e-8,
                            r / torch.clamp(theta_d, min=1e-8), 1.0)
        return torch.stack([xd * scale, yd * scale, one], dim=-1)

    def unproject_unit(self, pixels: torch.Tensor) -> torch.Tensor:
        rays = self.unproject(pixels)
        return rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)


def _lonlat_chart(model: CameraModel, lon, lat):
    """(mx, my) chart coordinates of a lon/lat model."""
    if model == CameraModel.EQUIRECT:
        return lon, lat
    if model == CameraModel.MERCATOR:
        # Gudermannian; poles clamped so projected points stay finite
        return lon, torch.asinh(torch.tan(torch.clamp(lat, -1.55, 1.55)))
    if model == CameraModel.SINUSOIDAL:
        return lon * torch.cos(lat), lat
    if model == CameraModel.CYLINDRICAL:
        return lon, torch.tan(torch.clamp(lat, -1.55, 1.55))
    if model == CameraModel.PANNINI:
        d = _PANNINI_D
        s = (d + 1.0) / (d + torch.clamp(torch.cos(lon), min=-0.999))
        return s * torch.sin(lon), s * torch.tan(torch.clamp(lat, -1.55, 1.55))
    # HAMMER
    d = torch.sqrt(1.0 + torch.cos(lat) * torch.cos(lon / 2.0))
    mx = 2.0 * math.sqrt(2.0) * torch.cos(lat) * torch.sin(lon / 2.0) / d
    return mx, math.sqrt(2.0) * torch.sin(lat) / d


def _lonlat_inverse(model: CameraModel, xd, yd):
    """(lon, lat, outside the model's valid region) of chart coordinates."""
    none = torch.zeros_like(xd, dtype=torch.bool)
    if model == CameraModel.EQUIRECT:
        return xd, yd, none
    if model == CameraModel.MERCATOR:
        return xd, torch.atan(torch.sinh(yd)), none
    if model == CameraModel.SINUSOIDAL:
        lat = torch.clamp(yd, -math.pi / 2, math.pi / 2)
        lon = xd / torch.clamp(torch.cos(lat), min=1e-8)
        return lon, lat, (torch.abs(yd) > math.pi / 2) | (torch.abs(lon) > math.pi)
    if model == CameraModel.CYLINDRICAL:
        return xd, torch.atan(yd), none
    if model == CameraModel.PANNINI:
        # x = (d + 1) sin(lon) / (d + cos(lon)) is quadratic in cos(lon)
        d = _PANNINI_D
        k = xd * xd / ((d + 1.0) * (d + 1.0))
        disc = torch.sqrt(torch.clamp(k * k * d * d - (k + 1.0) * (k * d * d - 1.0),
                                      min=0.0))
        cl = (-k * d + disc) / (k + 1.0)
        sl = xd * (d + cl) / (d + 1.0)
        return torch.atan2(sl, cl), torch.atan(yd * (d + cl) / (d + 1.0)), none
    # HAMMER: inverse Hammer-Aitoff, outside the full-sphere ellipse is bad
    z2 = 1.0 - 0.0625 * xd * xd - 0.25 * yd * yd
    zz = torch.sqrt(torch.clamp(z2, min=0.5))
    lon = 2.0 * torch.atan2(zz * xd / 2.0, 2.0 * z2 - 1.0)
    lat = torch.asin(torch.clamp(zz * yd, -1.0, 1.0))
    return lon, lat, z2 < 0.5


def _backward_where(bad, dirs):
    """``dirs`` with the pixels ``bad`` pointing backward, (0, 0, -1)."""
    backward = torch.tensor([0.0, 0.0, -1.0], dtype=dirs.dtype, device=dirs.device)
    return torch.where(bad[..., None], backward, dirs)


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
