"""Synthetic ground-truth video: a rotating fisheye camera in a static world.

Port of ``video_annotator_tpu/io/synthetic.py``: frames are renders of a
procedural spherical texture through the fisheye camera at a known
rotation trajectory (same URI, same trajectory, same texture). Frames
render on the device the source is opened for and are handed out as host
numpy planes through pinned memory, standing in for a decoder's output.

URI form: ``synthetic://shaky?w=640&h=480&n=120&fps=30&seed=0&shake=0.004``
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Iterator, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from video_annotator_tpu_torch import so3
from video_annotator_tpu_torch.camera import Camera, CameraPreset, get_preset_camera
from video_annotator_tpu_torch.io.gpmf import DEFAULT_AXIS_MAP, build_gpmf_payload
from video_annotator_tpu_torch.io.mp4 import write_gpmf_mp4
from video_annotator_tpu_torch.io.video import VideoMeta
from video_annotator_tpu_torch.smoothing.horizon import GRAVITY


def _lon_lat(d: torch.Tensor):
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.atan2(x, z), torch.atan2(y, torch.sqrt(x * x + z * z) + 1e-9)


def _world_luma(d: torch.Tensor) -> torch.Tensor:
    lon, lat = _lon_lat(d)
    v = (0.35 * torch.sin(lon * 21.0) * torch.sin(lat * 23.0)
         + 0.25 * torch.sin(lon * 57.0 + 1.3) * torch.cos(lat * 49.0)
         + 0.2 * torch.sin(lon * 9.0 - lat * 11.0)
         + 0.2 * torch.sin(torch.sin(lon * 33.0) * 5.0 + lat * 77.0))
    return torch.clamp(v * 0.5 + 0.5, 0.0, 1.0) * 205.0 + 25.0


def _world_chroma(d: torch.Tensor):
    lon, lat = _lon_lat(d)
    return 128.0 + 40.0 * torch.sin(lon * 3.0), 128.0 + 40.0 * torch.sin(lat * 5.0)


def render_frame(camera: Camera, rotation: torch.Tensor):
    """(y, u, v) uint8 planes seen by ``camera`` rotated by ``rotation``,
    on ``rotation``'s device."""
    dev = rotation.device

    def dirs(cam: Camera, h: int, w: int):
        ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
        xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
        rays = cam.unproject(torch.stack([xs, ys], dim=-1))
        rays = rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)
        r = rotation
        return torch.stack([r[i, 0] * rays[..., 0] + r[i, 1] * rays[..., 1]
                            + r[i, 2] * rays[..., 2] for i in range(3)], dim=-1)

    h, w = camera.height, camera.width
    f32 = np.float32
    half = Camera(
        fx=float(f32(camera.fx) * f32(0.5)), fy=float(f32(camera.fy) * f32(0.5)),
        cx=float((f32(camera.cx) + f32(0.5)) * f32(0.5) - f32(0.5)),
        cy=float((f32(camera.cy) + f32(0.5)) * f32(0.5) - f32(0.5)),
        dist=camera.dist, width=w // 2, height=h // 2, model=camera.model,
    )
    y = _world_luma(dirs(camera, h, w))
    u, v = _world_chroma(dirs(half, h // 2, w // 2))

    def to8(a):
        return torch.clamp(a, 0.0, 255.0).to(torch.uint8)

    return to8(y), to8(u), to8(v)


@dataclasses.dataclass
class SyntheticCamera:
    """Config + ground-truth trajectory for synthetic footage."""

    width: int = 640
    height: int = 480
    num_frames: int = 120
    fps: Fraction = Fraction(30, 1)
    seed: int = 0
    shake: float = 0.004  # rad rms per-frame jitter
    pan: float = 0.002  # rad/frame smooth pan rate
    preset: CameraPreset = CameraPreset.GOPRO_H4B_WIDE43_MEASURED

    def camera(self) -> Camera:
        return get_preset_camera(self.preset, (self.width, self.height))

    def rotation_vectors(self) -> np.ndarray:
        """(T, 3) ground-truth rotation vectors (smooth pan + jitter)."""
        t = np.arange(self.num_frames)
        smooth = np.stack([
            self.pan * t,
            0.5 * self.pan * np.sin(t / 37.0) * 37.0 * 0.05,
            0.02 * np.sin(t / 53.0),
        ], axis=-1)
        rng = np.random.default_rng(self.seed)
        noise = rng.normal(size=(self.num_frames + 4, 3)) * self.shake
        kernel = np.array([0.25, 0.5, 0.25])
        jitter = np.stack(
            [np.convolve(noise[:, i], kernel, mode="same") for i in range(3)],
            axis=-1,
        )[2:-2] * 3.0
        return (smooth + jitter).astype(np.float32)

    def rotations(self) -> np.ndarray:
        return so3.exp(torch.from_numpy(self.rotation_vectors())).numpy()


GYRO_HZ = 400
ACCL_HZ = 200


def _attitude_at(rotvecs: np.ndarray, frame_pos: np.ndarray) -> torch.Tensor:
    """Camera attitude relative to frame 0 at fractional frame positions:
    a Catmull-Rom curve through the ground-truth rotation vectors (held
    beyond the last frame), so it is smooth and passes through the truth
    at whole frames. Float64 (S, 3, 3)."""
    n = len(rotvecs)
    i = np.clip(np.floor(frame_pos).astype(np.int64), 0, n - 1)
    u = (frame_pos - i)[:, None]
    p0, p1, p2, p3 = (rotvecs[np.clip(i + k, 0, n - 1)].astype(np.float64)
                      for k in (-1, 0, 1, 2))
    v = 0.5 * (2 * p1 + (p2 - p0) * u + (2 * p0 - 5 * p1 + 4 * p2 - p3) * u ** 2
               + (3 * p1 - p0 - 3 * p2 + p3) * u ** 3)
    r = so3.exp(torch.from_numpy(v))
    return so3.matmul(so3.transpose(r[:1]), r)


def telemetry_payloads(config: SyntheticCamera, up0=(0.0, -1.0, 0.0)) -> list:
    """GPMF payloads, one per second of ``config``'s clip, that a GoPro
    riding the synthetic camera would have logged: GYRO at 400 Hz (the
    body rates that carry each sample's attitude to the next) and ACCL at
    200 Hz (gravity's reaction along world-up ``up0``, given in frame-0
    camera coordinates, rolled with the camera). Integrating the gyro
    stream reproduces the ground-truth trajectory at the frame times."""
    fps = float(config.fps)
    seconds = config.num_frames / fps
    rotvecs = config.rotation_vectors()

    def sensor_order(cam: np.ndarray) -> np.ndarray:
        """Camera-frame vectors in the sensor's axis order (the inverse of
        ``gyro_to_camera``)."""
        raw = np.empty_like(cam)
        for i, (src, sign) in enumerate(DEFAULT_AXIS_MAP):
            raw[:, src] = cam[:, i] * sign
        return raw

    n_gyro = int(np.floor(seconds * GYRO_HZ + 1e-9))
    att = _attitude_at(rotvecs, np.arange(n_gyro + 1) / GYRO_HZ * fps)
    omega = so3.log(so3.matmul(so3.transpose(att[:-1]), att[1:])).numpy() * GYRO_HZ
    n_accl = int(np.floor(seconds * ACCL_HZ + 1e-9))
    att_a = _attitude_at(rotvecs, np.arange(n_accl) / ACCL_HZ * fps)
    up = torch.as_tensor(np.asarray(up0, np.float64))
    accl = (so3.transpose(att_a) * up).sum(dim=-1).numpy() * GRAVITY
    gyro_raw, accl_raw = sensor_order(omega), sensor_order(accl)
    return [build_gpmf_payload(gyro_raw[s * GYRO_HZ:(s + 1) * GYRO_HZ],
                               accl=accl_raw[s * ACCL_HZ:(s + 1) * ACCL_HZ])
            for s in range(-(-n_gyro // GYRO_HZ))]


def write_telemetry_mp4(path: str, config: SyntheticCamera,
                        up0=(0.0, -1.0, 0.0)) -> None:
    """A telemetry-only MP4 (no video track) of ``config``'s clip: one GPMF
    sample per second from :func:`telemetry_payloads`."""
    write_gpmf_mp4(path, telemetry_payloads(config, up0), timescale=1000, delta=1000)


def render_chessboard(camera: Camera, poses, cols: int = 9, rows: int = 6) -> list:
    """(H, W) uint8 views of a chessboard with unit squares through
    ``camera``, one per ``(R, t)`` pose (board to camera): calibration
    footage with known intrinsics. Inner corners sit at integer board
    coordinates (0..cols-1, 0..rows-1); the squares extend one beyond on
    every side, over a white backing (the light border
    ``findChessboardCorners`` needs), on a grey ground; polygons are
    filled at 1/16 px with antialiasing, then blurred by a 3x3 Gaussian
    of sigma 0.8."""
    import cv2

    def project(pts_board, R, t):
        p3 = np.concatenate([pts_board, np.zeros((len(pts_board), 1))], 1)
        uv = camera.project(torch.from_numpy((p3 @ R.T + t).astype(np.float32))).numpy()
        return np.round(uv * 16).astype(np.int32)  # shift=4 subpixel coordinates

    frames = []
    for R, t in poses:
        img = np.full((camera.height, camera.width), 160, np.uint8)
        backing = np.array([[-2.0, -2.0], [cols + 1.0, -2.0], [cols + 1.0, rows + 1.0],
                            [-2.0, rows + 1.0]])
        cv2.fillConvexPoly(img, project(backing, R, t), 255, cv2.LINE_AA, shift=4)
        for i in range(-1, cols):
            for j in range(-1, rows):
                if (i + j) % 2:
                    quad = np.array([[i, j], [i + 1, j], [i + 1, j + 1], [i, j + 1]],
                                    np.float64)
                    cv2.fillConvexPoly(img, project(quad, R, t), 10, cv2.LINE_AA, shift=4)
        frames.append(cv2.GaussianBlur(img, (3, 3), 0.8))
    return frames


class SyntheticSource:
    """Reader-compatible synthetic stream rendering on ``device``."""

    def __init__(self, config: SyntheticCamera, device="cpu"):
        self.config = config
        self.device = torch.device(device)
        self.meta = VideoMeta(config.width, config.height, config.fps,
                              config.num_frames)
        self.start_frame = 0

    @staticmethod
    def from_uri(uri: str, device="cpu") -> "SyntheticSource":
        q = {k: v[-1] for k, v in parse_qs(urlparse(uri).query).items()}
        cfg = SyntheticCamera(
            width=int(q.get("w", 640)), height=int(q.get("h", 480)),
            num_frames=int(q.get("n", 120)),
            fps=Fraction(int(q.get("fps", 30)), 1),
            seed=int(q.get("seed", 0)), shake=float(q.get("shake", 0.004)),
            pan=float(q.get("pan", 0.002)),
        )
        return SyntheticSource(cfg, device=device)

    def _to_host(self, plane: torch.Tensor) -> np.ndarray:
        if plane.device.type == "cpu":
            return plane.numpy()
        host = torch.empty(plane.shape, dtype=plane.dtype, pin_memory=True)
        host.copy_(plane)
        return host.numpy()

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        cam = self.config.camera()
        rots = torch.from_numpy(self.config.rotations()).to(self.device)
        for t in range(self.config.num_frames):
            yield tuple(self._to_host(p) for p in render_frame(cam, rots[t]))

    def close(self):
        pass
