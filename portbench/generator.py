"""The benchmark's clips: a fisheye camera turning in a textured sphere.

A frozen copy of ``video_annotator_tpu_torch/io/synthetic.py`` at commit
be9ce58 (``_world_luma``, ``_world_chroma``, ``render_frame``,
``SyntheticCamera.rotation_vectors``), with the clip's size, rate, preset
and motion taken from a configuration instead of a URI. Every frame is
rendered on the device from the seed's trajectory and written once into
a YUV4MPEG2 file (4:2:0, ``C420jpeg``), the format the program's y4m
reader takes. The rotations are known, so the trajectory the program
estimates can be held to them.
"""

from __future__ import annotations

import os
from fractions import Fraction

import numpy as np
import torch

from portbench import camera as cameras


def rotation_vectors(n: int, seed: int, shake: float, pan: float) -> np.ndarray:
    """(n, 3) float32 rotation vectors R_t = exp(w_t) applied to camera rays:
    a smooth pan plus a jitter of ``shake`` rad rms, drawn from ``seed``."""
    t = np.arange(n)
    smooth = np.stack([pan * t, 0.5 * pan * np.sin(t / 37.0) * 37.0 * 0.05,
                       0.02 * np.sin(t / 53.0)], axis=-1)
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=(n + 4, 3)) * shake
    kernel = np.array([0.25, 0.5, 0.25])
    jitter = np.stack([np.convolve(noise[:, i], kernel, mode="same") for i in range(3)],
                      axis=-1)[2:-2] * 3.0
    return (smooth + jitter).astype(np.float32)


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


def _unit_rays(cam: cameras.Camera, device) -> torch.Tensor:
    h, w = cam.height, cam.width
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    rays = cam.unproject(torch.stack([xs, ys], dim=-1))
    return rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)


def _rotate(rays: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return torch.stack([r[i, 0] * rays[..., 0] + r[i, 1] * rays[..., 1]
                        + r[i, 2] * rays[..., 2] for i in range(3)], dim=-1)


def _to8(a: torch.Tensor) -> torch.Tensor:
    return torch.clamp(a, 0.0, 255.0).to(torch.uint8)


class Clip:
    """One configuration's clip for one seed: its camera, its ground-truth
    rotations and its frames."""

    def __init__(self, cfg: dict, seed: int):
        self.width, self.height = int(cfg["width"]), int(cfg["height"])
        self.fps = Fraction(int(cfg["fps_num"]), int(cfg["fps_den"]))
        self.frames = int(cfg["frames"])
        self.preset = cfg["preset"]
        motion = cfg["assumed"]["motion"]
        self.camera = cameras.preset_camera(self.preset, self.width, self.height)
        self.rotvecs = rotation_vectors(self.frames, seed, float(motion["shake_rad"]),
                                        float(motion["pan_rad_per_frame"]))

    def rotations(self) -> torch.Tensor:
        """(T, 3, 3) float32 R_t, computed on the host in float64."""
        return torch.from_numpy(np.stack([_exp64(w) for w in self.rotvecs]).astype(np.float32))

    def render(self, device, first: int = 0, count: int = None):
        """Yield (t, y, u, v) uint8 planes on ``device`` for frames
        ``first`` .. ``first + count``."""
        count = self.frames - first if count is None else count
        half = cameras.half_camera(self.camera)
        rays_y = _unit_rays(self.camera, device)
        rays_c = _unit_rays(half, device)
        rots = self.rotations().to(device)
        for t in range(first, first + count):
            y = _world_luma(_rotate(rays_y, rots[t]))
            u, v = _world_chroma(_rotate(rays_c, rots[t]))
            yield t, _to8(y), _to8(u), _to8(v)

    def write_y4m(self, path: str, device) -> int:
        """Render every frame on ``device`` and write the clip, synced to the
        disk; returns its bytes. Frames come back through one pageable
        buffer a plane set: the clip leaves no pinned block in the caching
        host allocator for the program's first job to find."""
        fps = self.fps
        header = (f"YUV4MPEG2 W{self.width} H{self.height} F{fps.numerator}:{fps.denominator}"
                  " Ip A1:1 C420jpeg\n").encode()
        ysize = self.width * self.height
        csize = (self.width // 2) * (self.height // 2)
        frame_bytes = ysize + 2 * csize
        buf = torch.empty(frame_bytes, dtype=torch.uint8)
        host = buf.numpy()
        written = len(header)
        with open(path, "wb") as f:
            f.write(header)
            for _, y, u, v in self.render(device):
                buf[:ysize].copy_(y.reshape(-1))
                buf[ysize:ysize + csize].copy_(u.reshape(-1))
                buf[ysize + csize:].copy_(v.reshape(-1))
                f.write(b"FRAME\n")
                f.write(host.data)
                written += 6 + frame_bytes
            # On the disk before the window opens: no write-back behind it.
            f.flush()
            os.fsync(f.fileno())
        return written


def _exp64(w: np.ndarray) -> np.ndarray:
    """Rodrigues' formula in float64."""
    w = np.asarray(w, np.float64)
    theta = float(np.linalg.norm(w))
    k = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if theta < 1e-12:
        return np.eye(3) + k
    return (np.eye(3) + np.sin(theta) / theta * k
            + (1.0 - np.cos(theta)) / theta ** 2 * (k @ k))
