"""The plain reference that decides ``correct``.

Plain torch and numpy, importing nothing of the program under test. It
follows the semantics of the stock ``render --stabilise smooth`` path:

- the trajectory: the ground truth the clip was rendered from, R_t^T R_0
  (the camera's rotation from frame 0 to frame t), against which an
  analysed trajectory's per-frame angle is measured;
- the corrections: the trajectory's rotation vectors exponentiated in
  float32, replicate-padded by the smoothing radius, each of the nine
  matrix entries filtered by the Savitzky-Golay kernel of order 2 (float64
  sums in tap order, rounded once to float32), projected back onto SO(3)
  by an SVD, and the correction measured . virtual^T;
- the warp: for every output pixel the output camera's ray, rotated by
  the correction and projected through the fisheye input camera, sampled
  bilinearly with taps outside the frame reading the border (0 for luma,
  128 for chroma), rounded half to even to uint8.

The formulas and their order of operations are frozen copies of those in
``video_annotator_tpu_torch`` at commit be9ce58 (``so3.py``,
``smoothing/savgol.py``, ``pipeline/render.py::make_window_corrections``,
``ops/warp_plain.py``), so that a warp that rounds as the plain version
does reads equal. ``dtype`` computes the warp in another precision: the
lower-precision control that must come out not correct.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import camera as cameras

EPS = 1e-8


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rotation vectors (..., 3) -> matrices (..., 3, 3), Rodrigues."""
    theta2 = (w * w).sum(dim=-1)
    theta = torch.sqrt(theta2 + EPS * EPS)
    big = theta2 > EPS
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(theta)) / (theta2 + EPS * EPS), 0.5 - theta2 / 24.0)
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    hat = torch.stack([torch.stack([zero, -wz, wy], dim=-1),
                       torch.stack([wz, zero, -wx], dim=-1),
                       torch.stack([-wy, wx, zero], dim=-1)], dim=-2)
    outer = w[..., :, None] * w[..., None, :]
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(hat.shape)
    return eye + a[..., None, None] * hat + b[..., None, None] * (
        outer - theta2[..., None, None] * eye)


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 product as sums of elementwise products."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def nearest_rotation(m: torch.Tensor) -> torch.Tensor:
    u, _, vt = torch.linalg.svd(m)
    det = torch.linalg.det(matmul3(u, vt))
    d = torch.cat([torch.ones(m.shape[:-2] + (2,), dtype=m.dtype, device=m.device),
                   det[..., None]], dim=-1)
    return matmul3(u * d[..., None, :], vt)


def savgol_weights(radius: int, order: int = 2) -> np.ndarray:
    """The least-squares smoothing kernel over [-radius, radius], float32."""
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    a = np.stack([t ** k for k in range(order + 1)], axis=1)
    e = np.zeros(order + 1)
    e[0] = 1.0
    return (e @ np.linalg.pinv(a)).astype(np.float32)


def corrections(params: np.ndarray, radius: int) -> torch.Tensor:
    """(T, 3) float64 rotation vectors of a trajectory file -> (T, 3, 3)
    float32 corrections of ``--stabilise smooth`` with ``radius`` (cut to
    T - 1 for a shorter clip, as the program does), on the host."""
    measured = so3_exp(torch.from_numpy(np.asarray(params, np.float32)))
    t = measured.shape[0]
    r = min(radius, max(t - 1, 1))
    window = torch.cat([measured[:1].expand(r, 3, 3), measured, measured[-1:].expand(r, 3, 3)])
    x = window.reshape(-1, 9).to(torch.float64)
    w = torch.from_numpy(savgol_weights(r)).to(torch.float64)
    out = x[:t] * w[0]
    for j in range(1, w.shape[0]):
        out = out + x[j:j + t] * w[j]
    virtual = nearest_rotation(out.to(torch.float32).reshape(-1, 3, 3))
    return matmul3(measured, virtual.transpose(-1, -2))


def warp_map(out_cam: cameras.Camera, in_cam: cameras.Camera, rotation: torch.Tensor,
             size, dtype=torch.float32) -> torch.Tensor:
    """(H, W, 2) source coordinates of every output pixel; rays behind the
    input camera are pinned at -1e6."""
    h, w = size
    dev = rotation.device
    ys = torch.arange(h, dtype=dtype, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=dtype, device=dev)[None, :].expand(h, w)
    rays = out_cam.unproject(torch.stack([xs, ys], dim=-1))
    r = rotation.to(dtype)
    rx, ry, rz = rays[..., 0], rays[..., 1], rays[..., 2]
    rotated = torch.stack([r[i, 0] * rx + r[i, 1] * ry + r[i, 2] * rz for i in range(3)],
                          dim=-1)
    src = in_cam.project(rotated)
    behind = ~(rotated[..., 2] > 1e-6)[..., None]
    return torch.where(behind, torch.full_like(src, -1e6), src)


def bilinear(image: torch.Tensor, coords: torch.Tensor, border: float,
             dtype=torch.float32) -> torch.Tensor:
    """Sample (H, W) ``image`` centred on ``border`` at ``coords``; taps
    outside the image read ``border``."""
    h, w = image.shape
    flat = image.to(dtype).reshape(-1) - border
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    xi, yi = x0.to(torch.int64), y0.to(torch.int64)

    def tap(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        return torch.where(valid, flat[yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)], 0.0)

    top = tap(yi, xi) * (1.0 - fx) + tap(yi, xi + 1) * fx
    bot = tap(yi + 1, xi) * (1.0 - fx) + tap(yi + 1, xi + 1) * fx
    return top * (1.0 - fy) + bot * fy + border


def to_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.to(torch.float32)), 0.0, 255.0).to(torch.uint8)


class Warp:
    """The stock output of one configuration: the input camera of its
    preset, the rectilinear camera fitted around it and widened by the
    stabilise buffer, and their chroma halves."""

    def __init__(self, in_cam: cameras.Camera, buffer_percent: float):
        self.in_cam = in_cam
        zoom = 1.0 / (1.0 + buffer_percent / 100.0)
        self.out_cam = cameras.output_camera(in_cam, 1.0, zoom)
        self.out_h = self.out_cam.height - self.out_cam.height % 2
        self.out_w = self.out_cam.width - self.out_cam.width % 2
        self.in_half = cameras.half_camera(in_cam)
        self.out_half = cameras.half_camera(self.out_cam)

    def frame(self, y, u, v, rotation: torch.Tensor, dtype=torch.float32):
        """uint8 (y, u, v) output planes of one frame."""
        cy = warp_map(self.out_cam, self.in_cam, rotation, (self.out_h, self.out_w), dtype)
        wy = to_u8(bilinear(y, cy, 0.0, dtype))
        del cy
        cc = warp_map(self.out_half, self.in_half, rotation,
                      (self.out_h // 2, self.out_w // 2), dtype)
        return wy, to_u8(bilinear(u, cc, 128.0, dtype)), to_u8(bilinear(v, cc, 128.0, dtype))


def expected_rotations(rotvecs: np.ndarray, first: int = 0) -> np.ndarray:
    """(T, 3, 3) float64 R_t^T R_first from ground-truth rotation vectors:
    what an analysed trajectory of the clip from frame ``first`` holds."""
    r = np.stack([_exp64(w) for w in rotvecs])
    return np.einsum("tji,jk->tik", r[first:], r[first])


def angle_errors_deg(params: np.ndarray, expect: np.ndarray) -> np.ndarray:
    """Per-frame angle (deg) between the rotations of float64 rotation
    vectors ``params`` and ``expect``, in float64."""
    est = np.stack([_exp64(w) for w in np.asarray(params, np.float64)])
    rel = np.einsum("tij,tkj->tik", est, expect[:len(est)])
    cos = np.clip((np.einsum("tii->t", rel) - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(cos))


def truth_params(rotvecs: np.ndarray, dtype=torch.float64) -> np.ndarray:
    """(T, 3) float64 rotation vectors of R_t^T R_0: computed in float64 (the
    encode-only input), or in ``dtype`` throughout (the control)."""
    if dtype == torch.float64:
        return np.stack([_log64(m) for m in expected_rotations(rotvecs)])
    r = so3_exp(torch.from_numpy(np.asarray(rotvecs, np.float32)).to(dtype))
    rel = matmul3(r.transpose(-1, -2), r[:1].expand(r.shape))
    return np.stack([_log64(m) for m in rel.to(torch.float64).numpy()])


def _exp64(w) -> np.ndarray:
    w = np.asarray(w, np.float64)
    theta = float(np.linalg.norm(w))
    k = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if theta < 1e-12:
        return np.eye(3) + k
    return np.eye(3) + math.sin(theta) / theta * k + (1.0 - math.cos(theta)) / theta ** 2 * (k @ k)


def _log64(m: np.ndarray) -> np.ndarray:
    cos = min(1.0, max(-1.0, (np.trace(m) - 1.0) / 2.0))
    theta = math.acos(cos)
    v = np.array([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]])
    if theta < 1e-9:
        return 0.5 * v
    return v * (theta / (2.0 * math.sin(theta)))
