"""Warp map + bilinear remap in plain torch: the oracle of the warp kernel.

Port of ``video_annotator_tpu/ops/warp_xla.py`` (``compute_warp_map``,
``bilinear_sample``, ``warp_image_xla``, ``_scaled_camera``) and of the
two camera/plane helpers the analyse and encode phases share
(``box_downsample``, ``mip_camera`` from ``ops/warp_pallas.py``).

For every output pixel: unproject through the output camera, rotate the
ray, project through the input camera, and sample the source with exact
2x2 bilinear taps, zero outside the frame (``cv::remap`` BORDER_CONSTANT).
Rays that end up behind the input camera are pinned far outside so they
sample the border.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from video_annotator_tpu_torch.camera import Camera

TILE_ROWS = 8  # output rows per rotation of a per-tile-row stack


def num_tile_rows(out_h: int) -> int:
    """Tile rows of an ``out_h``-row output: the length of a full stack."""
    return -(-out_h // TILE_ROWS)


def compute_warp_map(out_camera: Camera, in_camera: Camera,
                     rotation: torch.Tensor,
                     out_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(H_out, W_out, 2) source coordinates (x, y) for a (3, 3) rotation
    applied to output rays. A (ny, 3, 3) stack is the rolling-shutter
    form: output row ``r`` takes rotation ``min(r // 8, ny - 1)`` (one
    camera pose per 8-row tile row)."""
    if out_size is None:
        out_size = (out_camera.height, out_camera.width)
    h, w = out_size
    dev = rotation.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    rays = out_camera.unproject(torch.stack([xs, ys], dim=-1))
    r = rotation.to(torch.float32)
    if r.dim() == 3:
        rows = torch.clamp(torch.arange(h, device=dev) // TILE_ROWS, max=r.shape[0] - 1)
        r = r[rows].permute(1, 2, 0)[..., None]  # (3, 3, h, 1): per-row entries
    rx, ry, rz = rays[..., 0], rays[..., 1], rays[..., 2]
    rotated = torch.stack(
        [r[i, 0] * rx + r[i, 1] * ry + r[i, 2] * rz for i in range(3)], dim=-1)
    src = in_camera.project(rotated)
    behind = (rotated[..., 2] <= 1e-6)[..., None]
    return torch.where(behind, torch.full_like(src, -1e6), src)


def bilinear_sample(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample (H, W) ``image`` at ``coords`` (..., 2) in (x, y) order; taps
    outside the image contribute zero."""
    h, w = image.shape
    x = coords[..., 0]
    y = coords[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = image.to(torch.float32).reshape(-1)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        return torch.where(valid, flat[idx], 0.0)

    top = tap(y0i, x0i) * (1.0 - fx) + tap(y0i, x0i + 1) * fx
    bot = tap(y0i + 1, x0i) * (1.0 - fx) + tap(y0i + 1, x0i + 1) * fx
    return top * (1.0 - fy) + bot * fy


def warp_image(image: torch.Tensor, out_camera: Camera, in_camera: Camera,
               rotation: torch.Tensor,
               out_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Warp one (H, W) plane; float32 (H_out, W_out) result."""
    coords = compute_warp_map(out_camera, in_camera,
                              rotation.to(image.device), out_size)
    return bilinear_sample(image, coords)


def scaled_camera(camera: Camera, factor: float) -> Camera:
    """Camera of a plane downscaled by ``factor`` (chroma: 0.5), with the
    pixel-centre siting f' = f s, c' = (c + 0.5) s - 0.5 evaluated in
    float32 like the JAX package."""
    f32 = np.float32
    s = f32(factor)
    return Camera(
        fx=float(f32(camera.fx) * s), fy=float(f32(camera.fy) * s),
        cx=float((f32(camera.cx) + f32(0.5)) * s - f32(0.5)),
        cy=float((f32(camera.cy) + f32(0.5)) * s - f32(0.5)),
        dist=camera.dist,
        width=int(round(camera.width * factor)),
        height=int(round(camera.height * factor)),
        model=camera.model,
    )


def box_downsample(frames: torch.Tensor, level: int) -> torch.Tensor:
    """``level`` rounds of 2x2 box averaging over the last two dims.

    Odd trailing rows/columns are edge-replicated. Returns float32 for
    ``level > 0`` and the input untouched for level 0."""
    if level <= 0:
        return frames
    f = frames.to(torch.float32)
    for _ in range(level):
        h, w = f.shape[-2:]
        if h % 2 or w % 2:
            lead = f.shape[:-2]
            f = torch.nn.functional.pad(
                f.reshape(-1, 1, h, w), (0, w % 2, 0, h % 2),
                mode="replicate").reshape(*lead, h + h % 2, w + w % 2)
            h, w = f.shape[-2:]
        f = f.reshape(*f.shape[:-2], h // 2, 2, w // 2, 2)
        f = (f[..., 0, :, 0] + f[..., 0, :, 1]
             + f[..., 1, :, 0] + f[..., 1, :, 1]) * 0.25
    return f


def mip_camera(cam: Camera, level: int) -> Camera:
    """Camera of ``cam``'s plane after ``level`` rounds of
    :func:`box_downsample` (dims follow its edge-padded ceil)."""
    if level <= 0:
        return cam
    w, h = cam.width, cam.height
    for _ in range(level):
        w = (w + 1) // 2
        h = (h + 1) // 2
    s = 0.5 ** level
    return Camera.make(cam.fx * s, cam.fy * s, (cam.cx + 0.5) * s - 0.5,
                       (cam.cy + 0.5) * s - 0.5, w, h, cam.model,
                       dist=cam.dist)
