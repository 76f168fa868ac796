"""Warp map + remap in plain torch: the oracle of the warp kernel.

Port of ``video_annotator_tpu/ops/warp_xla.py`` (``compute_warp_map``,
``bilinear_sample``, ``keys_weight``, ``lanczos_weight``,
``bicubic_sample``, ``lanczos_sample`` with a = 2, ``warp_image_xla``,
``_scaled_camera``) and of the two camera/plane helpers the analyse and
encode phases share (``box_downsample``, ``mip_camera`` from
``ops/warp_pallas.py``).

For every output pixel: unproject through the output camera, rotate the
ray, project through the input camera, and sample the source, taps
outside the frame reading zero (``cv::remap`` BORDER_CONSTANT): exact 2x2
bilinear taps, or 4x4 taps weighted by the Keys cubic (a = -0.75,
``bicubic``) or the lanczos windowed sinc (a = 2, normalised by the
separable weight sums whether or not taps fall outside, ``lanczos``). The
weights are the true functions, evaluated per pixel, not the Pallas
kernel's fitted polynomials. Rays that end up behind the input camera
are pinned far outside so they sample the border.

Each sampler's products and sums run in the order kernel K1 runs them
(``csrc/warp_modes.cu``), so that on the card the two agree bit for bit.
"""

from __future__ import annotations

import functools
import math
import operator
from typing import Optional, Tuple

import numpy as np
import torch

from video_annotator_tpu_torch.camera import Camera

TILE_ROWS = 8  # output rows per rotation of a per-tile-row stack
INTERPS = ("bilinear", "bicubic", "lanczos")
KEYS_A = -0.75  # cv::remap INTER_CUBIC's Keys parameter
LANCZOS_A = 2  # v360's interp=lanczos: 4x4 taps


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
    r = rotation.to(torch.float32)
    if r.dim() == 3:
        rows = torch.clamp(torch.arange(h, device=dev) // TILE_ROWS, max=r.shape[0] - 1)
        r = r[rows].permute(1, 2, 0)[..., None]  # (3, 3, h, 1): per-row entries
    return map_rays(ray_grid(out_camera, out_size, dev), r, in_camera)


def map_rays(rays: torch.Tensor, r: torch.Tensor, in_camera: Camera) -> torch.Tensor:
    """(..., 2) source coordinates of output ``rays`` (..., 3) rotated by
    ``r`` (a (3, 3) matrix, or (3, 3) entries that broadcast against the
    rays' leading dims) and projected through ``in_camera``."""
    rx, ry, rz = rays[..., 0], rays[..., 1], rays[..., 2]
    rotated = torch.stack(
        [r[i, 0] * rx + r[i, 1] * ry + r[i, 2] * rz for i in range(3)], dim=-1)
    src = in_camera.project(rotated)
    # Not "> 1e-6", NaN included: the kernel's test of a ray in front
    behind = ~(rotated[..., 2] > 1e-6)[..., None]
    return torch.where(behind, torch.full_like(src, -1e6), src)


def ray_grid(out_camera: Camera, out_size: Tuple[int, int], device,
             dtype=torch.float32, row0: int = 0) -> torch.Tensor:
    """(H, W, 3) output rays of every pixel of an ``out_size`` canvas, its
    rows counted from ``row0``: what :func:`compute_warp_map` rotates, and
    what K1 reads for an output camera that is not rectilinear
    (``_ray_grid_dev``, ``warp_pallas.py:1750-1765``)."""
    h, w = out_size
    ys = torch.arange(row0, row0 + h, dtype=dtype, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    return out_camera.unproject(torch.stack([xs, ys], dim=-1))


def bilinear_sample(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample (H, W) ``image`` at ``coords`` (..., 2) in (x, y) order; taps
    outside the image contribute zero."""
    x = coords[..., 0]
    y = coords[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    tap = _tap_reader(image)
    top = tap(y0i, x0i) * (1.0 - fx) + tap(y0i, x0i + 1) * fx
    bot = tap(y0i + 1, x0i) * (1.0 - fx) + tap(y0i + 1, x0i + 1) * fx
    return top * (1.0 - fy) + bot * fy


def keys_weight(t: torch.Tensor, a: float = KEYS_A) -> torch.Tensor:
    """Keys cubic weight at offset ``t`` (cv2 INTER_CUBIC's kernel):
    (a+2)|t|^3 - (a+3)|t|^2 + 1 for |t| <= 1, a(|t|^3 - 5|t|^2 + 8|t| - 4)
    for 1 < |t| < 2, else 0."""
    t = torch.abs(t)
    near = ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0
    far = a * (((t - 5.0) * t + 8.0) * t - 4.0)
    return torch.where(t <= 1.0, near, torch.where(t < 2.0, far, 0.0))


def lanczos_weight(t: torch.Tensor, a: int = LANCZOS_A) -> torch.Tensor:
    """Lanczos weight sinc(t) sinc(t / a) at offset ``t``, before
    normalisation."""
    t = torch.abs(t)
    pt = math.pi * torch.clamp(t, min=1e-6)
    win = torch.sin(pt) * torch.sin(pt / a) * (a / (pt * pt))
    return torch.where(t < 1e-6, 1.0, torch.where(t < a, win, 0.0))


def _tap_reader(image: torch.Tensor):
    """``tap(yi, xi)``: the float32 pixels of (H, W) ``image`` at integer
    coordinates, zero outside the image."""
    h, w = image.shape
    flat = image.to(torch.float32).reshape(-1)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        return torch.where(valid, flat[idx], 0.0)

    return tap


def four_tap_sample(image: torch.Tensor, coords: torch.Tensor,
                    interp: str) -> torch.Tensor:
    """Sample (H, W) ``image`` at ``coords`` (..., 2), (x, y) order, with
    4x4 taps at offsets -1..2 around the floor: ``bicubic``
    (``bicubic_sample``) or ``lanczos`` (``lanczos_sample``, a = 2, the
    sum divided by the product of the x and y weight sums). Taps outside
    the image contribute zero. The eight weights are computed once per
    pixel; each row of taps is summed left to right, then the rows top to
    bottom, as the kernel sums them."""
    weight = {"bicubic": keys_weight, "lanczos": lanczos_weight}[interp]
    x = coords[..., 0]
    y = coords[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    tap = _tap_reader(image)
    offsets = (-1, 0, 1, 2)
    wxs = [weight(fx - k) for k in offsets]
    wys = [weight(fy - j) for j in offsets]
    out = None
    for j, wy in zip(offsets, wys):
        row = None
        for k, wx in zip(offsets, wxs):
            term = wx * tap(y0i + j, x0i + k)
            row = term if row is None else row + term
        out = wy * row if out is None else out + wy * row
    if interp == "lanczos":
        out = out / (functools.reduce(operator.add, wxs)
                     * functools.reduce(operator.add, wys))
    return out


def sample(image: torch.Tensor, coords: torch.Tensor,
           interp: str = "bilinear") -> torch.Tensor:
    """:func:`bilinear_sample` or :func:`four_tap_sample` by ``interp``."""
    if interp == "bilinear":
        return bilinear_sample(image, coords)
    if interp not in INTERPS:
        raise ValueError(f"--interp must be one of {INTERPS}, got {interp!r}")
    return four_tap_sample(image, coords, interp)


def warp_image(image: torch.Tensor, out_camera: Camera, in_camera: Camera,
               rotation: torch.Tensor,
               out_size: Optional[Tuple[int, int]] = None,
               interp: str = "bilinear") -> torch.Tensor:
    """Warp one (H, W) plane; float32 (H_out, W_out) result."""
    coords = compute_warp_map(out_camera, in_camera,
                              rotation.to(image.device), out_size)
    return sample(image, coords, interp)


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
