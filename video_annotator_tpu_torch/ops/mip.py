"""Per-tile mip levels of the minification prefilter (``--prefilter auto``).

The port's own copy of the mip half of ``plan_warp``
(``video_annotator_tpu/ops/warp_pallas.py:369-559``): the warp map is
probed under the identity and seven rotations of the correction budget
(``:429-437``, ``_rodrigues_np`` :348) at full output resolution in
float64; per pixel the smallest singular value of the map's Jacobian
bounds how far the source may be box-filtered without blurring
(``:459-492``: central differences, only pixels that are rendered, 4-tap
modes reaching one pixel further); per 8x128 output tile (the TPU's tile,
``TILE_H``, ``TILE_W`` :61-62) the level is the floor of log2 of the
smallest value over the probes, with a 5% guard, clipped to
:data:`MIP_LEVELS` (``:544-559``; the JAX ``FrameWarper`` asks for
``mip_levels=2``). The result is a
``(ceil(out_h / 8), ceil(out_w / 128))`` uint8 map.

It runs in torch float64 on the device that will warp, not in numpy on
the host: at a 4680x3520 output the eight probes are 133 M pixels.

Sampling (``:1203-1210`` with ``pack_frame_words_mip`` :1711-1734): a
pixel is rendered or not by its full-resolution source coordinates; a
pixel of a tile at level ``l`` samples ``box_downsample^l`` of the plane
at ``(s + 0.5) 2^-l - 0.5``, taps outside that level's plane reading the
border value. In the uint8 modes each level is rounded to bytes, as the
TPU packed it (kernel K3, ``ops/stage.py``); the float modes keep it
unrounded, as they keep their sources.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch

from video_annotator_tpu_torch.camera import Camera, CameraModel
from video_annotator_tpu_torch.ops.warp_plain import (
    TILE_ROWS,
    box_downsample,
    sample,
)

TILE_COLS = 128  # output columns per entry of a level map (the TPU tile)
# The deepest level: what --prefilter auto asks for (the JAX FrameWarper,
# render.py:1745), and the levels K1's mip mode reads beside the plane
# itself (csrc/warp_modes.cu, MAX_LEVELS = MIP_LEVELS + 1).
MIP_LEVELS = 2
GUARD = 1.05  # a tile's smallest singular value must exceed 2^l by 5%
FISHEYE_MAX_THETA = math.pi / 2 - 1e-3  # the planner's fisheye unprojection clip


@dataclasses.dataclass(frozen=True)
class TileLevels:
    """A level map and its largest level (0: the prefilter engages
    nowhere, and the warp runs without it)."""

    levels: torch.Tensor  # (ceil(out_h / 8), ceil(out_w / 128)) uint8
    max_level: int

    def per_pixel(self, out_size: Tuple[int, int]) -> torch.Tensor:
        """(out_h, out_w) int64 level of every output pixel."""
        h, w = out_size
        dev = self.levels.device
        rows = torch.arange(h, device=dev) // TILE_ROWS
        cols = torch.arange(w, device=dev) // TILE_COLS
        return self.levels.to(torch.int64)[rows][:, cols]


def _rodrigues(w) -> torch.Tensor:
    """Rotation matrix of rotation vector ``w`` in float64."""
    w = torch.as_tensor(w, dtype=torch.float64)
    theta = float(torch.linalg.vector_norm(w))
    if theta < 1e-12:
        return torch.eye(3, dtype=torch.float64)
    k = w / theta
    kx = torch.tensor([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]],
                      dtype=torch.float64)
    return torch.eye(3, dtype=torch.float64) + math.sin(theta) * kx \
        + (1.0 - math.cos(theta)) * (kx @ kx)


def probe_rotations(max_correction_deg: float) -> List[torch.Tensor]:
    """The identity and the budget angle about each axis both ways and
    about the diagonal."""
    ang = math.radians(max_correction_deg)
    axes = ([ang, 0, 0], [0, ang, 0], [0, 0, ang], [-ang, 0, 0], [0, -ang, 0],
            [0, 0, -ang], [ang / 1.7, ang / 1.7, ang / 1.7])
    return [torch.eye(3, dtype=torch.float64)] + [_rodrigues(a) for a in axes]


def warp_map_f64(out_camera: Camera, in_camera: Camera, rot: torch.Tensor,
                 out_size: Tuple[int, int], device) -> torch.Tensor:
    """(H, W, 2) float64 source coordinates under the (3, 3) ``rot``
    (``_warp_map_np``): rays behind the camera are pinned to -1e6."""
    max_theta = FISHEYE_MAX_THETA if out_camera.model == CameraModel.FISHEYE else None
    h, w = out_size
    ys = torch.arange(h, dtype=torch.float64, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float64, device=device)[None, :].expand(h, w)
    rays = out_camera.unproject(torch.stack([xs, ys], dim=-1), max_theta=max_theta)
    v = rays @ rot.to(device).T
    behind = v[..., 2] <= 1e-9
    vz = torch.where(behind, 1.0, v[..., 2])
    a = torch.where(behind, -1e6, v[..., 0] / vz)
    b = torch.where(behind, -1e6, v[..., 1] / vz)
    scale = 1.0
    if in_camera.model == CameraModel.FISHEYE:
        r = torch.sqrt(a * a + b * b)
        theta = torch.atan(r)
        k1, k2, k3, k4 = in_camera.dist
        t2 = theta * theta
        theta = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
        scale = torch.where(r > 1e-8, theta / torch.clamp(r, min=1e-8), 1.0)
    return torch.stack([in_camera.fx * a * scale + in_camera.cx,
                        in_camera.fy * b * scale + in_camera.cy], dim=-1)


def _gradient(f: torch.Tensor, dim: int) -> torch.Tensor:
    """``np.gradient`` along ``dim``: central differences inside, one-sided
    at the two ends."""
    n = f.shape[dim]
    inner = (f.narrow(dim, 2, n - 2) - f.narrow(dim, 0, n - 2)) / 2.0
    first = f.narrow(dim, 1, 1) - f.narrow(dim, 0, 1)
    last = f.narrow(dim, n - 1, 1) - f.narrow(dim, n - 2, 1)
    return torch.cat([first, inner, last], dim=dim)


def _smallest_singular_value(sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    ga, gb = _gradient(sx, 1), _gradient(sx, 0)
    gc, gd = _gradient(sy, 1), _gradient(sy, 0)
    e = ga * ga + gb * gb + gc * gc + gd * gd
    det = ga * gd - gb * gc
    disc = torch.sqrt(torch.clamp(e * e - 4.0 * det * det, min=0.0))
    return torch.sqrt(torch.clamp((e - disc) * 0.5, min=0.0))


def _pad(interp: str) -> float:
    """How far outside the image a pixel still has taps inside: 4-tap
    modes reach one pixel further than bilinear."""
    return 0.0 if interp == "bilinear" else 1.0


def tile_levels(out_camera: Camera, in_camera: Camera, max_correction_deg: float,
                out_size: Tuple[int, int], interp: str = "bilinear",
                device="cpu") -> TileLevels:
    """The level map of an ``out_size`` output (``plan_warp(...,
    mip_levels=2).levels``), computed on ``device``."""
    crop_h, crop_w = out_size
    ny = -(-crop_h // TILE_ROWS)
    nx = -(-crop_w // TILE_COLS)
    h, w = ny * TILE_ROWS, nx * TILE_COLS
    in_w, in_h = float(in_camera.width), float(in_camera.height)
    pad = _pad(interp)
    smin_t = torch.full((ny, nx), float("inf"), dtype=torch.float64, device=device)
    for rot in probe_rotations(max_correction_deg):
        cmap = warp_map_f64(out_camera, in_camera, rot, (h, w), device)
        cx, cy = cmap[..., 0], cmap[..., 1]
        # Out-of-image sources are clipped so they add no stretch.
        smin = _smallest_singular_value(torch.clamp(cx, -8.0, in_w + 8.0),
                                        torch.clamp(cy, -8.0, in_h + 8.0))
        rendered = (cx > -1.0 - pad) & (cx < in_w + pad) & (cy > -1.0 - pad) & (cy < in_h + pad)
        rendered[crop_h:, :] = False
        rendered[:, crop_w:] = False
        smin = torch.where(rendered, smin, 1e9)
        per_tile = smin.reshape(ny, TILE_ROWS, nx, TILE_COLS).amin(dim=(1, 3))
        smin_t = torch.minimum(smin_t, per_tile)
    smin_t = torch.clamp(smin_t, max=1e9)  # never-rendered tiles: the deepest level
    lv = torch.floor(torch.log2(torch.clamp(smin_t / GUARD, min=1.0)))
    lv = torch.clamp(lv, 0, MIP_LEVELS).to(torch.uint8)
    return TileLevels(lv, int(lv.max()))


def float_levels(planes: torch.Tensor, max_level: int) -> List[torch.Tensor]:
    """Levels 1..``max_level`` of (..., H, W) planes, float32, unrounded."""
    out, f = [], planes
    for _ in range(max_level):
        f = box_downsample(f, 1)
        out.append(f.contiguous())
    return out


def sample_levels(planes: List[torch.Tensor], coords: torch.Tensor,
                  level_px: torch.Tensor, border: float,
                  interp: str = "bilinear") -> torch.Tensor:
    """Plain per-tile mip sampling of one plane: ``planes[l]`` is level
    ``l`` as float32 (level 0 the plane itself), ``coords`` the
    full-resolution (H, W, 2) source coordinates, ``level_px`` the (H, W)
    level of each pixel. Sampled centred on ``border``; a pixel whose
    full-resolution coordinates are not rendered is ``border``."""
    h, w = planes[0].shape
    pad = _pad(interp)
    cx, cy = coords[..., 0], coords[..., 1]
    valid = (cx > -1.0 - pad) & (cx < w + pad) & (cy > -1.0 - pad) & (cy < h + pad)
    out = torch.full(cx.shape, float(border), dtype=torch.float32, device=coords.device)
    for level, plane in enumerate(planes):
        at = coords if level == 0 else (coords + 0.5) * 2.0 ** -level - 0.5
        got = sample(plane.to(torch.float32) - border, at, interp) + border
        out = torch.where(valid & (level_px == level), got, out)
    return out

