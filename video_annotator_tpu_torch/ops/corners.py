"""Shi-Tomasi (min-eigenvalue) corner detection on a batch of frames.

Port of ``video_annotator_tpu/ops/corners.py``: Sobel gradients and a 3x3
box structure tensor as shift-and-add passes (no convolution library, so
no TF32 anywhere), the quality threshold, one corner per
``min_distance`` cell, suppression of a cell whose stronger 8-neighbour's
winner is closer than ``min_distance``, and the global top-``max_corners``
cells. Ties in the final ranking break as (score desc, index asc), the
order ``lax.top_k`` returns.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _sep3(img: torch.Tensor, ky, kx) -> torch.Tensor:
    """Separable 3-tap filter over the last two dims, zero-padded."""
    pad = F.pad(img, (1, 1, 1, 1))
    v = (ky[0] * pad[..., :-2, 1:-1] + ky[1] * pad[..., 1:-1, 1:-1]
         + ky[2] * pad[..., 2:, 1:-1])
    pad = F.pad(v, (1, 1, 0, 0))
    return kx[0] * pad[..., :, :-2] + kx[1] * pad[..., :, 1:-1] + kx[2] * pad[..., :, 2:]


def shi_tomasi_response(img: torch.Tensor) -> torch.Tensor:
    """Min-eigenvalue response of (..., H, W) float32 images (3x3 block)."""
    img = img.to(torch.float32)
    ix = _sep3(img, (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0))
    iy = _sep3(img, (-1.0, 0.0, 1.0), (1.0, 2.0, 1.0))
    ones = (1.0, 1.0, 1.0)
    inv_area = 1.0 / 9.0
    a = _sep3(ix * ix, ones, ones) * inv_area
    b = _sep3(ix * iy, ones, ones) * inv_area
    c = _sep3(iy * iy, ones, ones) * inv_area
    d = (a - c) * 0.5
    return (a + c) * 0.5 - torch.sqrt(torch.clamp(d * d + b * b, min=0.0))


def _shift(arr: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """``out[..., i, j] = arr[..., i - dy, j - dx]``, ``fill`` outside."""
    ny, nx = arr.shape[-2:]
    pad = F.pad(arr, (1, 1, 1, 1), value=fill)
    return pad[..., 1 - dy:1 - dy + ny, 1 - dx:1 - dx + nx]


def detect_corners(img: torch.Tensor, max_corners: int = 256,
                   quality_level: float = 0.01, min_distance: int = 30,
                   border: int = 8):
    """Detect up to ``max_corners`` well-spread corners in each of a
    (T, H, W) batch of frames (or one (H, W) frame).

    Returns ``(points, valid)``: (T, max_corners, 2) float32 (x, y) and
    (T, max_corners) bool (without the T axis for a single frame)."""
    single = img.dim() == 2
    if single:
        img = img[None]
    t, h, w = img.shape
    dev = img.device
    resp = shi_tomasi_response(img)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    inside = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    resp = torch.where(inside, resp, 0.0)
    threshold = resp.amax(dim=(1, 2)) * quality_level

    # Cells as in the JAX package (a stage-one window of <= 32 px).
    cell = max(int(min_distance), 1)
    nsub = -(-cell // 32)
    cell = -(-cell // nsub) * nsub
    ny, nx = -(-h // cell), -(-w // cell)
    padded = F.pad(resp, (0, nx * cell - w, 0, ny * cell - h),
                   value=float("-inf"))
    cells = padded.reshape(t, ny, cell, nx, cell).permute(0, 1, 3, 2, 4)
    cells = cells.reshape(t, ny, nx, cell * cell)
    cell_best = cells.amax(dim=-1)
    # Winner: the smallest cell-local index holding the cell maximum.
    winner = torch.argmax((cells >= cell_best[..., None]).to(torch.uint8), dim=-1)
    cy = torch.arange(ny, device=dev)[:, None] * cell
    cx = torch.arange(nx, device=dev)[None, :] * cell
    py_g = cy + winner // cell
    px_g = cx + winner % cell

    keep = torch.ones((t, ny, nx), dtype=torch.bool, device=dev)
    far = -(10 * cell)
    md2 = min_distance * min_distance
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n_score = _shift(cell_best, dy, dx, float("-inf"))
            n_py = _shift(py_g, dy, dx, far)
            n_px = _shift(px_g, dy, dx, far)
            d2 = (py_g - n_py) ** 2 + (px_g - n_px) ** 2
            earlier = dy < 0 or (dy == 0 and dx < 0)
            stronger = (n_score > cell_best) | ((n_score == cell_best) & earlier)
            keep &= ~((d2 < md2) & stronger)

    scores = torch.where(keep, cell_best, -1.0).reshape(t, -1)
    k = min(max_corners, scores.shape[1])
    top_scores, top_idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    px = torch.gather(px_g.reshape(t, -1), 1, top_idx)
    py = torch.gather(py_g.reshape(t, -1), 1, top_idx)
    points = torch.stack([px, py], dim=-1).to(torch.float32)
    valid = top_scores > torch.clamp(threshold, min=0.0)[:, None]
    if k < max_corners:
        points = F.pad(points, (0, 0, 0, max_corners - k))
        valid = torch.cat([valid, valid.new_zeros((t, max_corners - k))], 1)
    if single:
        return points[0], valid[0]
    return points, valid
