"""Pyramidal Lucas-Kanade sparse optical flow in plain torch ops.

Port of ``video_annotator_tpu/ops/lk.py``: the cv2-default window and
level count, the conditioning threshold, the ``pyrDown``-style 5-tap
blur + 2x decimation as two banded matrix products, and
:func:`pyramidal_lk`, the tracker on float frames of any size, batched
over points (and over a leading pair axis) with gathers. Kernel K2
(``ops/lk_kernel.py``) is the card's tracker of the analysers, with
:func:`_lk_level` on the levels too small for its window; the choice
between the two is :func:`resolve_lk`.

The products run in full float32 (TF32 off): the pyramid of a
box-downsampled uint8 frame is then exact at the first level, so the
uint8 rounding the LK stage applies sees the same values as the JAX
package's.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Tuple

import numpy as np
import torch

WIN = 21
DEF_LEVELS = 3
DEF_ITERS = 10
MIN_EIG_THRESHOLD = 1e-4


@functools.lru_cache(maxsize=32)
def _decim_matrix(n: int, device: torch.device) -> torch.Tensor:
    """(n//2, n) banded blur+decimate matrix: row r holds [1,4,6,4,1]/16 at
    columns 2r-2..2r+2, edge-clamped."""
    n2 = n // 2
    d = np.zeros((n2, n), np.float32)
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0
    for i in range(5):
        cols = np.clip(2 * np.arange(n2) + i - 2, 0, n - 1)
        d[np.arange(n2), cols] += k[i]
    return torch.from_numpy(d).to(device)


@contextlib.contextmanager
def full_fp32_matmul():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """5-tap Gaussian blur + 2x decimation of (..., H, W) float32 images."""
    img = img.to(torch.float32)
    h, w = img.shape[-2:]
    dy = _decim_matrix(h, img.device)
    dx = _decim_matrix(w, img.device)
    with full_fp32_matmul():
        return torch.matmul(torch.matmul(dy, img), dx.T)


def build_pyramid(img: torch.Tensor, levels: int = DEF_LEVELS):
    """List of (..., H/2^l, W/2^l) float32 images, level 0 = the input."""
    pyr = [img.to(torch.float32)]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def resolve_lk(device) -> str:
    """The analysers' LK on ``device``: ``"kernel"`` on a CUDA device,
    ``"plain"`` (:func:`pyramidal_lk` on float levels) elsewhere, the JAX
    package's rule for its Pallas and XLA trackers. Both track the levels
    of :func:`tracked_levels`: ``"kernel"`` runs K2 on the uint8-staged
    levels of at least 256 x 112 px and :func:`_lk_level` on the others
    (``ops/lk_kernel.py``, staged with ``plain_levels``), where the JAX
    package's Pallas tracker keeps the coarse guess."""
    return "kernel" if torch.device(device).type == "cuda" else "plain"


def _floor_int(v: torch.Tensor) -> torch.Tensor:
    """floor(v) as int64; values past +-2^30 (failed points' flows) saturate."""
    return torch.floor(v.clamp(-2.0 ** 30, 2.0 ** 30)).to(torch.int64)


def _gather(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, size: int) -> torch.Tensor:
    """(..., N, size, size) windows of (..., H, W) ``img`` whose top-left
    corners are the (..., N) integer ``y0``, ``x0`` (in bounds)."""
    h, w = img.shape[-2:]
    k = torch.arange(size, device=img.device)
    idx = (y0[..., None, None] + k[:, None]) * w + (x0[..., None, None] + k)
    flat = img.reshape(*img.shape[:-2], 1, h * w)
    lead = idx.shape[:-2]
    out = torch.gather(flat.expand(*lead[:-1], lead[-1], h * w),
                       -1, idx.reshape(*lead, size * size))
    return out.reshape(*lead, size, size)


def _extract_window(img: torch.Tensor, center: torch.Tensor, size: int):
    """The (size, size) window origin around the integer part of each
    (x, y) ``center`` (..., N, 2), clamped inside the (..., H, W) image:
    ``(x0, y0)`` of (..., N) int64. The window itself is gathered with
    the patch (:func:`_bilinear_patch`), whose taps it contains."""
    h, w = img.shape[-2:]
    half = size // 2
    x0 = (_floor_int(center[..., 0]) - half).clamp(0, w - size)
    y0 = (_floor_int(center[..., 1]) - half).clamp(0, h - size)
    return x0, y0


def _bilinear_patch(img: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                    off_x: torch.Tensor, off_y: torch.Tensor, size: int) -> torch.Tensor:
    """(..., N, size, size) patches at fractional offsets ``off`` inside
    the windows at (``x0``, ``y0``): four shifted taps blended by the
    fractional part, in the JAX package's order. ``off`` must satisfy
    0 <= off <= window size - size - 1."""
    ix = torch.floor(off_x)
    iy = torch.floor(off_y)
    fx = (off_x - ix)[..., None, None]
    fy = (off_y - iy)[..., None, None]
    ox = x0 + ix.to(torch.int64)
    oy = y0 + iy.to(torch.int64)

    def tap(dy, dx):
        return _gather(img, oy + dy, ox + dx, size)

    top = tap(0, 0) * (1 - fx) + tap(0, 1) * fx
    bot = tap(1, 0) * (1 - fx) + tap(1, 1) * fx
    return top * (1 - fy) + bot * fy


@functools.lru_cache(maxsize=8)
def _scharr(device: torch.device) -> torch.Tensor:
    """The x Scharr kernel / 32 on ``device`` (made once a device, so a
    call captured in a CUDA graph copies nothing from the host)."""
    return (torch.tensor([[-3.0, 0, 3], [-10, 0, 10], [-3, 0, 3]]) / 32.0).to(device)


def _lk_level(prev_img: torch.Tensor, next_img: torch.Tensor, point: torch.Tensor,
              guess: torch.Tensor, iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Refine the flow of (..., N, 2) ``point`` at one level of (..., H, W)
    frames from ``guess``; returns ``(flow, ok)``."""
    h, w = prev_img.shape[-2:]
    half = WIN // 2
    thalo = WIN + 2  # template + 1-px gradient halo
    wsize_t = thalo + 4  # prev window: halo patch + fractional slack
    wsize_n = WIN + 4  # per-iteration next window (re-fetched)
    if h < wsize_t or w < wsize_t:
        # A level smaller than the window: the guess passes through.
        return guess, torch.ones(point.shape[:-1], dtype=torch.bool, device=point.device)

    px0, py0 = _extract_window(prev_img, point, wsize_t)
    tx = (point[..., 0] - px0.to(torch.float32) - (half + 1)).clamp(0.0, wsize_t - thalo - 1.0)
    ty = (point[..., 1] - py0.to(torch.float32) - (half + 1)).clamp(0.0, wsize_t - thalo - 1.0)
    tpl_halo = _bilinear_patch(prev_img, px0, py0, tx, ty, thalo)
    tpl = tpl_halo[..., 1:-1, 1:-1]

    # Scharr gradients of the template, VALID over the halo -> (WIN, WIN).
    k = _scharr(tpl_halo.device)
    flat = tpl_halo.reshape(-1, 1, thalo, thalo)
    ix = torch.nn.functional.conv2d(flat, k[None, None]).reshape(tpl.shape)
    iy = torch.nn.functional.conv2d(flat, k.T[None, None]).reshape(tpl.shape)

    gxx = (ix * ix).sum((-2, -1))
    gxy = (ix * iy).sum((-2, -1))
    gyy = (iy * iy).sum((-2, -1))
    det = gxx * gyy - gxy * gxy
    trace = gxx + gyy
    min_eig = (trace - torch.sqrt(torch.clamp(trace * trace - 4 * det, min=0.0))) * 0.5
    ok_g = min_eig / (WIN * WIN) > MIN_EIG_THRESHOLD
    inv = torch.where(det.abs() > 1e-12, 1.0 / det, torch.zeros_like(det))

    v = guess
    for _ in range(iters):
        # Re-fetch the window around the current estimate (cv2 semantics).
        c = point + v
        nx0, ny0 = _extract_window(next_img, c, wsize_n)
        ox = (c[..., 0] - nx0.to(torch.float32) - half).clamp(0.0, wsize_n - WIN - 1.0)
        oy = (c[..., 1] - ny0.to(torch.float32) - half).clamp(0.0, wsize_n - WIN - 1.0)
        r = _bilinear_patch(next_img, nx0, ny0, ox, oy, WIN) - tpl
        bx = (r * ix).sum((-2, -1))
        by = (r * iy).sum((-2, -1))
        dv = torch.stack([gyy * bx - gxy * by, gxx * by - gxy * bx], dim=-1) * inv[..., None]
        v = v - dv

    # In-bounds check at full precision position.
    tgt = point + v
    ok_b = ((point[..., 0] >= half) & (point[..., 0] < w - half)
            & (point[..., 1] >= half) & (point[..., 1] < h - half)
            & (tgt[..., 0] >= half) & (tgt[..., 0] < w - half)
            & (tgt[..., 1] >= half) & (tgt[..., 1] < h - half))
    return v, ok_g & ok_b


def tracked_levels(h: int, w: int, levels: int = DEF_LEVELS) -> int:
    """Pyramid levels :func:`pyramidal_lk` tracks on (h, w) frames: cv2's
    reduction keeps a level while min(h, w) >> level >= 2 * WIN."""
    max_lv = 1
    while max_lv < levels and (min(h, w) >> max_lv) >= 2 * WIN:
        max_lv += 1
    return max_lv


def pyramidal_lk(prev_img: torch.Tensor, next_img: torch.Tensor, points: torch.Tensor,
                 valid: torch.Tensor, levels: int = DEF_LEVELS, iters: int = DEF_ITERS):
    """Track (..., N, 2) float (x, y) ``points`` from (..., H, W)
    ``prev_img`` to ``next_img``, coarse to fine; a leading axis tracks
    pairs side by side. Returns ``(new_points, status)``: ``status`` is
    ``valid`` and, at every level, the gradient-conditioning gate and the
    bounds check.

    Levels follow cv2's reduction: a level is tracked only while
    min(H, W) >> level >= 2 * WIN, so a small frame tracks fewer levels;
    a level under the 27-px template passes its guess through."""
    max_lv = tracked_levels(*prev_img.shape[-2:], levels)
    pyr_prev = build_pyramid(prev_img, max_lv)
    pyr_next = build_pyramid(next_img, max_lv)
    points = points.to(torch.float32)
    flow = points * 0.0
    status = valid
    for lvl in range(max_lv - 1, -1, -1):
        scale = 2.0 ** lvl
        f, ok = _lk_level(pyr_prev[lvl], pyr_next[lvl], points / scale, flow / scale, iters)
        flow = f * scale
        status = status & ok
    return points + flow, status
