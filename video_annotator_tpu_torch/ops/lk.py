"""Pyramidal Lucas-Kanade constants and the image pyramid.

Port of the pyramid half of ``video_annotator_tpu/ops/lk.py``: the
cv2-default window and level count, the conditioning threshold, and the
``pyrDown``-style 5-tap blur + 2x decimation as two banded matrix
products. The tracking itself is ``ops/lk_kernel.py``.

The products run in full float32 (TF32 off): the pyramid of a
box-downsampled uint8 frame is then exact at the first level, so the
uint8 rounding the LK stage applies sees the same values as the JAX
package's.
"""

from __future__ import annotations

import contextlib
import functools

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
