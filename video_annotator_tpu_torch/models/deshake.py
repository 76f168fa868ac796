"""The deshake-family stabiliser: global translation + blurred-edge fill.

Port of ``video_annotator_tpu/models/deshake.py``, the counterpart of
ffmpeg's ``deshake`` and ``deshake_opencl``. Motion comes from FFT phase
correlation (``ops/phasecorr.py``); borders revealed by the correction
are filled with a blurred copy of the frame instead of black. The JAX
package wrote no kernel for this family: the blur is two banded matrix
products and the shift two axis-wise index selects per bilinear tap, and
so they are here.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from video_annotator_tpu_torch.ops.lk import full_fp32_matmul
from video_annotator_tpu_torch.ops.phasecorr import phase_correlate
from video_annotator_tpu_torch.ops.warp_plain import box_downsample
from video_annotator_tpu_torch.pipeline.profiler import StageProfiler
from video_annotator_tpu_torch.pipeline.render import (
    TrimmedFrames,
    analysis_level,
    open_trimmed,
)
from video_annotator_tpu_torch.pipeline.trajectory import Trajectory
from video_annotator_tpu_torch.smoothing.savgol import savgol_weights, sg_conv

# Below this normalised confidence the correlation surface has no
# trustworthy peak (scene cut, flat frame; thresholds in
# ops/phasecorr.py) and the previous frame's motion carries over: the
# family's analogue of the rotation family's inlier gate.
CONF_MIN = 1.5
# Accepted deltas are clamped to this share of the frame per axis:
# frame-to-frame shake is small, and the clamp bounds the damage of the
# one degenerate class the confidence cannot see, a cut that mimics a
# periodic genuine pair.
MAX_DELTA_SHARE = 1.0 / 8.0
BLUR_SIGMA = 8.0


def analyse_deshake(source: str, options,
                    profiler: Optional[StageProfiler] = None,
                    device="cuda") -> Trajectory:
    """Accumulated global translation per frame by phase correlation, on
    the ``--analysis-scale`` level (translations scale back by 2^level at
    collect time). Runs and accumulates on the device: one device-to-host
    copy for the whole trajectory."""
    prof = profiler or StageProfiler()
    dev = torch.device(device)
    reader, meta, first, last = open_trimmed(source, options, dev)
    level = analysis_level(options, meta)
    acc = torch.zeros(2, dtype=torch.float32, device=dev)
    prev_d = torch.zeros(2, dtype=torch.float32, device=dev)
    out = []
    prev_small = d_max = None
    with TrimmedFrames(reader, first, last, options, dev, prof) as frames:
        for y, _, _ in frames:
            small = box_downsample(y.to(torch.float32), level)
            if prev_small is not None:
                with prof.stage("track"):
                    # d such that curr(x) ~= prev(x - d): the camera moved by +d.
                    d, conf = phase_correlate(small, prev_small)
                    if d_max is None:  # uploaded once: a copy from the host waits
                        d_max = torch.tensor(
                            [small.shape[1] * MAX_DELTA_SHARE,
                             small.shape[0] * MAX_DELTA_SHARE], device=dev)
                    d = torch.clamp(d, -d_max, d_max)
                    prev_d = torch.where(conf >= CONF_MIN, d, prev_d)
                    acc = acc + prev_d
            prev_small = small
            out.append(acc)
    with prof.stage("collect"):
        params_np = (torch.stack(out).cpu().numpy().astype(np.float64)
                     if out else np.zeros((0, 2)))
        params_np *= float(1 << level)
    return Trajectory(params=params_np, kind="translation", fps=meta.fps,
                      width=meta.width, height=meta.height, source=source)


def deshake_corrections(traj: Trajectory, options) -> np.ndarray:
    """Per-frame sampling offsets (output px -> source px), (T, 2)."""
    t = traj.num_frames
    acc = torch.from_numpy(np.asarray(traj.params, np.float32))
    if t == 0 or options.stabilise == "none":
        return np.zeros((t, 2), np.float32)
    if options.stabilise == "fixed":
        smooth = torch.zeros_like(acc)
    else:
        radius = min(options.stabilise_radius, max(t - 1, 1))
        w = torch.from_numpy(savgol_weights(radius, 2))
        padded = torch.cat([acc[:1].expand(radius, 2), acc,
                            acc[-1:].expand(radius, 2)])
        smooth = sg_conv(padded, w)
    # sample at x_out + (acc - smooth): remove the jitter component.
    return (acc - smooth).numpy()


@functools.lru_cache(maxsize=8)
def _blur_band(n: int, sigma: float, device: torch.device) -> torch.Tensor:
    """(n, n) replicate-edge Gaussian blur operator along one axis: row i
    accumulates the kernel weight of tap i + d onto clip(i + d, 0, n - 1),
    exactly an edge-padded 1D convolution as a dense banded matrix. Two of
    these products are the separable blur."""
    radius = int(3 * sigma)
    d = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (d / sigma) ** 2)
    k = k / k.sum()
    band = np.zeros((n, n), np.float32)
    rows = np.repeat(np.arange(n), d.size)
    cols = np.clip(np.arange(n)[:, None] + d[None, :], 0, n - 1).ravel()
    np.add.at(band, (rows, cols), np.tile(k, n))
    return torch.from_numpy(band).to(device)


def gauss_blur(img: torch.Tensor, sigma: float = BLUR_SIGMA) -> torch.Tensor:
    """Separable replicate-edge Gaussian blur of an (H, W) plane as two
    banded matrix products in full float32."""
    h, w = img.shape
    bv = _blur_band(h, sigma, img.device)
    bh = _blur_band(w, sigma, img.device)
    with full_fp32_matmul():
        return torch.matmul(torch.matmul(bv, img), bh.T)


def _shift(img: torch.Tensor, off: torch.Tensor, fill_blur: bool) -> torch.Tensor:
    """``img`` sampled at ``x_out + off`` with bilinear taps.

    A pure translation needs no 2D gather: each tap is the image advanced
    by an integer offset, two axis-wise index selects with clamped 1-D
    index vectors. Out-of-image taps are masked to zero (the bilinear
    sampler's constant border) or, for the blurred background, left
    clamped (the replicate-edge sample of the blurred frame)."""
    h, w = img.shape
    dev = img.device
    j0 = torch.floor(off[0])
    i0 = torch.floor(off[1])
    fx = off[0] - j0
    fy = off[1] - i0
    rows = torch.arange(h, device=dev) + i0.to(torch.int64)
    cols = torch.arange(w, device=dev) + j0.to(torch.int64)

    def tap(base, di, dj, clamp):
        r = rows + di
        c = cols + dj
        v = base.index_select(0, r.clamp(0, h - 1)).index_select(1, c.clamp(0, w - 1))
        if clamp:
            return v
        rv = ((r >= 0) & (r < h)).to(torch.float32)[:, None]
        cv = ((c >= 0) & (c < w)).to(torch.float32)[None, :]
        return v * rv * cv

    def sample(base, clamp):
        top = (1.0 - fx) * tap(base, 0, 0, clamp) + fx * tap(base, 0, 1, clamp)
        bot = (1.0 - fx) * tap(base, 1, 0, clamp) + fx * tap(base, 1, 1, clamp)
        return (1.0 - fy) * top + fy * bot

    out = sample(img, clamp=False)
    if fill_blur:
        ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + off[1]
        xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + off[0]
        inside = ((xs >= 0) & (xs <= w - 1) & (ys >= 0) & (ys <= h - 1)).to(torch.float32)
        bg = sample(gauss_blur(img), clamp=True)
        out = inside * out + (1.0 - inside) * bg
    return out


def warp_frame_deshake(y, u, v, offset: torch.Tensor, blur_edges: bool = True):
    """Translate float YUV planes by ``offset`` (x, y): luma with the
    blurred-edge fill, chroma centred on 128 with half the offset."""
    offset = offset.to(device=y.device, dtype=torch.float32)
    half = offset * 0.5
    wy = _shift(y, offset, blur_edges)
    wu = _shift(u - 128.0, half, False) + 128.0
    wv = _shift(v - 128.0, half, False) + 128.0
    return wy, wu, wv
