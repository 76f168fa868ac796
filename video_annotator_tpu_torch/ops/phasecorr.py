"""Global translation estimation by phase correlation.

Port of ``video_annotator_tpu/ops/phasecorr.py`` on ``torch.fft``: two
real 2D FFTs, a regularised spectral whitening, the inverse FFT, an
argmax and a parabolic subpixel refinement from the peak's neighbours.
The JAX package wrote no kernel for this; neither does the port.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _hann_window(h: int, w: int, device: torch.device) -> torch.Tensor:
    """(h, w) separable symmetric Hann window, kept per size and device:
    an upload from the host waits for the work queued before it."""
    wy = torch.from_numpy(np.hanning(h).astype(np.float32))[:, None]
    wx = torch.from_numpy(np.hanning(w).astype(np.float32))[None, :]
    return (wy * wx).to(device)


def phase_correlate(a: torch.Tensor, b: torch.Tensor, whiten_reg: float = 1.0):
    """Translation ``(dx, dy)`` such that ``a(x) ~= b(x - d)``, and a
    confidence; both (H, W) inputs on one device.

    ``d`` is how far ``a``'s content sits ahead of ``b``'s:
    ``phase_correlate(shifted, original)`` returns the applied shift, and
    ``models/deshake.py`` accumulates ``phase_correlate(curr, prev)`` as
    the camera translation.

    The confidence is the peak-to-sidelobe ratio ``(peak - mean) / std``
    of the correlation surface divided by ``sqrt(2 ln N)``, the expected
    maximum of N unit normals, so one threshold serves every frame size:
    genuine shifts score above about 1.6, flat frames and most scene cuts
    below; callers gate at 1.5.

    ``whiten_reg`` regularises the whitening: each bin's unit phase vector
    is scaled by ``m / (m + whiten_reg * mean(m))`` with ``m`` the
    cross-spectrum magnitude, so the phase-noise-only bins between the
    harmonics of narrowband content do not outvote the signal."""
    h, w = a.shape
    win = _hann_window(h, w, a.device)
    fa = torch.fft.rfft2(a.to(torch.float32) * win)
    fb = torch.fft.rfft2(b.to(torch.float32) * win)
    cross = fa * torch.conj(fb)
    m = torch.abs(cross)
    weight = m / (m + whiten_reg * m.mean()) if whiten_reg > 0 else 1.0
    cross = cross / (m + 1e-9) * weight
    corr = torch.fft.irfft2(cross, s=(h, w))

    idx = torch.argmax(corr).reshape(1)
    py = idx // w
    px = idx % w

    # The peak's row, column and neighbours are picked with index tensors:
    # indexing with a 0-d tensor would read it on the host, one device
    # sync each.
    def subpixel(c, p, n):
        lo = c[(p - 1) % n]
        hi = c[(p + 1) % n]
        mid = c[p]
        denom = lo - 2 * mid + hi
        off = torch.where(denom.abs() > 1e-9, 0.5 * (lo - hi) / denom, 0.0)
        return off.clamp(-0.5, 0.5)

    oy = subpixel(corr.index_select(1, px)[:, 0], py, h)
    ox = subpixel(corr.index_select(0, py)[0], px, w)
    fy = py.to(torch.float32) + oy
    fx = px.to(torch.float32) + ox
    # wrap to signed shifts
    dy = torch.where(fy > h / 2, fy - h, fy)
    dx = torch.where(fx > w / 2, fx - w, fx)
    peak = corr.reshape(-1)[idx]
    psr = (peak - corr.mean()) / (corr.std(unbiased=False) + 1e-12)
    conf = psr / math.sqrt(2.0 * math.log(h * w))
    return torch.cat([dx, dy]), conf[0]
