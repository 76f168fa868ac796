"""Savitzky-Golay smoothing weights and the entrywise trajectory filter.

Port of ``video_annotator_tpu/smoothing/savgol.py`` (``savgol_weights``,
``sg_conv``, ``smooth_rotations``): the least-squares polynomial-fit
weights over a centred window, applied to each of the 9 rotation-matrix
entries of a replicate-padded trajectory. The convolution is a sliding-window sum of
elementwise products (no cuDNN, hence no TF32), taken in float64 and
added tap by tap in a fixed order, then rounded once to float32: an
output entry has the same bits whatever the length of the block it is
computed in (a streaming batch, the whole clip, a shard).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from video_annotator_tpu_torch import so3


def savgol_weights(radius: int, order: int = 2, pos: int = 0,
                   deriv: int = 0) -> np.ndarray:
    """SG kernel over [-radius, radius] evaluated at ``pos``; (2r+1,)
    float32, index 0 = t - radius."""
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    A = np.stack([t ** k for k in range(order + 1)], axis=1)
    e = np.zeros(order + 1)
    for k in range(deriv, order + 1):
        e[k] = (math.factorial(k) / math.factorial(k - deriv)) * (
            float(pos) ** (k - deriv))
    return (e @ np.linalg.pinv(A)).astype(np.float32)


def sg_conv(padded: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(T + 2r, K) replicate-padded block, (2r + 1,) weights -> (T, K):
    ``out[t] = sum_j w[j] padded[t + j]`` (cross-correlation, like XLA's
    convolution), in float64 summed over j in order, then rounded to the
    block's type: a float32 reduction over an unfolded window sums in an
    order that depends on T."""
    x = padded.to(torch.float64)
    w = w.to(device=padded.device, dtype=torch.float64)
    t = padded.shape[0] - w.shape[0] + 1
    out = x[:t] * w[0]
    for j in range(1, w.shape[0]):
        out = out + x[j:j + t] * w[j]
    return out.to(padded.dtype)


def smooth_rotations(rotations: torch.Tensor, radius: int, order: int = 2) -> torch.Tensor:
    """(T, 3, 3) -> (T, 3, 3): both ends replicate-padded by ``radius``,
    each entry convolved with the SG kernel, each result projected back
    to SO(3)."""
    w = torch.from_numpy(savgol_weights(radius, order)).to(rotations.device)
    flat = rotations.reshape(-1, 9).to(torch.float32)
    padded = torch.cat([flat[:1].expand(radius, 9), flat, flat[-1:].expand(radius, 9)])
    return so3.project(sg_conv(padded, w).reshape(-1, 3, 3))
