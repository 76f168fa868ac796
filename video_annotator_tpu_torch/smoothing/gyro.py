"""GPMF gyro integration: IMU angular rates -> per-frame camera rotations.

Port of ``video_annotator_tpu/smoothing/gyro.py``. Integrate the
angular-rate samples on SO(3) and resample the orientation trajectory at
frame timestamps, producing the same "accumulated rotation per frame" the
visual tracker estimates: the two sources share every downstream stage.

The JAX package integrates with a sequential ``lax.scan`` over the S - 1
steps. A 10-minute clip at 400 Hz has 240 000 of them, and a loop of
3x3 products (or one launch per step) is far too slow on a card. The
product of rotations is associative, so the port takes the inclusive
prefix product by doubling (:func:`prefix_products`): ceil(log2(S - 1))
passes, each one batched 3x3 product over the whole stack. The products
associate in another order than the scan's, so the two differ by float32
rounding only; the tree's error grows with log S where the scan's grows
with S (``chip_smoke.py`` prints the angle between this and a float64
scan at S = 240 000: 0.00008 degrees on an NVIDIA H100 80GB HBM3 at
700.00 W, the call taking 3.2 to 5.9 ms there, uploads included).
"""

from __future__ import annotations

import torch

from video_annotator_tpu_torch import so3


def prefix_products(steps: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products ``P[k] = steps[0] steps[1] ... steps[k]``
    of an (N, 3, 3) stack, by doubling: after the pass with stride d,
    ``P[k]`` holds the product of the (up to) 2d steps ending at k."""
    prods = steps
    d = 1
    while d < prods.shape[0]:
        prods = torch.cat([prods[:d], so3.matmul(prods[:-d], prods[d:])])
        d *= 2
    return prods


def integrate_gyro(omega: torch.Tensor, sample_ts: torch.Tensor,
                   frame_ts: torch.Tensor) -> torch.Tensor:
    """Accumulated camera rotation at each frame timestamp, (T, 3, 3).

    ``omega`` (S, 3) angular rates in rad/s (camera frame), ``sample_ts``
    (S,) and ``frame_ts`` (T,) in seconds, all float32 on one device.
    Orientation is integrated per gyro sample (R_{k+1} = R_k exp(w_k
    dt_k)) and then geodesically interpolated at frame times. The first
    frame is the identity reference, the visual tracker's convention.
    """
    dt = torch.diff(sample_ts)
    steps = so3.exp(omega[:-1] * dt[:, None])  # (S-1, 3, 3)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    # (S, 3, 3) at sample_ts. Each float32 step is a rotation to about
    # 1e-7 only, and 240 000 of them multiply to a matrix some 1e-3 from
    # orthonormal; one Newton-Schulz step brings the products back (the
    # JAX scan leaves them as they are; below 1e-5 at a minute of samples).
    rs = so3.orthonormalize(torch.cat([eye[None], prefix_products(steps)]))

    # Geodesic resample at frame timestamps.
    idx = torch.clamp(
        torch.searchsorted(sample_ts, frame_ts.contiguous(), right=True) - 1,
        0, sample_ts.shape[0] - 2)
    t0 = sample_ts[idx]
    t1 = sample_ts[idx + 1]
    alpha = torch.clamp((frame_ts - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)
    r_frames = so3.slerp(rs[idx], rs[idx + 1], alpha)

    # Rebase so the first frame is the identity.
    return so3.matmul(so3.transpose(r_frames[0])[None], r_frames)
