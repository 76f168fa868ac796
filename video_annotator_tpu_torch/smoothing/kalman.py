"""Kalman trajectory smoothing: a constant-velocity filter per component.

Port of ``video_annotator_tpu/smoothing/kalman.py``: each rotation-vector
component of the camera trajectory runs through an (angle, angular
velocity) filter with the reference's parameters (process noise 1e-5,
measurement noise 1e-1, ``F = [[1, 1], [0, 1]]``, ``H = [1, 0]``), with
an optional backward Rauch-Tung-Striebel pass for zero phase lag. The
JAX package's ``lax.scan``s are Python loops over T here, in float32,
with the components batched along a trailing axis.

The filter is a chain of 2x2 products per frame: on a card each would be
its own launch, so callers run it on host tensors (a T x 3 x 3 copy each
way) -- see ``pipeline/render.py::make_window_corrections``.
"""

from __future__ import annotations

import math

import torch

from video_annotator_tpu_torch import so3


def kalman_filter_1d(z: torch.Tensor, process_noise: float = 1e-5,
                     measurement_noise: float = 1e-1,
                     rts: bool = True) -> torch.Tensor:
    """Constant-velocity Kalman filter (optionally RTS-smoothed) of
    measurements ``z`` (T,) or (T, B), one independent filter per column.

    State x = (value, velocity), started at (z[0], 0) with P = I."""
    squeeze = z.dim() == 1
    z = (z[:, None] if squeeze else z).to(torch.float32)
    t_len, b = z.shape
    dev = z.device
    F = torch.tensor([[1.0, 1.0], [0.0, 1.0]], device=dev)
    Q = torch.eye(2, device=dev) * process_noise
    eye = torch.eye(2, device=dev)

    x = torch.stack([z[0], torch.zeros_like(z[0])], dim=-1)  # (B, 2)
    P = eye.expand(b, 2, 2)
    xs, Ps, xps, Pps = [], [], [], []
    for t in range(t_len):
        xp = (F @ x[..., None])[..., 0]
        Pp = F @ P @ F.T + Q
        s = Pp[:, 0, 0] + measurement_noise
        k = Pp[:, :, 0] / s[:, None]  # (B, 2): Pp H^T / S
        x = xp + k * (z[t] - xp[:, 0])[:, None]
        kh = torch.stack([k, torch.zeros_like(k)], dim=-1)  # K H
        P = (eye - kh) @ Pp
        xs.append(x)
        Ps.append(P)
        xps.append(xp)
        Pps.append(Pp)
    if not rts:
        out = torch.stack([x_[:, 0] for x_ in xs])
        return out[:, 0] if squeeze else out

    # Backward RTS pass: element t uses the prediction made at t + 1.
    smooth = [xs[-1]]
    for t in range(t_len - 2, -1, -1):
        C = Ps[t] @ F.T @ torch.linalg.inv(Pps[t + 1])
        smooth.append(xs[t] + (C @ (smooth[-1] - xps[t + 1])[..., None])[..., 0])
    out = torch.stack([x_[:, 0] for x_ in reversed(smooth)])
    return out[:, 0] if squeeze else out


def unwrap_rotvecs(w: torch.Tensor) -> torch.Tensor:
    """Lift (T, 3) log-map vectors onto one continuous branch.

    ``so3.log`` returns angles in [0, pi] with axis flips at the boundary,
    so a trajectory crossing pi jumps by about 2 pi. Every representation
    of a rotation is w + 2 pi k axis: per frame, take the one nearest the
    previous (already continuous) frame, with k centred on the previous
    frame's projection onto the axis so that unbounded turns unwrap too."""
    w = w.to(torch.float32)
    rel_ks = torch.arange(-1.0, 2.0, device=w.device)[:, None]  # (3, 1)
    prev = w[0]
    out = []
    for wt in w:
        theta = torch.linalg.vector_norm(wt)
        axis = torch.where(
            theta > 1e-6, wt / torch.clamp(theta, min=1e-6),
            prev / torch.clamp(torch.linalg.vector_norm(prev), min=1e-6))
        k0 = torch.round(((prev * axis).sum() - theta) / (2.0 * math.pi))
        cands = wt[None, :] + 2.0 * math.pi * (k0 + rel_ks) * axis[None, :]
        d = ((cands - prev[None, :]) ** 2).sum(dim=1)
        prev = cands[torch.argmin(d)]
        out.append(prev)
    return torch.stack(out)


def smooth_rotations_kalman(rotations: torch.Tensor, process_noise: float = 1e-5,
                            measurement_noise: float = 1e-1,
                            rts: bool = True) -> torch.Tensor:
    """(T, 3, 3) rotations -> Kalman-smoothed (T, 3, 3): log-map, unwrap
    onto one branch, filter the 3 components, exp back."""
    w = unwrap_rotvecs(so3.log(rotations))
    return so3.exp(kalman_filter_1d(w, process_noise, measurement_noise, rts=rts))
