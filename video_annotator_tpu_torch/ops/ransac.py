"""Robust camera-rotation estimation from tracked ray pairs, batched.

Port of ``video_annotator_tpu/ops/ransac.py``: hypotheses from 2-point
minimal samples solved in closed form (TRIAD), scored by angular error
against every valid pair, the best refined twice by weighted Kabsch on
its running inlier set (the fixed-iteration q-method of
:func:`so3.rotation_from_correlation`). Every tensor carries a leading
batch axis B (one entry per frame pair).

Hypothesis sampling: valid indices are ordered first (stable), then each
hypothesis draws two distinct uniform indices into that prefix. The JAX
package draws them from threefry keys; the port draws them from a
``torch.Generator`` or takes them precomputed (``pairs``), so a test can
feed both implementations the same samples.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from video_annotator_tpu_torch import so3

NUM_HYPOTHESES = 100
DEFAULT_REPROJ_PX = 8.0
MIN_INLIERS = 40


@dataclasses.dataclass
class RotationEstimate:
    rotation: torch.Tensor  # (B, 3, 3) R with q ~= R p
    num_inliers: torch.Tensor  # (B,) int32
    inliers: torch.Tensor  # (B, N) bool


def sample_pairs(valid: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """(B, H, 2) point-index pairs from (B, H, 2) uniforms in [0, 1):
    i uniform over the v valid points, j uniform over the other v - 1."""
    order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
    v = valid.sum(dim=-1).clamp(min=2)[:, None]
    i = torch.minimum((uniforms[..., 0] * v).to(torch.int64), v - 1)
    j = torch.minimum((uniforms[..., 1] * (v - 1)).to(torch.int64), v - 2)
    j = torch.where(j >= i, j + 1, j)
    return torch.stack([torch.gather(order, 1, i), torch.gather(order, 1, j)],
                       dim=-1)


def _frame(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    e1 = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-9)
    c = torch.linalg.cross(a, b, dim=-1)
    e2 = c / (torch.linalg.vector_norm(c, dim=-1, keepdim=True) + 1e-9)
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    return torch.stack([e1, e2, e3], dim=-1)  # columns


def _triad(p1, p2, q1, q2) -> torch.Tensor:
    """Closed-form rotation taking ray pair (p1, p2) to (q1, q2)."""
    return so3.matmul(_frame(q1, q2), so3.transpose(_frame(p1, p2)))


def _apply(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """R (..., 3, 3) applied to points p (..., N, 3)."""
    return (R[..., None, :, :] * p[..., :, None, :]).sum(dim=-1)


def estimate_rotation(rays_prev: torch.Tensor, rays_curr: torch.Tensor,
                      valid: torch.Tensor, threshold_rad: float = 0.01,
                      pairs: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      num_hypotheses: int = NUM_HYPOTHESES) -> RotationEstimate:
    """RANSAC + Kabsch rotation between (B, N, 3) ray bundles.

    ``pairs`` (B, H, 2) fixes the hypotheses' samples; otherwise they come
    from ``generator`` (default: torch's global generator)."""
    dev = rays_prev.device
    p = rays_prev / (torch.linalg.vector_norm(rays_prev, dim=-1, keepdim=True) + 1e-9)
    q = rays_curr / (torch.linalg.vector_norm(rays_curr, dim=-1, keepdim=True) + 1e-9)
    if pairs is None:
        gdev = generator.device if generator is not None else "cpu"
        uniforms = torch.rand((p.shape[0], num_hypotheses, 2),
                              generator=generator, device=gdev)
        pairs = sample_pairs(valid.to(gdev), uniforms)
    pairs = pairs.to(dev)

    def take(x, idx):
        return torch.gather(x, 1, idx[..., None].expand(*idx.shape, 3))

    Rs = _triad(take(p, pairs[..., 0]), take(p, pairs[..., 1]),
                take(q, pairs[..., 0]), take(q, pairs[..., 1]))  # (B, H, 3, 3)

    def inliers_of(R):  # R (B, [H,] 3, 3)
        pp = p if R.dim() == 3 else p[:, None]
        qq = q if R.dim() == 3 else q[:, None]
        vv = valid if R.dim() == 3 else valid[:, None]
        err = torch.linalg.vector_norm(qq - _apply(R, pp), dim=-1)
        return (err < threshold_rad) & vv

    inliers = inliers_of(Rs)  # (B, H, N)
    best = torch.argmax(inliers.sum(dim=-1), dim=-1)  # first maximum
    rows = torch.arange(p.shape[0], device=dev)
    R = Rs[rows, best]
    inl = inliers[rows, best]
    for _ in range(2):
        w = inl.to(torch.float32)
        B = (q[..., :, None] * p[..., None, :] * w[..., None, None]).sum(dim=1)
        R_ref = so3.rotation_from_correlation(B)
        R = torch.where((w.sum(dim=-1) >= 2)[:, None, None], R_ref, R)
        inl = inliers_of(R)
    return RotationEstimate(rotation=R,
                            num_inliers=inl.sum(dim=-1).to(torch.int32),
                            inliers=inl)


def rotation_with_fallback(estimate: RotationEstimate,
                           previous_rotation: torch.Tensor,
                           min_inliers: int = MIN_INLIERS) -> torch.Tensor:
    """The reference's quality gate: an estimate with fewer than
    ``min_inliers`` inliers is distrusted and the previous frame-to-frame
    rotation reused. (B, 3, 3), from (B,) counts and (B or 1, 3, 3)
    previous rotations."""
    ok = (estimate.num_inliers >= min_inliers)[:, None, None]
    return torch.where(ok, estimate.rotation, previous_rotation)
