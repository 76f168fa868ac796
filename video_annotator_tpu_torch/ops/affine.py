"""2D similarity estimation and warping.

Port of ``video_annotator_tpu/ops/affine.py``, the support ops of the
vidstab-family stabiliser. A similarity is four parameters ``(dx, dy,
angle, log_scale)``; estimation is a robust weighted least-squares fit
over tracked point pairs (IRLS with a hard residual cutoff and a fixed
iteration count), and :func:`warp_similarity` resamples through the
similarity with a sampler of ``ops/warp_plain.py`` (bilinear, or the
4-tap bicubic or lanczos: ``--interp``). It is the
plain version of the similarity warp: on a card the family warps through
kernel K1 over identity pinhole cameras instead
(``models/similarity.py::SimilarityWarper``).

Every function takes tensors with the parameters on the last axis, so a
(T, 4) stack composes, inverts or converts in one call.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from video_annotator_tpu_torch.ops.warp_plain import sample


def fit_similarity(pts_prev: torch.Tensor, pts_curr: torch.Tensor,
                   valid: torch.Tensor, irls_iters: int = 4,
                   inlier_px: float = 4.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Robust similarity ``p_curr ~= s R p_prev + t`` over (N, 2) points.

    Returns ``(params (4,), num_inliers)``."""
    pts_prev = pts_prev.to(torch.float32)
    pts_curr = pts_curr.to(torch.float32)
    valid_f = valid.to(torch.float32)

    def solve(w):
        wsum = w.sum() + 1e-6
        mp = (pts_prev * w[:, None]).sum(0) / wsum
        mc = (pts_curr * w[:, None]).sum(0) / wsum
        p = pts_prev - mp
        c = pts_curr - mc
        # complex-number form of the 2D similarity least-squares solution
        num_re = (w * (p[:, 0] * c[:, 0] + p[:, 1] * c[:, 1])).sum()
        num_im = (w * (p[:, 0] * c[:, 1] - p[:, 1] * c[:, 0])).sum()
        den = (w * (p[:, 0] ** 2 + p[:, 1] ** 2)).sum() + 1e-9
        a = num_re / den  # s cos
        b = num_im / den  # s sin
        s = torch.sqrt(a * a + b * b)
        ang = torch.atan2(b, a)
        ca, sa = torch.cos(ang), torch.sin(ang)
        tx = mc[0] - s * (ca * mp[0] - sa * mp[1])
        ty = mc[1] - s * (sa * mp[0] + ca * mp[1])
        return torch.stack([tx, ty, ang, torch.log(torch.clamp(s, min=1e-6))])

    def residuals(params):
        dx, dy, ang, ls = params.unbind(0)
        s = torch.exp(ls)
        ca, sa = torch.cos(ang), torch.sin(ang)
        px = s * (ca * pts_prev[:, 0] - sa * pts_prev[:, 1]) + dx
        py = s * (sa * pts_prev[:, 0] + ca * pts_prev[:, 1]) + dy
        return torch.sqrt((px - pts_curr[:, 0]) ** 2
                          + (py - pts_curr[:, 1]) ** 2 + 1e-12)

    params = solve(valid_f)
    for _ in range(irls_iters):
        params = solve(valid_f * (residuals(params) < inlier_px).to(torch.float32))
    inliers = (valid.to(torch.bool) & (residuals(params) < inlier_px)).sum()
    return params, inliers.to(torch.int32)


def compose_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Parameters of transform A after B (A o B), both (..., 4)."""
    dxa, dya, anga, lsa = a.unbind(-1)
    dxb, dyb, angb, lsb = b.unbind(-1)
    s = torch.exp(lsa)
    ca, sa = torch.cos(anga), torch.sin(anga)
    dx = s * (ca * dxb - sa * dyb) + dxa
    dy = s * (sa * dxb + ca * dyb) + dya
    return torch.stack([dx, dy, anga + angb, lsa + lsb], dim=-1)


def invert_similarity(p: torch.Tensor) -> torch.Tensor:
    dx, dy, ang, ls = p.unbind(-1)
    si = torch.exp(-ls)
    ca, sa = torch.cos(-ang), torch.sin(-ang)
    ndx = -si * (ca * dx - sa * dy)
    ndy = -si * (sa * dx + ca * dy)
    return torch.stack([ndx, ndy, -ang, -ls], dim=-1)


def similarity_matrix(params: torch.Tensor) -> torch.Tensor:
    """(..., 4) ``(dx, dy, angle, log_scale)`` -> (..., 3, 3) homogeneous
    pixel matrices.

    ``M @ (x, y, 1)`` equals the source coordinates :func:`warp_similarity`
    samples, which lets the similarity family ride the rotation family's
    warp kernel: over identity pinhole cameras (f = 1, c = 0) the kernel
    computes exactly ``M @ (x, y, 1)`` with a perspective divide by the
    constant 1."""
    dx, dy, ang, ls = params.unbind(-1)
    s = torch.exp(ls)
    ca, sa = s * torch.cos(ang), s * torch.sin(ang)
    z = torch.zeros_like(dx)
    o = torch.ones_like(dx)
    return torch.stack([
        torch.stack([ca, -sa, dx], dim=-1),
        torch.stack([sa, ca, dy], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ], dim=-2)


def warp_similarity(image: torch.Tensor, params: torch.Tensor,
                    out_size: Optional[Tuple[int, int]] = None,
                    interp: str = "bilinear") -> torch.Tensor:
    """Resample (H, W) ``image`` through the similarity ``params``.

    ``params`` is the SAMPLING transform (output pixels to source pixels):
    to stabilise, callers pass the inverse of the estimated prev-to-curr
    motion (``models/similarity.py`` composes and inverts before calling).
    Passing a forward motion warps the frame the wrong way.
    ``interp='bicubic'`` is the reference's vidstabtransform call
    (``interpol: "bicubic"``)."""
    h, w = image.shape if out_size is None else out_size
    dev = image.device
    dx, dy, ang, ls = params.to(device=dev, dtype=torch.float32).unbind(-1)
    s = torch.exp(ls)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    ca, sa = torch.cos(ang), torch.sin(ang)
    sx = s * (ca * xs - sa * ys) + dx
    sy = s * (sa * xs + ca * ys) + dy
    return sample(image, torch.stack([sx, sy], dim=-1), interp)
