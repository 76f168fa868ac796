"""SO(3) utilities on torch tensors.

Port of ``video_annotator_tpu/so3.py``: exp/log maps, hat/vee, Shepperd
quaternions, the one-step Newton-Schulz re-orthonormalization, the polar
projection and the fixed-iteration Davenport q-method used by RANSAC's
refinement. Every function takes float32 tensors with arbitrary leading
batch dimensions and runs on whatever device its inputs live on; the
q-method runs as one CUDA kernel on a CUDA tensor (``csrc/wahba.cu``).

Small 3x3 products are written as explicit sums of elementwise products
(``matmul``) rather than ``torch.matmul``: the results are then the same
full-float32 arithmetic on every device, independent of any TF32 setting.
"""

from __future__ import annotations

import ctypes
import math

import torch

from video_annotator_tpu_torch.ops import cuda_lib

_EPS = 1e-8

WAHBA = cuda_lib.CudaKernel(
    "wahba", "vat_wahba",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int],
    source="video_annotator_tpu_torch/csrc/wahba.cu",
    replaces="video_annotator_tpu/so3.py:174",  # plain XLA's power loop; no Pallas kernel
)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (..., 3, 3) x (..., 3, 3) product in full float32."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def transpose(m: torch.Tensor) -> torch.Tensor:
    return m.transpose(-1, -2)


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a (..., 3) vector."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(m: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat` for a (..., 3, 3) skew-symmetric matrix."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def exp(w: torch.Tensor) -> torch.Tensor:
    """Rotation vector (..., 3) -> rotation matrix (..., 3, 3) (Rodrigues)."""
    theta2 = (w * w).sum(dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    big = theta2 > _EPS
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(
        big, (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS),
        0.5 - theta2 / 24.0,
    )
    W = hat(w)
    # W^2 = w w^T - theta^2 I, exact elementwise.
    outer = w[..., :, None] * w[..., None, :]
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    W2 = outer - theta2[..., None, None] * eye
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (w, x, y, z), w >= 0.

    Shepperd's method: all four candidates, pick the largest pivot."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11], dim=-1)
    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22,
         1.0 + m22 - m00 - m11],
        dim=-1,
    )
    k = torch.argmax(pivots, dim=-1)
    cand = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 candidates, 4)
    idx = k[..., None, None].expand(*k.shape, 1, 4)
    q = torch.gather(cand, -2, idx)[..., 0, :]
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> rotation vector (..., 3)."""
    q = to_quaternion(R)
    qw = q[..., 0]
    qv = q[..., 1:]
    sin_half = torch.linalg.vector_norm(qv, dim=-1)
    theta = 2.0 * torch.atan2(sin_half, qw)
    scale = torch.where(
        sin_half > 1e-6,
        theta / torch.clamp(sin_half, min=1e-6),
        2.0 / torch.clamp(qw, min=_EPS),
    )
    return qv * scale[..., None]


def slerp(R0: torch.Tensor, R1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Geodesic interpolation between rotations: R0 exp(t log(R0^T R1))."""
    rel = matmul(transpose(R0), R1)
    return matmul(R0, exp(t[..., None] * log(rel)))


def orthonormalize(M: torch.Tensor) -> torch.Tensor:
    """One Newton-Schulz step toward the nearest rotation: M(3I - M^T M)/2.

    For products of rotations that drifted by float32 rounding only."""
    eye = torch.eye(3, dtype=M.dtype, device=M.device).expand(M.shape)
    return matmul(M, 3.0 * eye - matmul(transpose(M), M)) * 0.5


def project(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation to a (..., 3, 3) matrix (polar decomposition)."""
    u, _, vt = torch.linalg.svd(M)
    det = torch.linalg.det(matmul(u, vt))
    d = torch.cat([torch.ones(M.shape[:-2] + (2,), dtype=M.dtype,
                              device=M.device), det[..., None]], dim=-1)
    return matmul(u * d[..., None, :], vt)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) as (w, x, y, z) -> rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotation_from_correlation(B: torch.Tensor, iters: int = 120) -> torch.Tensor:
    """Proper rotation R maximizing tr(R B^T) (Wahba's problem) for a
    (..., 3, 3) correlation: :func:`rotation_from_correlation_plain` on a
    CPU tensor, one launch of ``csrc/wahba.cu`` (:data:`WAHBA`) on a
    float32 CUDA one (none for an empty batch)."""
    if B.device.type == "cpu":
        return rotation_from_correlation_plain(B, iters)
    cuda_lib.check_cuda(B)
    if B.dtype != torch.float32 or B.shape[-2:] != (3, 3):
        raise ValueError(f"the Wahba kernel takes (..., 3, 3) float32, got "
                         f"{tuple(B.shape)} {B.dtype}")
    B = B.contiguous()
    R = torch.empty_like(B)
    cuda_lib.check_operands(B, R)
    if R.numel():
        WAHBA.launch(cuda_lib.ptr(B), cuda_lib.ptr(R), R.numel() // 9, iters)
    return R


def rotation_from_correlation_plain(B: torch.Tensor, iters: int = 120) -> torch.Tensor:
    """Plain twin of the ``wahba`` kernel: the Davenport q-method, the
    dominant eigenvector of the 4x4 K matrix by a fixed-iteration shifted
    power method from two starts (all-ones and the one-hot Shepperd
    pivot), keeping the higher Rayleigh quotient."""
    b00, b01, b02 = B[..., 0, 0], B[..., 0, 1], B[..., 0, 2]
    b10, b11, b12 = B[..., 1, 0], B[..., 1, 1], B[..., 1, 2]
    b20, b21, b22 = B[..., 2, 0], B[..., 2, 1], B[..., 2, 2]
    tr = b00 + b11 + b22
    z1 = b21 - b12
    z2 = b02 - b20
    z3 = b10 - b01
    K = torch.stack(
        [
            torch.stack([tr, z1, z2, z3], dim=-1),
            torch.stack([z1, b00 - b11 - b22, b01 + b10, b02 + b20], dim=-1),
            torch.stack([z2, b01 + b10, b11 - b00 - b22, b12 + b21], dim=-1),
            torch.stack([z3, b02 + b20, b12 + b21, b22 - b00 - b11], dim=-1),
        ],
        dim=-2,
    )
    shift = 2.0 * torch.linalg.matrix_norm(B)[..., None, None] + 1e-6
    eye4 = torch.eye(4, dtype=B.dtype, device=B.device)
    Ks = K + shift * eye4
    # Both starts run as one batch: (..., 2, 4).
    ones = torch.ones(K.shape[:-1], dtype=B.dtype, device=B.device)
    diag = torch.diagonal(K, dim1=-2, dim2=-1)
    pivot = torch.nn.functional.one_hot(
        torch.argmax(diag, dim=-1), 4).to(B.dtype)
    v = torch.stack([ones, pivot], dim=-2)
    Ks2 = Ks[..., None, :, :]
    for _ in range(iters):
        v = (Ks2 * v[..., None, :]).sum(dim=-1)
        v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + _EPS)
    K2 = K[..., None, :, :]
    rayleigh = (v * (K2 * v[..., None, :]).sum(dim=-1)).sum(dim=-1)
    best = torch.where((rayleigh[..., 0] >= rayleigh[..., 1])[..., None],
                       v[..., 0, :], v[..., 1, :])
    return quat_to_matrix(best)


def from_euler(roll: float, pitch: float, yaw: float,
               device="cpu") -> torch.Tensor:
    """Rotation from the CLI's attitude angles (radians): Ry(yaw) Rx(pitch)
    Rz(roll), applied to camera rays."""
    cz, sz = math.cos(roll), math.sin(roll)
    cx, sx = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)

    def t(rows):
        return torch.tensor(rows, dtype=torch.float32, device=device)

    rz = t([[cz, -sz, 0.0], [sz, cz, 0.0], [0.0, 0.0, 1.0]])
    rx = t([[1.0, 0.0, 0.0], [0.0, cx, -sx], [0.0, sx, cx]])
    ry = t([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
    return matmul(ry, matmul(rx, rz))
