"""Fused YUV warp of a frame batch to uint8 (kernel K1, ``csrc/warp.cu``).

Port of the encode path's TPU warp, ``warp_yuv_batch_pallas``
(``video_annotator_tpu/ops/warp_pallas.py:2244``) and the two kernels its
builder ``_build_warp_yuv_batch_fn`` (:2141) launches per frame: the
uint8 luma warp (``call_y``, border 0) and the two-plane chroma warp
(``call_c``, border 128). The TPU's window planning (``plan_warp``,
``WarpPlan``, ``_tile_origins``, ``warp_scratch_shapes``) sized VMEM
windows and is not carried over: the CUDA kernel reads the source planes
straight from device memory.

On CPU tensors :func:`warp_planes_u8` runs :func:`warp_planes_u8_plain`,
the XLA oracle's semantics (``ops/warp_plain.py``) rounded half to even;
on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from video_annotator_tpu_torch.camera import Camera, CameraModel
from video_annotator_tpu_torch.ops import cuda_lib
from video_annotator_tpu_torch.ops.warp_plain import (
    bilinear_sample,
    compute_warp_map,
)

_WARP_ARGTYPES = (
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float] * 12
    + [ctypes.c_int, ctypes.c_float]
)
WARP_LUMA = cuda_lib.CudaKernel(
    "warp_luma", "vat_warp_u8", _WARP_ARGTYPES,
    source="video_annotator_tpu_torch/csrc/warp.cu",
    replaces="video_annotator_tpu/ops/warp_pallas.py:2168",  # call_y
)
WARP_CHROMA = cuda_lib.CudaKernel(
    "warp_chroma", "vat_warp_u8", _WARP_ARGTYPES,
    source="video_annotator_tpu_torch/csrc/warp.cu",
    replaces="video_annotator_tpu/ops/warp_pallas.py:2192",  # call_c
)


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def warp_planes_u8_plain(src: torch.Tensor, rotations: torch.Tensor,
                         out_camera: Camera, in_camera: Camera,
                         out_size: Tuple[int, int],
                         border: float = 0.0) -> torch.Tensor:
    """Plain torch version of K1: (T, P, H, W) uint8 planes, (T, 3, 3)
    rotations -> (T, P, out_h, out_w) uint8, one map per frame shared by
    its P planes."""
    out = []
    for t in range(src.shape[0]):
        coords = compute_warp_map(out_camera, in_camera, rotations[t], out_size)
        out.append(torch.stack([
            _to_u8(bilinear_sample(src[t, p].to(torch.float32) - border,
                                   coords) + border)
            for p in range(src.shape[1])
        ]))
    return torch.stack(out)


def warp_planes_u8(src: torch.Tensor, rotations: torch.Tensor,
                   out_camera: Camera, in_camera: Camera,
                   out_size: Tuple[int, int],
                   border: float = 0.0) -> torch.Tensor:
    """Warp (T, P, H, W) uint8 planes (P = 1 luma, P = 2 chroma) by
    per-frame (T, 3, 3) rotations applied to output rays."""
    if src.dim() != 4 or src.dtype != torch.uint8 or src.shape[1] not in (1, 2):
        raise ValueError(f"warp takes (T, 1|2, H, W) uint8, got "
                         f"{tuple(src.shape)} {src.dtype}")
    if rotations.shape != (src.shape[0], 3, 3):
        raise ValueError(f"rotations must be ({src.shape[0]}, 3, 3), got "
                         f"{tuple(rotations.shape)}")
    if out_camera.model != CameraModel.RECTILINEAR or in_camera.model not in (
            CameraModel.RECTILINEAR, CameraModel.FISHEYE):
        raise NotImplementedError(
            "the warp kernel takes a rectilinear output and a fisheye or "
            "rectilinear input (other projections: ROADMAP.md)")
    rotations = rotations.to(device=src.device, dtype=torch.float32)
    if src.device.type == "cpu":
        return warp_planes_u8_plain(src, rotations, out_camera, in_camera,
                                    out_size, border)
    cuda_lib.check_cuda(src)
    src = src.contiguous()
    rotations = rotations.contiguous()
    t, planes, in_h, in_w = src.shape
    out_h, out_w = out_size
    out = torch.empty((t, planes, out_h, out_w), dtype=torch.uint8,
                      device=src.device)
    cuda_lib.check_operands(src, rotations, out)
    kernel = WARP_LUMA if planes == 1 else WARP_CHROMA
    o, i = out_camera, in_camera
    kernel.launch(
        cuda_lib.ptr(src), cuda_lib.ptr(out), cuda_lib.ptr(rotations),
        t, planes, in_h, in_w, out_h, out_w,
        o.fx, o.fy, o.cx, o.cy, i.fx, i.fy, i.cx, i.cy, *i.dist,
        int(i.model == CameraModel.FISHEYE), float(border),
    )
    return out


def warp_yuv_batch(ys: torch.Tensor, us: torch.Tensor, vs: torch.Tensor,
                   rotations: torch.Tensor, out_camera: Camera,
                   in_camera: Camera, out_camera_c: Camera,
                   in_camera_c: Camera, out_size: Tuple[int, int]):
    """Warp a (T, H, W) luma stack and its (T, H/2, W/2) chroma stacks.

    Returns ``(wy, wu, wv)``: (T, out_h, out_w) and two
    (T, out_h/2, out_w/2) uint8 stacks. Luma warps with border 0, chroma
    with the neutral 128, both planes of a frame sharing one map."""
    oh, ow = out_size
    wy = warp_planes_u8(ys[:, None], rotations, out_camera, in_camera,
                        (oh, ow), border=0.0)[:, 0]
    wc = warp_planes_u8(torch.stack([us, vs], dim=1), rotations, out_camera_c,
                        in_camera_c, (oh // 2, ow // 2), border=128.0)
    return wy, wc[:, 0], wc[:, 1]
