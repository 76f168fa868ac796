"""The fused warp (kernel K1, ``csrc/warp.cu``) in its three modes.

Port of the TPU warp's entry points in
``video_annotator_tpu/ops/warp_pallas.py``:

- :func:`warp_yuv_batch`: a frame batch to uint8 with per-frame 3x3
  matrices, ``warp_yuv_batch_pallas`` (:2244) and the two kernels that
  ``_build_warp_yuv_batch_fn`` (:2141) launches for it: the uint8 luma
  warp (``call_y``, border 0) and the two-plane chroma warp (``call_c``,
  border 128);
- :func:`warp_yuv`: one frame to uint8 with one 3x3 matrix,
  ``warp_yuv_pallas`` and the two kernels of ``_build_warp_yuv_fn``
  (:2041, :2066), the compare grid's path for a similarity cell;
- :func:`warp_frame_f32`: one float plane to float32, not rounded,
  ``warp_frame_pallas`` (``_build_warp_fn``, :1803);
- :func:`warp_planes_f32`: up to four float planes of one frame sharing
  one map, ``warp_planes_pallas`` (``_build_warp_planes_fn``, :1957).

The float entries sample the float source as it is, like the XLA oracle;
the TPU kernel rounded it to bytes while packing (``_pack_input``,
:1737). On integer-valued planes, which is what the callers pass, the
two agree.

The TPU's window planning (``plan_warp``, ``WarpPlan``, ``_tile_origins``,
``warp_scratch_shapes``) sized VMEM windows and is not carried over: the
CUDA kernel reads the source planes straight from device memory.

On CPU tensors each entry runs its plain version
(:func:`warp_planes_u8_plain`, :func:`warp_planes_f32_plain`), the XLA
oracle's semantics (``ops/warp_plain.py``); on CUDA tensors it launches
the kernel or raises. Every kernel object counts its own launches.
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

_SOURCE = "video_annotator_tpu_torch/csrc/warp.cu"
_PALLAS = "video_annotator_tpu/ops/warp_pallas.py"
_CAMERA_ARGTYPES = [ctypes.c_float] * 12 + [ctypes.c_int, ctypes.c_float]
_U8_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + _CAMERA_ARGTYPES
_F32_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + _CAMERA_ARGTYPES


def _kernel(name: str, symbol: str, argtypes, line: int) -> cuda_lib.CudaKernel:
    return cuda_lib.CudaKernel(name, symbol, argtypes, source=_SOURCE,
                               replaces=f"{_PALLAS}:{line}")


WARP_LUMA = _kernel("warp_luma", "vat_warp_u8", _U8_ARGTYPES, 2168)  # call_y
WARP_CHROMA = _kernel("warp_chroma", "vat_warp_u8", _U8_ARGTYPES, 2192)  # call_c
# _build_warp_fn and _build_warp_planes_fn
WARP_FRAME_F32 = _kernel("warp_frame_f32", "vat_warp_f32", _F32_ARGTYPES, 1803)
WARP_PLANES_F32 = _kernel("warp_planes_f32", "vat_warp_f32", _F32_ARGTYPES, 1957)
# _build_warp_yuv_fn: the one-frame luma and chroma launches
WARP_YUV_LUMA = _kernel("warp_yuv_luma", "vat_warp_u8", _U8_ARGTYPES, 2041)
WARP_YUV_CHROMA = _kernel("warp_yuv_chroma", "vat_warp_u8", _U8_ARGTYPES, 2066)
BATCH_KERNELS = (WARP_LUMA, WARP_CHROMA)
ONE_FRAME_KERNELS = (WARP_YUV_LUMA, WARP_YUV_CHROMA)

MAX_F32_PLANES = 4


def to_u8(x: torch.Tensor) -> torch.Tensor:
    """Round half to even and clamp to uint8, as K1's uint8 mode does."""
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def _check_cameras(out_camera: Camera, in_camera: Camera) -> None:
    if out_camera.model != CameraModel.RECTILINEAR or in_camera.model not in (
            CameraModel.RECTILINEAR, CameraModel.FISHEYE):
        raise NotImplementedError(
            "the warp kernel takes a rectilinear output and a fisheye or "
            "rectilinear input (other projections: ROADMAP.md)")


def _camera_args(out_camera: Camera, in_camera: Camera, border: float):
    o, i = out_camera, in_camera
    return (o.fx, o.fy, o.cx, o.cy, i.fx, i.fy, i.cx, i.cy, *i.dist,
            int(i.model == CameraModel.FISHEYE), float(border))


def warp_planes_f32_plain(src: torch.Tensor, rotation: torch.Tensor,
                          out_camera: Camera, in_camera: Camera,
                          out_size: Tuple[int, int],
                          border: float = 0.0) -> torch.Tensor:
    """Plain torch version of K1's float mode: (P, H, W) float planes of
    one frame, one (3, 3) matrix -> (P, out_h, out_w) float32, neither
    rounded nor clamped, sampled centred on ``border``."""
    coords = compute_warp_map(out_camera, in_camera, rotation, out_size)
    return torch.stack([
        bilinear_sample(plane.to(torch.float32) - border, coords) + border
        for plane in src
    ])


def warp_planes_u8_plain(src: torch.Tensor, rotations: torch.Tensor,
                         out_camera: Camera, in_camera: Camera,
                         out_size: Tuple[int, int],
                         border: float = 0.0) -> torch.Tensor:
    """Plain torch version of K1's uint8 mode: (T, P, H, W) uint8 planes,
    (T, 3, 3) matrices -> (T, P, out_h, out_w) uint8, one map per frame
    shared by its P planes, rounded half to even."""
    return torch.stack([
        to_u8(warp_planes_f32_plain(src[t], rotations[t], out_camera,
                                    in_camera, out_size, border))
        for t in range(src.shape[0])
    ])


def warp_planes_u8(src: torch.Tensor, rotations: torch.Tensor,
                   out_camera: Camera, in_camera: Camera,
                   out_size: Tuple[int, int], border: float = 0.0,
                   kernels=BATCH_KERNELS) -> torch.Tensor:
    """Warp (T, P, H, W) uint8 planes (P = 1 luma, P = 2 chroma) by
    per-frame (T, 3, 3) matrices applied to output rays. ``kernels`` is
    the (luma, chroma) pair of kernel objects whose launch is counted:
    the batch's, or the one-frame warp's (:data:`ONE_FRAME_KERNELS`)."""
    if src.dim() != 4 or src.dtype != torch.uint8 or src.shape[1] not in (1, 2):
        raise ValueError(f"warp takes (T, 1|2, H, W) uint8, got "
                         f"{tuple(src.shape)} {src.dtype}")
    if rotations.shape != (src.shape[0], 3, 3):
        raise ValueError(f"rotations must be ({src.shape[0]}, 3, 3), got "
                         f"{tuple(rotations.shape)}")
    _check_cameras(out_camera, in_camera)
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
    kernels[planes - 1].launch(
        cuda_lib.ptr(src), cuda_lib.ptr(out), cuda_lib.ptr(rotations),
        t, planes, in_h, in_w, out_h, out_w,
        *_camera_args(out_camera, in_camera, border))
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


def warp_yuv(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
             rotation: torch.Tensor, out_camera: Camera, in_camera: Camera,
             out_camera_c: Camera, in_camera_c: Camera,
             out_size: Tuple[int, int]):
    """Warp ONE frame's (H, W) luma and (H/2, W/2) chroma uint8 planes by
    one (3, 3) matrix: a luma launch and a two-plane chroma launch of
    K1's uint8 mode with T = 1. Returns uint8 ``(wy, wu, wv)``."""
    if rotation.shape != (3, 3):
        raise ValueError(f"warp_yuv takes one (3, 3) matrix, got "
                         f"{tuple(rotation.shape)}")
    oh, ow = out_size
    rots = rotation[None]
    wy = warp_planes_u8(y[None, None], rots, out_camera, in_camera, (oh, ow),
                        border=0.0, kernels=ONE_FRAME_KERNELS)
    wc = warp_planes_u8(torch.stack([u, v])[None], rots, out_camera_c, in_camera_c,
                        (oh // 2, ow // 2), border=128.0, kernels=ONE_FRAME_KERNELS)
    return wy[0, 0], wc[0, 0], wc[0, 1]


def _warp_f32(src: torch.Tensor, rotation: torch.Tensor, out_camera: Camera,
              in_camera: Camera, out_size: Tuple[int, int], border: float,
              kernel: cuda_lib.CudaKernel) -> torch.Tensor:
    if (src.dim() != 3 or src.dtype != torch.float32
            or not 1 <= src.shape[0] <= MAX_F32_PLANES):
        raise ValueError(f"the float warp takes (1..{MAX_F32_PLANES}, H, W) "
                         f"float32, got {tuple(src.shape)} {src.dtype}")
    if rotation.shape != (3, 3):
        raise ValueError(f"the float warp takes one (3, 3) matrix, got "
                         f"{tuple(rotation.shape)}")
    _check_cameras(out_camera, in_camera)
    rotation = rotation.to(device=src.device, dtype=torch.float32)
    if src.device.type == "cpu":
        return warp_planes_f32_plain(src, rotation, out_camera, in_camera,
                                     out_size, border)
    cuda_lib.check_cuda(src)
    src = src.contiguous()
    rotation = rotation.contiguous()
    planes, in_h, in_w = src.shape
    out_h, out_w = out_size
    out = torch.empty((planes, out_h, out_w), dtype=torch.float32,
                      device=src.device)
    cuda_lib.check_operands(src, rotation, out)
    kernel.launch(
        cuda_lib.ptr(src), cuda_lib.ptr(out), cuda_lib.ptr(rotation),
        planes, in_h, in_w, out_h, out_w,
        *_camera_args(out_camera, in_camera, border))
    return out


def warp_frame_f32(image: torch.Tensor, rotation: torch.Tensor,
                   out_camera: Camera, in_camera: Camera,
                   out_size: Tuple[int, int], border: float = 0.0) -> torch.Tensor:
    """Warp one (H, W) float32 plane by one (3, 3) matrix to a float32
    (out_h, out_w) plane, neither rounded nor clamped."""
    if image.dim() != 2:
        raise ValueError(f"warp_frame_f32 takes one (H, W) plane, got "
                         f"{tuple(image.shape)}")
    return _warp_f32(image[None], rotation, out_camera, in_camera, out_size,
                     border, WARP_FRAME_F32)[0]


def warp_planes_f32(planes: torch.Tensor, rotation: torch.Tensor,
                    out_camera: Camera, in_camera: Camera,
                    out_size: Tuple[int, int], border: float = 0.0) -> torch.Tensor:
    """Warp (P, H, W) float32 planes of one frame (P up to 4; U and V with
    border 128) through ONE map in one launch; (P, out_h, out_w) float32."""
    return _warp_f32(planes, rotation, out_camera, in_camera, out_size,
                     border, WARP_PLANES_F32)
