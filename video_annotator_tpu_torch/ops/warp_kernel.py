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

Every entry also takes the rolling-shutter form of its rotation, one 3x3
per 8-row output tile row (``_make_kernel(rs=True)``, :925-927,
:1142-1149): a (ny, 3, 3) stack where it took one (3, 3) matrix, a
(T, ny, 3, 3) stack where it took (T, 3, 3), as the JAX entries do
(``jnp.ndim(rotation) == 3`` at :2003, :2135, :2376; ``== 4`` at :2261).
Output row ``r`` takes rotation ``min(r // 8, ny - 1)``. The chroma stack
is gathered from the luma one before the launch
(:func:`chroma_row_rotations`). These launches are counted under kernel
objects of their own (``*_rs``).

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
    num_tile_rows,
)

_SOURCE = "video_annotator_tpu_torch/csrc/warp.cu"
_PALLAS = "video_annotator_tpu/ops/warp_pallas.py"
_CAMERA_ARGTYPES = [ctypes.c_float] * 12 + [ctypes.c_int, ctypes.c_float]
_U8_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + _CAMERA_ARGTYPES
_F32_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + _CAMERA_ARGTYPES


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
# The same build functions with rs=True: the lines that make their kernels.
WARP_LUMA_RS = _kernel("warp_luma_rs", "vat_warp_u8", _U8_ARGTYPES, 2163)
WARP_CHROMA_RS = _kernel("warp_chroma_rs", "vat_warp_u8", _U8_ARGTYPES, 2187)
WARP_FRAME_F32_RS = _kernel("warp_frame_f32_rs", "vat_warp_f32", _F32_ARGTYPES, 1784)
WARP_PLANES_F32_RS = _kernel("warp_planes_f32_rs", "vat_warp_f32", _F32_ARGTYPES, 1939)
WARP_YUV_LUMA_RS = _kernel("warp_yuv_luma_rs", "vat_warp_u8", _U8_ARGTYPES, 2036)
WARP_YUV_CHROMA_RS = _kernel("warp_yuv_chroma_rs", "vat_warp_u8", _U8_ARGTYPES, 2061)
# (luma, chroma) kernel objects, by whether the rotations are per tile row.
BATCH_KERNELS = {False: (WARP_LUMA, WARP_CHROMA),
                 True: (WARP_LUMA_RS, WARP_CHROMA_RS)}
ONE_FRAME_KERNELS = {False: (WARP_YUV_LUMA, WARP_YUV_CHROMA),
                     True: (WARP_YUV_LUMA_RS, WARP_YUV_CHROMA_RS)}
FRAME_F32_KERNELS = {False: WARP_FRAME_F32, True: WARP_FRAME_F32_RS}
PLANES_F32_KERNELS = {False: WARP_PLANES_F32, True: WARP_PLANES_F32_RS}

MAX_F32_PLANES = 4


def to_u8(x: torch.Tensor) -> torch.Tensor:
    """Round half to even and clamp to uint8, as K1's uint8 mode does."""
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def chroma_row_rotations(rot_y: torch.Tensor, nyc: int) -> torch.Tensor:
    """Chroma tile-row rotations from a (..., ny, 3, 3) luma stack: chroma
    tile row j covers luma tile rows 2j and 2j + 1 and takes row 2j's
    rotation, clipped to the stack (``_chroma_row_rotations``, :2008)."""
    idx = torch.clamp(2 * torch.arange(nyc, device=rot_y.device),
                      max=rot_y.shape[-3] - 1)
    return rot_y[..., idx, :, :]


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
    one frame, one (3, 3) matrix or a (ny, 3, 3) stack -> (P, out_h,
    out_w) float32, neither rounded nor clamped, sampled centred on
    ``border``."""
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
    (T, 3, 3) matrices or a (T, ny, 3, 3) stack -> (T, P, out_h, out_w)
    uint8, one map per frame shared by its P planes, rounded half to
    even."""
    return torch.stack([
        to_u8(warp_planes_f32_plain(src[t], rotations[t], out_camera,
                                    in_camera, out_size, border))
        for t in range(src.shape[0])
    ])


def _tile_rows(rotations: torch.Tensor, lead: tuple) -> int:
    """The kernel's ``ny`` for rotations of shape ``lead + (3, 3)`` (0: one
    3x3 per frame) or ``lead + (ny, 3, 3)`` (per tile row)."""
    shape = tuple(rotations.shape)
    if shape == lead + (3, 3):
        return 0
    if (len(shape) == len(lead) + 3 and shape[:len(lead)] == lead
            and shape[-2:] == (3, 3) and shape[-3] > 0):
        return shape[-3]
    raise ValueError(f"rotations must be {lead + (3, 3)} or "
                     f"{lead + ('ny', 3, 3)}, got {shape}")


def warp_planes_u8(src: torch.Tensor, rotations: torch.Tensor,
                   out_camera: Camera, in_camera: Camera,
                   out_size: Tuple[int, int], border: float = 0.0,
                   kernels=BATCH_KERNELS) -> torch.Tensor:
    """Warp (T, P, H, W) uint8 planes (P = 1 luma, P = 2 chroma) by
    per-frame (T, 3, 3) matrices, or per-tile-row (T, ny, 3, 3) stacks,
    applied to output rays. ``kernels`` names the kernel objects whose
    launch is counted: the batch's, or the one-frame warp's
    (:data:`ONE_FRAME_KERNELS`)."""
    if src.dim() != 4 or src.dtype != torch.uint8 or src.shape[1] not in (1, 2):
        raise ValueError(f"warp takes (T, 1|2, H, W) uint8, got "
                         f"{tuple(src.shape)} {src.dtype}")
    ny = _tile_rows(rotations, lead=(src.shape[0],))
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
    kernels[ny > 0][planes - 1].launch(
        cuda_lib.ptr(src), cuda_lib.ptr(out), cuda_lib.ptr(rotations),
        t, planes, in_h, in_w, out_h, out_w, ny,
        *_camera_args(out_camera, in_camera, border))
    return out


def chroma_rotations(rotations: torch.Tensor, lead: tuple, out_h_c: int):
    """The rotations of a chroma warp to ``out_h_c`` rows from the luma
    ones of shape ``lead + (3, 3)`` or ``lead + (ny, 3, 3)`` (``lead`` is
    ``()`` for one frame, ``(T,)`` for a batch): as they are, or gathered
    per chroma tile row where they are a per-tile-row stack."""
    if _tile_rows(rotations, lead) == 0:
        return rotations
    return chroma_row_rotations(rotations, num_tile_rows(out_h_c))


def warp_yuv_batch(ys: torch.Tensor, us: torch.Tensor, vs: torch.Tensor,
                   rotations: torch.Tensor, out_camera: Camera,
                   in_camera: Camera, out_camera_c: Camera,
                   in_camera_c: Camera, out_size: Tuple[int, int]):
    """Warp a (T, H, W) luma stack and its (T, H/2, W/2) chroma stacks.

    Returns ``(wy, wu, wv)``: (T, out_h, out_w) and two
    (T, out_h/2, out_w/2) uint8 stacks. Luma warps with border 0, chroma
    with the neutral 128, both planes of a frame sharing one map.
    ``rotations`` is (T, 3, 3), or (T, ny, 3, 3) per luma tile row."""
    oh, ow = out_size
    wy = warp_planes_u8(ys[:, None], rotations, out_camera, in_camera,
                        (oh, ow), border=0.0)[:, 0]
    wc = warp_planes_u8(torch.stack([us, vs], dim=1),
                        chroma_rotations(rotations, (ys.shape[0],), oh // 2), out_camera_c,
                        in_camera_c, (oh // 2, ow // 2), border=128.0)
    return wy, wc[:, 0], wc[:, 1]


def warp_yuv(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
             rotation: torch.Tensor, out_camera: Camera, in_camera: Camera,
             out_camera_c: Camera, in_camera_c: Camera,
             out_size: Tuple[int, int]):
    """Warp ONE frame's (H, W) luma and (H/2, W/2) chroma uint8 planes by
    one (3, 3) matrix or a (ny, 3, 3) stack per luma tile row: a luma
    launch and a two-plane chroma launch of K1's uint8 mode with T = 1.
    Returns uint8 ``(wy, wu, wv)``."""
    if rotation.dim() not in (2, 3):
        raise ValueError(f"warp_yuv takes one (3, 3) matrix or a (ny, 3, 3) "
                         f"stack, got {tuple(rotation.shape)}")
    oh, ow = out_size
    wy = warp_planes_u8(y[None, None], rotation[None], out_camera, in_camera,
                        (oh, ow), border=0.0, kernels=ONE_FRAME_KERNELS)
    wc = warp_planes_u8(torch.stack([u, v])[None],
                        chroma_rotations(rotation, (), oh // 2)[None],
                        out_camera_c, in_camera_c, (oh // 2, ow // 2),
                        border=128.0, kernels=ONE_FRAME_KERNELS)
    return wy[0, 0], wc[0, 0], wc[0, 1]


def _warp_f32(src: torch.Tensor, rotation: torch.Tensor, out_camera: Camera,
              in_camera: Camera, out_size: Tuple[int, int], border: float,
              kernels) -> torch.Tensor:
    if (src.dim() != 3 or src.dtype != torch.float32
            or not 1 <= src.shape[0] <= MAX_F32_PLANES):
        raise ValueError(f"the float warp takes (1..{MAX_F32_PLANES}, H, W) "
                         f"float32, got {tuple(src.shape)} {src.dtype}")
    ny = _tile_rows(rotation, lead=())
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
    kernels[ny > 0].launch(
        cuda_lib.ptr(src), cuda_lib.ptr(out), cuda_lib.ptr(rotation),
        planes, in_h, in_w, out_h, out_w, ny,
        *_camera_args(out_camera, in_camera, border))
    return out


def warp_frame_f32(image: torch.Tensor, rotation: torch.Tensor,
                   out_camera: Camera, in_camera: Camera,
                   out_size: Tuple[int, int], border: float = 0.0) -> torch.Tensor:
    """Warp one (H, W) float32 plane by one (3, 3) matrix, or a
    (ny, 3, 3) stack per tile row, to a float32 (out_h, out_w) plane,
    neither rounded nor clamped."""
    if image.dim() != 2:
        raise ValueError(f"warp_frame_f32 takes one (H, W) plane, got "
                         f"{tuple(image.shape)}")
    return _warp_f32(image[None], rotation, out_camera, in_camera, out_size,
                     border, FRAME_F32_KERNELS)[0]


def warp_planes_f32(planes: torch.Tensor, rotation: torch.Tensor,
                    out_camera: Camera, in_camera: Camera,
                    out_size: Tuple[int, int], border: float = 0.0) -> torch.Tensor:
    """Warp (P, H, W) float32 planes of one frame (P up to 4; U and V with
    border 128) through ONE map in one launch; (P, out_h, out_w) float32.
    ``rotation`` is one (3, 3) matrix or a (ny, 3, 3) stack per tile row
    of THESE planes (chroma callers gather it, :func:`chroma_row_rotations`)."""
    return _warp_f32(planes, rotation, out_camera, in_camera, out_size, border,
                     PLANES_F32_KERNELS)
