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
  one map, ``warp_planes_pallas`` (``_build_warp_planes_fn``, :1957);
- :func:`warp_frames_f32`: T float planes to float32, one 3x3 per frame,
  ``warp_frames_pallas`` (``_build_warp_batch_fn``, :1860), the stream
  batch of ``parallel/streams.py``;
- :func:`warp_frame_band_f32`: output tile rows [off, off + ceil(ny /
  nshards)) of one float frame, the row index clamped to the last tile
  row, ``warp_frame_band_pallas`` (``_build_warp_band_fn``, :2303), the
  per-rank body of the spatial warp.

Every entry but the last two also takes the rolling-shutter form of its
rotation, one 3x3 per 8-row output tile row (``_make_kernel(rs=True)``, :925-927,
:1142-1149): a (ny, 3, 3) stack where it took one (3, 3) matrix, a
(T, ny, 3, 3) stack where it took (T, 3, 3), as the JAX entries do
(``jnp.ndim(rotation) == 3`` at :2003, :2135, :2376; ``== 4`` at :2261).
Output row ``r`` takes rotation ``min(r // 8, ny - 1)``. The chroma stack
is gathered from the luma one before the launch
(:func:`chroma_row_rotations`). These launches are counted under kernel
objects of their own (``*_rs``).

And every entry takes K1's three other modes (``csrc/warp_modes.cu``),
alone or together, with or without per-tile-row rotations (the frame
batch and the band: the 4-tap and ray-grid modes, as the TPU builders
of rows 6 and 9 take them):

- ``interp="bicubic"|"lanczos"``: 4x4 taps (``plan.taps == 4``);
- an output camera that is not rectilinear: the ray grid, (3, H, W)
  output rays computed once per camera, size and device
  (:func:`ray_grid_planar`);
- ``levels``, an :class:`~video_annotator_tpu_torch.ops.mip.TileLevels`
  whose largest level is above 0: the per-tile mip prefilter, the levels
  of the source built per call (``box_downsample``, then K3 in the uint8
  modes).

A launch in these modes counts once, under the kernel object of its
variant (:func:`mode_kernel`): the entry's object name, then ``_bicubic``
or ``_lanczos``, ``_rays``, ``_mip`` for the modes it runs, then ``_rs``
(``warp_luma_bicubic_rays_mip_rs``). The bilinear, rectilinear, no-mip
launches keep their kernels and objects.

And the diagnostic builds of the luma batch, for the roofline tool only
(:func:`warp_luma_batch_diag`; the TPU kernel's ``VAT_WARP_DIAG`` builds,
:146-153, :406-422): K1 without its taps, without its map, or without
both, each its own kernel object. No render reaches them, and no
environment variable selects them.

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
import functools
from typing import Optional, Tuple

import torch

from video_annotator_tpu_torch.camera import Camera, CameraModel
from video_annotator_tpu_torch.ops import cuda_lib
from video_annotator_tpu_torch.ops.mip import (
    MIP_LEVELS,
    TileLevels,
    float_levels,
    sample_levels,
)
from video_annotator_tpu_torch.ops.stage import stage_u8
from video_annotator_tpu_torch.ops.warp_plain import (
    INTERPS,
    TILE_ROWS,
    compute_warp_map,
    map_rays,
    num_tile_rows,
    bilinear_sample,
    ray_grid,
    sample,
)

_SOURCE = "video_annotator_tpu_torch/csrc/warp.cu"
_MODES_SOURCE = "video_annotator_tpu_torch/csrc/warp_modes.cu"
_PALLAS = "video_annotator_tpu/ops/warp_pallas.py"
_CAMERA_ARGTYPES = [ctypes.c_float] * 12 + [ctypes.c_int, ctypes.c_float]
_U8_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + _CAMERA_ARGTYPES
_F32_ARGTYPES = _U8_ARGTYPES  # (src, dst, rot, t, planes, in_h, in_w, out_h, out_w, ny)
_BAND_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + _CAMERA_ARGTYPES
_LEVEL_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 3
_MODES_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                   + _CAMERA_ARGTYPES
                   + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                   + _LEVEL_ARGTYPES * MIP_LEVELS + [ctypes.c_int] * 2)


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
# _build_warp_batch_fn and _build_warp_band_fn (rows 6 and 9)
WARP_FRAMES_F32 = _kernel("warp_frames_f32", "vat_warp_f32", _F32_ARGTYPES, 1860)
WARP_BAND_F32 = _kernel("warp_band_f32", "vat_warp_f32_band", _BAND_ARGTYPES, 2303)
# K1's diagnostic builds of the luma batch (csrc/warp.cu, DIAG), by their
# bits, each in place of the TPU build it stands for: no_walk (the source
# sampling left out), no_dma (the other half), and the two together as
# VAT_WARP_DIAG=no_dma,no_walk parsed them.
DIAG_NO_TAPS = 1
DIAG_NO_MAP = 2
DIAG_TAP = 200  # NO_TAPS samples a flat plane of this value without reading it
LUMA_DIAG_KERNELS = {
    DIAG_NO_TAPS: _kernel("warp_luma_diag_no_taps", "vat_warp_luma_diag_no_taps",
                          _U8_ARGTYPES, 1434),
    DIAG_NO_MAP: _kernel("warp_luma_diag_no_map", "vat_warp_luma_diag_no_map",
                         _U8_ARGTYPES, 1083),
    DIAG_NO_MAP | DIAG_NO_TAPS: _kernel("warp_luma_diag_no_map_no_taps",
                                        "vat_warp_luma_diag_no_map_no_taps", _U8_ARGTYPES, 406),
}
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
    if in_camera.model not in (CameraModel.RECTILINEAR, CameraModel.FISHEYE):
        raise ValueError("the warp kernel takes a fisheye or rectilinear input "
                         f"camera, got {in_camera.model.value!r}")


def _camera_args(out_camera: Camera, in_camera: Camera, border: float):
    o, i = out_camera, in_camera
    return (o.fx, o.fy, o.cx, o.cy, i.fx, i.fy, i.cx, i.cy, *i.dist,
            int(i.model == CameraModel.FISHEYE), float(border))


# A warper's luma and chroma grids stay on the device between launches
# (198 MB and 49 MB at the stock 4680x3520 canvas).
@functools.lru_cache(maxsize=2)
def ray_grid_planar(out_camera: Camera, out_size: Tuple[int, int],
                    device: torch.device) -> torch.Tensor:
    """(3, H, W) float32 output rays, contiguous: what the ray-grid mode
    reads, computed as :func:`~video_annotator_tpu_torch.ops.warp_plain.
    compute_warp_map` computes them, once per camera, size and device."""
    return ray_grid(out_camera, out_size, device).permute(2, 0, 1).contiguous()


@functools.lru_cache(maxsize=2)
def band_ray_grid(out_camera: Camera, out_size: Tuple[int, int],
                  device: torch.device) -> torch.Tensor:
    """(3, ceil(out_h / 8) * 8, W) float32 output rays: the grid of
    :func:`ray_grid_planar` and below it the rays of the last tile row's
    rows past ``out_h``, which a band computes and its caller crops."""
    out_h, out_w = out_size
    whole = ray_grid_planar(out_camera, out_size, device)
    pad = num_tile_rows(out_h) * TILE_ROWS - out_h
    if pad == 0:
        return whole
    extra = ray_grid(out_camera, (pad, out_w), device, row0=out_h).permute(2, 0, 1)
    return torch.cat([whole, extra], dim=1).contiguous()


def variant(out_camera: Camera, interp: str, levels: Optional[TileLevels]) -> str:
    """The modes of K1 a warp runs in, as its kernel object's suffix:
    ``""`` for the bilinear, rectilinear, no-mip kernels of
    ``csrc/warp.cu``, else ``_bicubic`` or ``_lanczos``, ``_rays``,
    ``_mip``, in that order, for those of ``csrc/warp_modes.cu``."""
    if interp not in INTERPS:
        raise ValueError(f"--interp must be one of {INTERPS}, got {interp!r}")
    modes = (interp if interp != "bilinear" else None,
             "rays" if out_camera.model != CameraModel.RECTILINEAR else None,
             "mip" if levels is not None and levels.max_level > 0 else None)
    return "".join(f"_{m}" for m in modes if m)


def mode_kernel(whole: cuda_lib.CudaKernel, suffix: str) -> cuda_lib.CudaKernel:
    """The kernel object that counts the launches of ``vat_warp_modes``
    standing in for ``whole`` (an entry's whole-frame kernel object, one
    rotation per frame or per tile row) in the variant ``suffix``
    (:func:`variant`): made at the variant's first launch, it replaces
    ``whole``'s TPU launch site."""
    base, rs = ((whole.name[:-3], "_rs") if whole.name.endswith("_rs")
                else (whole.name, ""))
    name = base + suffix + rs
    if name not in cuda_lib.KERNELS:
        cuda_lib.CudaKernel(name, "vat_warp_modes", _MODES_ARGTYPES, source=_MODES_SOURCE,
                            replaces=whole.replaces)
    return cuda_lib.KERNELS[name]


def _plain(src: torch.Tensor, rotation: torch.Tensor, out_camera: Camera,
           in_camera: Camera, out_size: Tuple[int, int], border: float,
           interp: str, levels: Optional[TileLevels], source_levels) -> torch.Tensor:
    """(P, H, W) planes of one frame through one map; ``source_levels``
    gives levels 1..L of the planes for a level map whose largest is L."""
    coords = compute_warp_map(out_camera, in_camera, rotation, out_size)
    if levels is None or levels.max_level == 0:
        return torch.stack([sample(plane.to(torch.float32) - border, coords, interp) + border
                            for plane in src])
    stacks = [src] + source_levels(src, levels.max_level)
    level_px = levels.per_pixel(out_size)
    return torch.stack([sample_levels([s[i] for s in stacks], coords, level_px, border, interp)
                        for i in range(src.shape[0])])


def warp_planes_f32_plain(src: torch.Tensor, rotation: torch.Tensor,
                          out_camera: Camera, in_camera: Camera,
                          out_size: Tuple[int, int], border: float = 0.0,
                          interp: str = "bilinear",
                          levels: Optional[TileLevels] = None) -> torch.Tensor:
    """Plain torch version of K1's float mode: (P, H, W) float planes of
    one frame, one (3, 3) matrix or a (ny, 3, 3) stack -> (P, out_h,
    out_w) float32, neither rounded nor clamped, sampled centred on
    ``border``; with ``levels``, the per-tile mip of float levels."""
    return _plain(src, rotation, out_camera, in_camera, out_size, border, interp,
                  levels, lambda p, n: float_levels(p.to(torch.float32), n))


def warp_planes_u8_plain(src: torch.Tensor, rotations: torch.Tensor,
                         out_camera: Camera, in_camera: Camera,
                         out_size: Tuple[int, int], border: float = 0.0,
                         interp: str = "bilinear",
                         levels: Optional[TileLevels] = None) -> torch.Tensor:
    """Plain torch version of K1's uint8 mode: (T, P, H, W) uint8 planes,
    (T, 3, 3) matrices or a (T, ny, 3, 3) stack -> (T, P, out_h, out_w)
    uint8, one map per frame shared by its P planes, rounded half to
    even; with ``levels``, the per-tile mip of levels rounded to bytes."""
    def byte_levels(planes, n):
        return [to_u8(f) for f in float_levels(planes.to(torch.float32), n)]

    return torch.stack([
        to_u8(_plain(src[t], rotations[t], out_camera, in_camera, out_size, border,
                     interp, levels, byte_levels))
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


def level_stacks(src: torch.Tensor, levels: Optional[TileLevels],
                 border: float) -> list:
    """Levels 1..L of (T, P, H, W) uint8 or (P, H, W) float32 planes as
    the modes kernel reads them, L the largest level of ``levels`` (none
    without it): uint8 staged by K3 (rounded half to even, border-padded
    rows of ``round_up(W, 128)`` bytes), float32 as ``box_downsample``
    leaves them."""
    if levels is None or levels.max_level == 0:
        return []
    if levels.max_level > MIP_LEVELS:
        raise ValueError(f"the warp kernel takes mip levels up to {MIP_LEVELS}, "
                         f"got {levels.max_level}")
    flat = src.reshape(-1, *src.shape[-2:]).to(torch.float32)
    out = float_levels(flat, levels.max_level)
    if src.dtype == torch.uint8:
        out = [stage_u8(lv, pad_value=int(border)) for lv in out]
    return out


def launch_modes(src: torch.Tensor, out: torch.Tensor, rotations: torch.Tensor,
                 out_camera: Camera, in_camera: Camera, border: float, interp: str,
                 levels: Optional[TileLevels], stacks: list,
                 kernel: cuda_lib.CudaKernel, frames: bool = False,
                 band: Optional[Tuple[int, int]] = None) -> None:
    """One launch of ``vat_warp_modes`` on contiguous (T, P, H, W) uint8 or
    (P, H, W) float32 planes into ``out``, the levels' sources in
    ``stacks`` (:func:`level_stacks`), counted under ``kernel``.
    ``frames``: the float planes are T frames under (T, 3, 3) rotations.
    ``band``: (out_h, tile-row offset) of one float plane's band, ``out``
    holding its rows."""
    f32 = src.dtype == torch.float32
    planes, in_h, in_w = src.shape[-3:]
    t = planes if frames else (1 if f32 else src.shape[0])
    planes = 1 if frames else planes
    out_h, out_w = out.shape[-2:]
    band_rows, band_off = 0, 0
    if band is not None:
        band_rows, band_off = out_h // TILE_ROWS, band[1]
        out_h = num_tile_rows(band[0]) * TILE_ROWS
    ny = _tile_rows(rotations, lead=(t,) if frames or not f32 else ())
    rays = None
    if out_camera.model != CameraModel.RECTILINEAR:
        rays = (ray_grid_planar(out_camera, (out_h, out_w), src.device) if band is None
                else band_ray_grid(out_camera, (band[0], out_w), src.device))
    keep = [src, out, rotations] + ([] if rays is None else [rays])
    level_args = [None, 0, 0, 0, 0] * MIP_LEVELS
    level_map, nx = None, 0
    if stacks:
        level_map = levels.levels.contiguous()
        nx = level_map.shape[1]
        keep += [level_map] + stacks
        for i, (lv, (h, w)) in enumerate(zip(stacks, _level_sizes(in_h, in_w, len(stacks)))):
            level_args[5 * i: 5 * i + 5] = [cuda_lib.ptr(lv), lv.shape[-2] * lv.shape[-1],
                                            lv.shape[-1], h, w]
    cuda_lib.check_operands(*keep)
    kernel.launch(
        int(f32), cuda_lib.ptr(src), cuda_lib.ptr(out), cuda_lib.ptr(rotations),
        t, planes, in_h, in_w, out_h, out_w, ny,
        *_camera_args(out_camera, in_camera, border), INTERPS.index(interp),
        None if rays is None else cuda_lib.ptr(rays),
        None if level_map is None else cuda_lib.ptr(level_map), nx, *level_args,
        band_rows, band_off)


def _level_sizes(h: int, w: int, n: int) -> list:
    """(rows, columns) of levels 1..n of an (h, w) plane (``box_downsample``
    rounds odd sizes up)."""
    out = []
    for _ in range(n):
        h, w = (h + 1) // 2, (w + 1) // 2
        out.append((h, w))
    return out


def warp_planes_u8(src: torch.Tensor, rotations: torch.Tensor,
                   out_camera: Camera, in_camera: Camera,
                   out_size: Tuple[int, int], border: float = 0.0,
                   kernels=BATCH_KERNELS, interp: str = "bilinear",
                   levels: Optional[TileLevels] = None) -> torch.Tensor:
    """Warp (T, P, H, W) uint8 planes (P = 1 luma, P = 2 chroma) by
    per-frame (T, 3, 3) matrices, or per-tile-row (T, ny, 3, 3) stacks,
    applied to output rays. ``kernels`` names the kernel objects whose
    launch is counted: the batch's, or the one-frame warp's
    (:data:`ONE_FRAME_KERNELS`). ``interp``, the output camera and
    ``levels`` select K1's other modes (module docstring)."""
    if src.dim() != 4 or src.dtype != torch.uint8 or src.shape[1] not in (1, 2):
        raise ValueError(f"warp takes (T, 1|2, H, W) uint8, got "
                         f"{tuple(src.shape)} {src.dtype}")
    ny = _tile_rows(rotations, lead=(src.shape[0],))
    _check_cameras(out_camera, in_camera)
    suffix = variant(out_camera, interp, levels)
    rotations = rotations.to(device=src.device, dtype=torch.float32)
    if src.device.type == "cpu":
        return warp_planes_u8_plain(src, rotations, out_camera, in_camera,
                                    out_size, border, interp, levels)
    cuda_lib.check_cuda(src)
    src = src.contiguous()
    rotations = rotations.contiguous()
    t, planes, in_h, in_w = src.shape
    out_h, out_w = out_size
    out = torch.empty((t, planes, out_h, out_w), dtype=torch.uint8,
                      device=src.device)
    kernel = kernels[ny > 0][planes - 1]
    if suffix:
        launch_modes(src, out, rotations, out_camera, in_camera, border, interp, levels,
                     level_stacks(src, levels, border), mode_kernel(kernel, suffix))
        return out
    cuda_lib.check_operands(src, rotations, out)
    kernel.launch(
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
                   in_camera_c: Camera, out_size: Tuple[int, int],
                   interp: str = "bilinear", levels=(None, None)):
    """Warp a (T, H, W) luma stack and its (T, H/2, W/2) chroma stacks.

    Returns ``(wy, wu, wv)``: (T, out_h, out_w) and two
    (T, out_h/2, out_w/2) uint8 stacks. Luma warps with border 0, chroma
    with the neutral 128, both planes of a frame sharing one map.
    ``rotations`` is (T, 3, 3), or (T, ny, 3, 3) per luma tile row.
    ``levels`` is a (luma, chroma) pair."""
    oh, ow = out_size
    wy = warp_planes_u8(ys[:, None], rotations, out_camera, in_camera,
                        (oh, ow), border=0.0, interp=interp, levels=levels[0])[:, 0]
    wc = warp_planes_u8(torch.stack([us, vs], dim=1),
                        chroma_rotations(rotations, (ys.shape[0],), oh // 2), out_camera_c,
                        in_camera_c, (oh // 2, ow // 2), border=128.0, interp=interp,
                        levels=levels[1])
    return wy, wc[:, 0], wc[:, 1]


def warp_yuv(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
             rotation: torch.Tensor, out_camera: Camera, in_camera: Camera,
             out_camera_c: Camera, in_camera_c: Camera,
             out_size: Tuple[int, int], interp: str = "bilinear",
             levels=(None, None)):
    """Warp ONE frame's (H, W) luma and (H/2, W/2) chroma uint8 planes by
    one (3, 3) matrix or a (ny, 3, 3) stack per luma tile row: a luma
    launch and a two-plane chroma launch of K1's uint8 mode with T = 1.
    Returns uint8 ``(wy, wu, wv)``."""
    if rotation.dim() not in (2, 3):
        raise ValueError(f"warp_yuv takes one (3, 3) matrix or a (ny, 3, 3) "
                         f"stack, got {tuple(rotation.shape)}")
    oh, ow = out_size
    wy = warp_planes_u8(y[None, None], rotation[None], out_camera, in_camera,
                        (oh, ow), border=0.0, kernels=ONE_FRAME_KERNELS,
                        interp=interp, levels=levels[0])
    wc = warp_planes_u8(torch.stack([u, v])[None],
                        chroma_rotations(rotation, (), oh // 2)[None],
                        out_camera_c, in_camera_c, (oh // 2, ow // 2),
                        border=128.0, kernels=ONE_FRAME_KERNELS, interp=interp,
                        levels=levels[1])
    return wy[0, 0], wc[0, 0], wc[0, 1]


def _warp_f32(src: torch.Tensor, rotation: torch.Tensor, out_camera: Camera,
              in_camera: Camera, out_size: Tuple[int, int], border: float,
              kernels, interp: str, levels: Optional[TileLevels]) -> torch.Tensor:
    if (src.dim() != 3 or src.dtype != torch.float32
            or not 1 <= src.shape[0] <= MAX_F32_PLANES):
        raise ValueError(f"the float warp takes (1..{MAX_F32_PLANES}, H, W) "
                         f"float32, got {tuple(src.shape)} {src.dtype}")
    ny = _tile_rows(rotation, lead=())
    _check_cameras(out_camera, in_camera)
    suffix = variant(out_camera, interp, levels)
    rotation = rotation.to(device=src.device, dtype=torch.float32)
    if src.device.type == "cpu":
        return warp_planes_f32_plain(src, rotation, out_camera, in_camera,
                                     out_size, border, interp, levels)
    cuda_lib.check_cuda(src)
    src = src.contiguous()
    rotation = rotation.contiguous()
    planes, in_h, in_w = src.shape
    out_h, out_w = out_size
    out = torch.empty((planes, out_h, out_w), dtype=torch.float32,
                      device=src.device)
    kernel = kernels[ny > 0]
    if suffix:
        launch_modes(src, out, rotation, out_camera, in_camera, border, interp, levels,
                     level_stacks(src, levels, border), mode_kernel(kernel, suffix))
        return out
    cuda_lib.check_operands(src, rotation, out)
    kernel.launch(
        cuda_lib.ptr(src), cuda_lib.ptr(out), cuda_lib.ptr(rotation),
        1, planes, in_h, in_w, out_h, out_w, ny,
        *_camera_args(out_camera, in_camera, border))
    return out


def warp_frame_f32(image: torch.Tensor, rotation: torch.Tensor,
                   out_camera: Camera, in_camera: Camera,
                   out_size: Tuple[int, int], border: float = 0.0,
                   interp: str = "bilinear",
                   levels: Optional[TileLevels] = None) -> torch.Tensor:
    """Warp one (H, W) float32 plane by one (3, 3) matrix, or a
    (ny, 3, 3) stack per tile row, to a float32 (out_h, out_w) plane,
    neither rounded nor clamped."""
    if image.dim() != 2:
        raise ValueError(f"warp_frame_f32 takes one (H, W) plane, got "
                         f"{tuple(image.shape)}")
    return _warp_f32(image[None], rotation, out_camera, in_camera, out_size,
                     border, FRAME_F32_KERNELS, interp, levels)[0]


def warp_planes_f32(planes: torch.Tensor, rotation: torch.Tensor,
                    out_camera: Camera, in_camera: Camera,
                    out_size: Tuple[int, int], border: float = 0.0,
                    interp: str = "bilinear",
                    levels: Optional[TileLevels] = None) -> torch.Tensor:
    """Warp (P, H, W) float32 planes of one frame (P up to 4; U and V with
    border 128) through ONE map in one launch; (P, out_h, out_w) float32.
    ``rotation`` is one (3, 3) matrix or a (ny, 3, 3) stack per tile row
    of THESE planes (chroma callers gather it, :func:`chroma_row_rotations`)."""
    return _warp_f32(planes, rotation, out_camera, in_camera, out_size, border,
                     PLANES_F32_KERNELS, interp, levels)


def _check_f32_frames(frames: torch.Tensor, what: str) -> None:
    if frames.dim() != 3 or frames.dtype != torch.float32:
        raise ValueError(f"{what} takes (T, H, W) float32, got "
                         f"{tuple(frames.shape)} {frames.dtype}")


def warp_frames_f32_plain(frames: torch.Tensor, rotations: torch.Tensor,
                          out_camera: Camera, in_camera: Camera,
                          out_size: Tuple[int, int], border: float = 0.0,
                          interp: str = "bilinear") -> torch.Tensor:
    """Plain torch version of K1's float frame batch: (T, H, W) float32
    frames, (T, 3, 3) matrices -> (T, out_h, out_w) float32, frame t
    through its own map, neither rounded nor clamped."""
    return torch.stack([
        warp_planes_f32_plain(frames[t][None], rotations[t], out_camera, in_camera,
                              out_size, border, interp)[0]
        for t in range(frames.shape[0])])


def warp_frames_f32(frames: torch.Tensor, rotations: torch.Tensor,
                    out_camera: Camera, in_camera: Camera,
                    out_size: Tuple[int, int], border: float = 0.0,
                    interp: str = "bilinear") -> torch.Tensor:
    """Warp (T, H, W) float32 frames, frame t by ``rotations[t]`` (T, 3,
    3), to (T, out_h, out_w) float32 in one launch, neither rounded nor
    clamped: ``warp_frames_pallas`` (row 6). Takes the 4-tap and ray-grid
    modes; no per-tile-row rotations, no mip, as the TPU builder."""
    _check_f32_frames(frames, "warp_frames_f32")
    t = frames.shape[0]
    if tuple(rotations.shape) != (t, 3, 3):
        raise ValueError(f"rotations must be ({t}, 3, 3), got {tuple(rotations.shape)}")
    _check_cameras(out_camera, in_camera)
    suffix = variant(out_camera, interp, None)
    rotations = rotations.to(device=frames.device, dtype=torch.float32)
    if frames.device.type == "cpu":
        return warp_frames_f32_plain(frames, rotations, out_camera, in_camera,
                                     out_size, border, interp)
    cuda_lib.check_cuda(frames)
    frames = frames.contiguous()
    rotations = rotations.contiguous()
    _, in_h, in_w = frames.shape
    out_h, out_w = out_size
    out = torch.empty((t, out_h, out_w), dtype=torch.float32, device=frames.device)
    if suffix:
        launch_modes(frames, out, rotations, out_camera, in_camera, border, interp, None,
                     [], mode_kernel(WARP_FRAMES_F32, suffix), frames=True)
        return out
    cuda_lib.check_operands(frames, rotations, out)
    WARP_FRAMES_F32.launch(
        cuda_lib.ptr(frames), cuda_lib.ptr(out), cuda_lib.ptr(rotations),
        t, 1, in_h, in_w, out_h, out_w, 0, *_camera_args(out_camera, in_camera, border))
    return out


def band_tile_rows(out_h: int, nshards: int) -> int:
    """Tile rows of each of ``nshards`` bands of an ``out_h``-row output:
    ceil(ceil(out_h / 8) / nshards)."""
    return -(-num_tile_rows(out_h) // nshards)


def band_rows(out_h: int, nshards: int, tile_row_off: int, device=None) -> torch.Tensor:
    """The global output rows a band's rows compute: tile row
    min(off + j, ny - 1), all 8 of its rows, for j < :func:`band_tile_rows`."""
    ny = num_tile_rows(out_h)
    tiles = torch.clamp(torch.arange(band_tile_rows(out_h, nshards), device=device)
                        + tile_row_off, max=ny - 1)
    return (tiles[:, None] * TILE_ROWS + torch.arange(TILE_ROWS, device=device)).reshape(-1)


def warp_frame_band_f32_plain(frame: torch.Tensor, rotation: torch.Tensor,
                              out_camera: Camera, in_camera: Camera,
                              out_size: Tuple[int, int], nshards: int,
                              tile_row_off: int, border: float = 0.0,
                              interp: str = "bilinear") -> torch.Tensor:
    """Plain torch version of K1's band: one (H, W) float32 frame, one
    (3, 3) matrix -> (band_tile_rows * 8, out_w) float32, row j holding
    global row ``band_rows(...)[j]`` of the whole frame's map."""
    coords = band_coords(rotation.to(device=frame.device, dtype=torch.float32), out_camera,
                         in_camera, out_size, nshards, tile_row_off)
    return sample(frame.to(torch.float32) - border, coords, interp) + border


def band_coords(rotation: torch.Tensor, out_camera: Camera, in_camera: Camera,
                out_size: Tuple[int, int], nshards: int, tile_row_off: int) -> torch.Tensor:
    """(band_tile_rows * 8, out_w, 2) source coordinates (x, y) of a
    band's rows, on ``rotation``'s device: what its plain version samples."""
    out_h, out_w = out_size
    dev = rotation.device
    rows = band_rows(out_h, nshards, tile_row_off, dev)
    padded = (num_tile_rows(out_h) * TILE_ROWS, out_w)
    if out_camera.model == CameraModel.RECTILINEAR:
        rays = ray_grid(out_camera, padded, dev)[rows]
    else:
        rays = band_ray_grid(out_camera, out_size, dev).permute(1, 2, 0)[rows]
    return map_rays(rays, rotation, in_camera)


def warp_frame_band_f32(frame: torch.Tensor, rotation: torch.Tensor,
                        out_camera: Camera, in_camera: Camera,
                        out_size: Tuple[int, int], nshards: int, tile_row_off: int,
                        border: float = 0.0, interp: str = "bilinear") -> torch.Tensor:
    """Warp output tile rows [off, off + :func:`band_tile_rows`) of one
    (H, W) float32 frame by one (3, 3) matrix: ``warp_frame_band_pallas``
    (row 9). Returns (band_tile_rows * 8, out_w) float32; a band that runs
    past the last tile row repeats it, and the last tile's rows past
    ``out_h`` are computed like the others: the caller crops."""
    if frame.dim() != 2 or frame.dtype != torch.float32:
        raise ValueError(f"warp_frame_band_f32 takes one (H, W) float32 plane, got "
                         f"{tuple(frame.shape)} {frame.dtype}")
    if tuple(rotation.shape) != (3, 3):
        raise ValueError(f"rotation must be (3, 3), got {tuple(rotation.shape)}")
    if nshards < 1 or tile_row_off < 0:
        raise ValueError(f"bad band: nshards {nshards}, tile-row offset {tile_row_off}")
    _check_cameras(out_camera, in_camera)
    suffix = variant(out_camera, interp, None)
    rotation = rotation.to(device=frame.device, dtype=torch.float32)
    if frame.device.type == "cpu":
        return warp_frame_band_f32_plain(frame, rotation, out_camera, in_camera, out_size,
                                         nshards, tile_row_off, border, interp)
    cuda_lib.check_cuda(frame)
    frame = frame.contiguous()
    rotation = rotation.contiguous()
    in_h, in_w = frame.shape
    out_h, out_w = out_size
    rows = band_tile_rows(out_h, nshards)
    out = torch.empty((rows * TILE_ROWS, out_w), dtype=torch.float32, device=frame.device)
    if suffix:
        launch_modes(frame[None], out, rotation, out_camera, in_camera, border, interp,
                     None, [], mode_kernel(WARP_BAND_F32, suffix),
                     band=(out_h, int(tile_row_off)))
        return out
    cuda_lib.check_operands(frame, rotation, out)
    WARP_BAND_F32.launch(
        cuda_lib.ptr(frame), cuda_lib.ptr(out), cuda_lib.ptr(rotation),
        in_h, in_w, out_h, out_w, rows, int(tile_row_off),
        *_camera_args(out_camera, in_camera, border))
    return out


def scaled_coords(in_size: Tuple[int, int], out_size: Tuple[int, int], device) -> torch.Tensor:
    """(out_h, out_w, 2) source coordinates (x, y) of the ``DIAG_NO_MAP``
    build: each output pixel's own, times in_w / out_w and in_h / out_h
    taken in float32."""
    (in_h, in_w), (out_h, out_w) = in_size, out_size
    f32 = torch.float32
    sx = torch.tensor(in_w, dtype=f32) / torch.tensor(out_w, dtype=f32)
    sy = torch.tensor(in_h, dtype=f32) / torch.tensor(out_h, dtype=f32)
    xs = torch.arange(out_w, dtype=f32, device=device) * sx.to(device)
    ys = torch.arange(out_h, dtype=f32, device=device) * sy.to(device)
    return torch.stack([xs[None, :].expand(out_h, out_w), ys[:, None].expand(out_h, out_w)],
                       dim=-1)


def warp_luma_batch_diag_plain(ys: torch.Tensor, rotations: torch.Tensor,
                               out_camera: Camera, in_camera: Camera,
                               out_size: Tuple[int, int], diag: int) -> torch.Tensor:
    """Plain twin of :func:`warp_luma_batch_diag`: the same garbage. With
    ``DIAG_NO_TAPS`` the warp of a flat ``DIAG_TAP`` plane; with
    ``DIAG_NO_MAP`` the bilinear taps at :func:`scaled_coords`."""
    src = torch.full_like(ys, DIAG_TAP) if diag & DIAG_NO_TAPS else ys
    if not diag & DIAG_NO_MAP:
        return warp_planes_u8_plain(src[:, None], rotations, out_camera, in_camera,
                                    out_size)[:, 0]
    coords = scaled_coords(tuple(ys.shape[-2:]), out_size, ys.device)
    return torch.stack([to_u8(bilinear_sample(plane, coords)) for plane in src])


def warp_luma_batch_diag(ys: torch.Tensor, rotations: torch.Tensor,
                         out_camera: Camera, in_camera: Camera,
                         out_size: Tuple[int, int], diag: int) -> torch.Tensor:
    """The luma batch of :func:`warp_yuv_batch` ((T, H, W) uint8, (T, 3, 3)
    rotations, bilinear, a rectilinear output, border 0) in one of K1's
    diagnostic builds: ``diag`` 0 is the product kernel (``warp_luma``),
    else the bits ``DIAG_NO_TAPS`` and ``DIAG_NO_MAP``, whose output is
    garbage, for timing only (the roofline tool's decomposition)."""
    if diag == 0:
        return warp_planes_u8(ys[:, None], rotations, out_camera, in_camera, out_size)[:, 0]
    kernel = LUMA_DIAG_KERNELS.get(diag)
    if kernel is None:
        raise ValueError(f"diag must be 0 or one of {sorted(LUMA_DIAG_KERNELS)}, got {diag}")
    if ys.dim() != 3 or ys.dtype != torch.uint8:
        raise ValueError(f"the diagnostic builds take (T, H, W) uint8, got "
                         f"{tuple(ys.shape)} {ys.dtype}")
    if _tile_rows(rotations, lead=(ys.shape[0],)) != 0:
        raise ValueError("the diagnostic builds take one 3x3 per frame")
    _check_cameras(out_camera, in_camera)
    if variant(out_camera, "bilinear", None):
        raise ValueError("the diagnostic builds take a rectilinear output camera")
    rotations = rotations.to(device=ys.device, dtype=torch.float32)
    if ys.device.type == "cpu":
        return warp_luma_batch_diag_plain(ys, rotations, out_camera, in_camera, out_size, diag)
    cuda_lib.check_cuda(ys)
    ys, rotations = ys.contiguous(), rotations.contiguous()
    t, in_h, in_w = ys.shape
    out_h, out_w = out_size
    out = torch.empty((t, out_h, out_w), dtype=torch.uint8, device=ys.device)
    cuda_lib.check_operands(ys, rotations, out)
    kernel.launch(cuda_lib.ptr(ys), cuda_lib.ptr(out), cuda_lib.ptr(rotations),
                  t, 1, in_h, in_w, out_h, out_w, 0, *_camera_args(out_camera, in_camera, 0.0))
    return out
