"""Data and spatial parallelism of the warp.

Port of ``video_annotator_tpu/parallel/streams.py`` on
``torch.distributed``: every function takes this rank's local shard.

- :func:`warp_streams_sharded`: the plain path (the XLA form): this
  rank's streams, one frame each, and with a ``space`` axis this rank's
  band of the output rows, the row grid padded to a multiple of the axis;
- :func:`warp_streams_kernel_sharded`: this rank's streams through the
  float frame batch of kernel K1 (row 6), no collectives: the stream
  batch that N streams on one card, or one stream per card, run;
- :func:`warp_frame_spatial`: one frame, each rank of the ``space`` group
  warping its band of tile rows through K1's band mode (row 9), the
  bands all-gathered and cropped back to the frame.

JAX's ``warp_yuv_streams_sharded`` has no counterpart: it maps a per-batch
YUV warp over the ``data`` axis, and here each rank already holds its own
streams, so it calls the batch warp (the 2D families'
``warp_frame_similarity``, ``warp_frame_deshake``, ``SimilarityWarper``)
on them directly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from video_annotator_tpu_torch.camera import Camera
from video_annotator_tpu_torch.ops import warp_kernel
from video_annotator_tpu_torch.ops.warp_plain import bilinear_sample, map_rays, ray_grid
from video_annotator_tpu_torch.parallel.mesh import axis_size, gather


def _out_size(out_camera: Camera, out_size) -> Tuple[int, int]:
    return tuple(out_size) if out_size is not None else (out_camera.height, out_camera.width)


def space_rows(out_h: int, nshards: int) -> int:
    """Rows of each rank's band in :func:`warp_streams_sharded`: the row
    grid padded up to a multiple of ``nshards``, split evenly."""
    return -(-out_h // nshards)


def warp_streams_sharded(frames: torch.Tensor, rotations: torch.Tensor,
                         out_camera: Camera, in_camera: Camera,
                         mesh: Optional[DeviceMesh] = None,
                         space_axis: Optional[str] = "space",
                         out_size=None) -> torch.Tensor:
    """Warp this rank's (B_local, H, W) float32 frames, one per stream, by
    their (B_local, 3, 3) rotations with the plain bilinear warp. With a
    ``space`` axis of n ranks, rank s returns rows [s k, (s + 1) k) of
    each output, k = ceil(out_h / n); rows past out_h unproject below the
    image like any other row and are cropped after a :func:`gather`."""
    oh, ow = _out_size(out_camera, out_size)
    row0, rows = 0, oh
    if space_axis is not None and mesh is not None:
        rows = space_rows(oh, axis_size(mesh, space_axis))
        row0 = mesh.get_local_rank(space_axis) * rows
    rays = ray_grid(out_camera, (rows, ow), frames.device, row0=row0)
    return torch.stack([
        bilinear_sample(frame, map_rays(rays, rot.to(torch.float32), in_camera))
        for frame, rot in zip(frames, rotations.to(frames.device))])


def warp_streams_kernel_sharded(frames: torch.Tensor, rotations: torch.Tensor,
                                out_camera: Camera, in_camera: Camera,
                                out_size=None, interp: str = "bilinear") -> torch.Tensor:
    """Warp this rank's (B_local, H, W) float32 frames, one per stream, by
    their (B_local, 3, 3) rotations in one launch of K1's float frame
    batch (row 6); no collectives. (B_local, out_h, out_w) float32."""
    return warp_kernel.warp_frames_f32(frames, rotations, out_camera, in_camera,
                                       _out_size(out_camera, out_size), interp=interp)


def warp_frame_spatial(frame: torch.Tensor, rotation: torch.Tensor,
                       out_camera: Camera, in_camera: Camera, mesh: DeviceMesh,
                       space_axis: str = "space", out_size=None,
                       interp: str = "bilinear") -> torch.Tensor:
    """Spatial warp of one (H, W) float32 frame, the same on every rank of
    the ``space`` group: rank s warps tile rows [s b, (s + 1) b) of the
    output, b = ceil(ceil(out_h / 8) / n), through K1's band mode (row
    9); an all-gather of the bands, cropped to out_h, rebuilds the
    (out_h, out_w) frame on every rank."""
    oh, ow = _out_size(out_camera, out_size)
    n = axis_size(mesh, space_axis)
    off = mesh.get_local_rank(space_axis) * warp_kernel.band_tile_rows(oh, n)
    band = warp_kernel.warp_frame_band_f32(frame, rotation, out_camera, in_camera, (oh, ow),
                                           n, off, interp=interp)
    return gather(band, mesh, space_axis)[:oh]
