"""The whole pipeline as one sharded step over a device mesh.

Port of ``video_annotator_tpu/parallel/pipeline.py`` on
``torch.distributed``. Each rank holds a (B_local, T_local, H, W) block
of frames: streams over ``data``, frames over ``time``; the warped
output rows are split over ``space``. The step, per rank:

1. tracking: corners on each frame's predecessor, pyramidal LK (on a
   card kernel K2's pairs form on the levels it can stage and the plain
   level on the others, the plain ``pyramidal_lk`` on the CPU, as
   :func:`track_pairs` resolves it), RANSAC per pair. The predecessor of
   a block's first frame is the last frame of the left time neighbour (a
   one-frame halo); the global first frame is tracked against itself. The
   RANSAC samples of a pair come from a generator seeded by its global
   (stream, frame) index, so the result does not depend on the mesh;
2. the distributed prefix product of the deltas over ``time``;
3. Savitzky-Golay smoothing with ``smooth_radius`` halos;
4. the warp by the corrections ``R_meas R_smooth^T``: with one rank on
   ``space``, every frame through K1's float frame batch (row 6); with
   more, each frame's band of tile rows through K1's band mode (row 9).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from video_annotator_tpu_torch import so3
from video_annotator_tpu_torch.camera import Camera
from video_annotator_tpu_torch.ops import warp_kernel
from video_annotator_tpu_torch.ops.corners import detect_corners
from video_annotator_tpu_torch.ops.lk import pyramidal_lk, resolve_lk
from video_annotator_tpu_torch.ops.lk_kernel import pyramidal_lk_pairs, stage_pyramid_pairs
from video_annotator_tpu_torch.ops.ransac import estimate_rotation, sample_pairs
from video_annotator_tpu_torch.parallel.mesh import axis_size, neighbour_exchange
from video_annotator_tpu_torch.parallel.temporal import distributed_accumulate_rotations, halo_pad
from video_annotator_tpu_torch.smoothing.savgol import savgol_weights, sg_conv

LK_LEVELS = 2
LK_ITERS = 5
MIN_DISTANCE = 8
BORDER = 4
SEED = 0  # the JAX dryrun's PRNGKey(0)

# (status (T, N) bool, global stream, global frame indices (T,)) -> (T, H, 2)
PairsFn = Callable[[torch.Tensor, int, torch.Tensor], torch.Tensor]


def pair_generator(stream: int, frame: int) -> torch.Generator:
    """The RANSAC generator of the pair ending at global ``frame`` of
    global ``stream``: a function of the two indices alone."""
    return torch.Generator().manual_seed((((SEED << 20) + int(stream)) << 32) + int(frame))


def generator_pairs(num_hypotheses: int) -> PairsFn:
    """RANSAC samples among the tracked points, drawn on the host from
    :func:`pair_generator`."""
    def pairs(status, stream, frames):
        u = torch.stack([torch.rand((num_hypotheses, 2), generator=pair_generator(stream, f))
                         for f in frames.tolist()])
        return sample_pairs(status, u.to(status.device))
    return pairs


def track_pairs(seq: torch.Tensor, in_camera: Camera, max_corners: int):
    """Track corners of each frame of a (T + 1, H, W) sequence into the
    next: ``(pts, new_pts, status)`` of (T, N, 2), (T, N, 2), (T, N)."""
    pts, valid = detect_corners(seq[:-1], max_corners=max_corners,
                                min_distance=MIN_DISTANCE, border=BORDER)
    if resolve_lk(seq.device) == "kernel":
        staged = stage_pyramid_pairs(seq, LK_LEVELS, plain_levels=True)
        new_pts, status = pyramidal_lk_pairs(staged, tuple(seq.shape[-2:]), pts, valid,
                                             iters=LK_ITERS)
    else:
        new_pts, status = pyramidal_lk(seq[:-1], seq[1:], pts, valid, levels=LK_LEVELS,
                                       iters=LK_ITERS)
    return pts, new_pts, status


def build_pipeline_step(mesh: DeviceMesh, in_camera: Camera, out_camera: Camera,
                        smooth_radius: int = 2, max_corners: int = 32,
                        num_hypotheses: int = 16,
                        hypothesis_pairs: Optional[PairsFn] = None):
    """``step(frames) -> warped`` on this rank's (B_local, T_local, H, W)
    float32 block: (B_local, T_local, out_h, out_w) float32 with one rank
    on ``space``, else (B_local, T_local, b * 8, out_w), this rank's band
    of b tile rows (``warp_kernel.band_tile_rows``; rows past out_h, and
    a last band's repeated tile row, are cropped after a gather).
    ``step(frames, with_corrections=True)`` returns ``(warped,
    corrections)``, the (B_local, T_local, 3, 3) matrices it warped by.
    ``hypothesis_pairs`` replaces the RANSAC samples (tests inject the
    JAX package's)."""
    threshold = 8.0 / float(in_camera.fx)
    w_sg = torch.from_numpy(savgol_weights(smooth_radius, 2))
    pairs_of = hypothesis_pairs or generator_pairs(num_hypotheses)
    out_size = (out_camera.height, out_camera.width)

    def deltas_of(frames: torch.Tensor) -> torch.Tensor:
        bl, tl = frames.shape[:2]
        from_left, _ = neighbour_exchange(frames[:, -1:], None, mesh, "time")
        if from_left is None:  # the global first block: frame 0 against itself
            from_left = frames[:, :1]
        t0 = mesh.get_local_rank("time") * tl
        b0 = mesh.get_local_rank("data") * bl
        gt = torch.arange(t0, t0 + tl)
        out = []
        for b in range(bl):
            seq = torch.cat([from_left[b], frames[b]])
            pts, new_pts, status = track_pairs(seq, in_camera, max_corners)
            est = estimate_rotation(in_camera.unproject_unit(pts),
                                    in_camera.unproject_unit(new_pts), status,
                                    threshold_rad=threshold,
                                    pairs=pairs_of(status, b0 + b, gt),
                                    num_hypotheses=num_hypotheses)
            out.append(est.rotation)
        return torch.stack(out)

    def warp(frames: torch.Tensor, corrections: torch.Tensor) -> torch.Tensor:
        bl, tl, h, w = frames.shape
        flat = frames.reshape(bl * tl, h, w)
        rots = corrections.reshape(bl * tl, 3, 3)
        n = axis_size(mesh, "space")
        if n == 1:
            out = warp_kernel.warp_frames_f32(flat, rots, out_camera, in_camera, out_size)
        else:
            off = mesh.get_local_rank("space") * warp_kernel.band_tile_rows(out_size[0], n)
            out = torch.stack([
                warp_kernel.warp_frame_band_f32(f, r, out_camera, in_camera, out_size, n, off)
                for f, r in zip(flat, rots)])
        return out.reshape(bl, tl, *out.shape[-2:])

    def step(frames: torch.Tensor, with_corrections: bool = False):
        frames = frames.to(torch.float32)
        bl, tl = frames.shape[:2]
        acc = distributed_accumulate_rotations(deltas_of(frames), mesh, "time")
        padded = halo_pad(acc.reshape(bl, tl, 9), smooth_radius, mesh, "time")
        w = w_sg.to(frames.device)
        smooth = so3.project(torch.stack([sg_conv(p, w) for p in padded]).reshape(bl, tl, 3, 3))
        corrections = so3.matmul(acc, so3.transpose(smooth))
        warped = warp(frames, corrections)
        return (warped, corrections) if with_corrections else warped

    return step
