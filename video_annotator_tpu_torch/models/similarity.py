"""The vidstab-family stabiliser: a 2D similarity trajectory.

Port of ``video_annotator_tpu/models/similarity.py``. Analysis tracks
corners with pyramidal LK and fits a robust similarity per frame pair;
encoding smooths the accumulated ``(dx, dy, angle, log_scale)``
trajectory with the Savitzky-Golay kernel the rotation family uses and
warps with the inverse correction.

The analyser tracks as ``pipeline/render.py::Tracker`` does: on a card it
carries each frame's pyramid (kernel K3 stages the levels K2 can track)
and tracks with K2's per-frame form and the plain level on the others,
on the CPU it tracks the float frames with the plain ``pyramidal_lk``;
its key-frame rule reads the status count on the host once per frame. On a
card the warp is kernel K1 over identity pinhole cameras
(:class:`SimilarityWarper`); on the CPU it is
:func:`warp_frame_similarity`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from video_annotator_tpu_torch.camera import Camera, CameraModel
from video_annotator_tpu_torch.io.prefetch import DevicePrefetcher
from video_annotator_tpu_torch.ops import warp_kernel
from video_annotator_tpu_torch.ops.affine import (
    compose_similarity,
    fit_similarity,
    invert_similarity,
    similarity_matrix,
    warp_similarity,
)
from video_annotator_tpu_torch.ops.corners import detect_corners
from video_annotator_tpu_torch.ops.lk import DEF_ITERS, pyramidal_lk, resolve_lk
from video_annotator_tpu_torch.ops.lk_kernel import pyramidal_lk_packed, stage_pyramid
from video_annotator_tpu_torch.ops.warp_plain import box_downsample
from video_annotator_tpu_torch.pipeline.profiler import StageProfiler
from video_annotator_tpu_torch.pipeline.render import (
    KEY_FRAME_MAX_AGE,
    MAX_CORNERS,
    analysis_level,
    open_trimmed,
    tracking_border,
    tracking_gates,
)
from video_annotator_tpu_torch.pipeline.trajectory import Trajectory
from video_annotator_tpu_torch.smoothing.savgol import savgol_weights, sg_conv


def analyse_similarity(source: str, options,
                       profiler: Optional[StageProfiler] = None,
                       device="cuda") -> Trajectory:
    """Track the accumulated 2D similarity trajectory (vidstabdetect).

    ``--analysis-scale`` tracks on a box-downsampled level; similarities
    conjugate through scaling (translation x 2^level, angle and log-scale
    unchanged), applied once at collect time."""
    prof = profiler or StageProfiler()
    dev = torch.device(device)
    kernel = resolve_lk(dev) == "kernel"
    reader, meta, first, last = open_trimmed(source, options, dev)
    level = analysis_level(options, meta)
    track_w = meta.width >> level
    min_distance, min_inliers, min_refresh = tracking_gates(track_w)
    border = tracking_border(track_w, meta.height >> level)

    def detect(gray):
        return detect_corners(gray, max_corners=MAX_CORNERS,
                              min_distance=min_distance, border=border)

    acc = torch.zeros(4, dtype=torch.float32, device=dev)
    prev_params = torch.zeros(4, dtype=torch.float32, device=dev)
    out = []
    gray_prev = staged_prev = pts = valid = None
    age = 0
    idx = reader.start_frame - 1
    pre = DevicePrefetcher(prof.wrap_iter("decode", iter(reader)),
                           depth=options.prefetch_depth, device=dev)
    try:
        for y, _, _ in pre:
            idx += 1
            if idx < first:
                continue
            if idx >= last:
                break
            gray = box_downsample(y.to(torch.float32), level)
            staged = stage_pyramid(gray, plain_levels=True) if kernel else ()
            if gray_prev is None:
                with prof.stage("detect"):
                    pts, valid = detect(gray)
            else:
                with prof.stage("track"):
                    if kernel:
                        new_pts, status = pyramidal_lk_packed(
                            staged_prev, staged, tuple(gray.shape), pts, valid,
                            DEF_ITERS)
                    else:
                        new_pts, status = pyramidal_lk(gray_prev, gray, pts, valid)
                    params, inliers = fit_similarity(pts, new_pts, status)
                    prev_params = torch.where(inliers >= min_inliers, params,
                                              prev_params)
                    acc = compose_similarity(prev_params, acc)
                    # Key-frame rule: re-detect when the key frame is old
                    # or too few points survived (one host read).
                    refresh = age >= KEY_FRAME_MAX_AGE
                    if not refresh:
                        refresh = int(status.sum()) < min_refresh
                    pts, valid = detect(gray) if refresh else (new_pts, status)
                age = 0 if age >= KEY_FRAME_MAX_AGE else age + 1
            gray_prev, staged_prev = gray, staged
            out.append(acc)
    finally:
        pre.close()
        reader.close()
    with prof.stage("collect"):
        params_np = (torch.stack(out).cpu().numpy().astype(np.float64)
                     if out else np.zeros((0, 4)))
        params_np[:, :2] *= float(1 << level)
    return Trajectory(params=params_np, kind="similarity", fps=meta.fps,
                      width=meta.width, height=meta.height, source=source)


def similarity_corrections(traj: Trajectory, options) -> np.ndarray:
    """Per-frame sampling transforms (output px -> source px), (T, 4)."""
    t = traj.num_frames
    acc = torch.from_numpy(np.asarray(traj.params, np.float32))  # accumulated
    if t == 0 or options.stabilise == "none":
        return np.zeros((t, 4), np.float32)
    if options.stabilise == "fixed":
        smooth = torch.zeros_like(acc)
    else:
        radius = min(options.stabilise_radius, max(t - 1, 1))
        w = torch.from_numpy(savgol_weights(radius, 2))
        padded = torch.cat([acc[:1].expand(radius, 4), acc,
                            acc[-1:].expand(radius, 4)])
        smooth = sg_conv(padded, w)
    # Display correction = smooth o acc^-1 (take the frame to its smoothed
    # pose); the sampler needs the inverse map (output px -> source px).
    corr = compose_similarity(smooth, invert_similarity(acc))
    sample = invert_similarity(corr)
    # vidstabtransform's ``zoom: -stabiliseBuffer``: zoom OUT by the buffer
    # percent around the frame centre while stabilising, so corrections
    # reveal borders instead of cropping content. The sampling scale is the
    # display scale's inverse.
    if options.stabilise_buffer:
        z = 1.0 - options.stabilise_buffer / 100.0
        k = 1.0 / max(z, 1e-3)
        cx = (traj.width - 1) / 2.0
        cy = (traj.height - 1) / 2.0
        zoom = torch.tensor([cx * (1.0 - k), cy * (1.0 - k), 0.0, float(np.log(k))],
                            dtype=torch.float32)
        sample = compose_similarity(sample, zoom)
    return sample.numpy()


def warp_frame_similarity(y, u, v, sample_params, interp="bilinear",
                          out_size=None):
    """Warp float YUV planes by a similarity sampling transform; float32
    planes, chroma centred on 128. ``out_size`` (h, w) grows the canvas
    (the ``--upsample`` fold: ``encode_2d`` shrinks the sampling log-scale
    by log(upsample / 100) to match)."""
    half = sample_params * torch.tensor([0.5, 0.5, 1.0, 1.0],
                                        device=sample_params.device)
    half_size = None if out_size is None else (out_size[0] // 2, out_size[1] // 2)
    wy = warp_similarity(y, sample_params, interp=interp, out_size=out_size)
    wu = warp_similarity(u - 128.0, half, interp=interp, out_size=half_size) + 128.0
    wv = warp_similarity(v - 128.0, half, interp=interp, out_size=half_size) + 128.0
    return wy, wu, wv


class SimilarityWarper:
    """The similarity family's warp through kernel K1.

    A 2D similarity is a 3x3 homogeneous pixel matrix, so the rotation
    family's warp runs it unchanged over identity pinhole cameras (f = 1,
    c = 0): the kernel's rectilinear path computes ``M @ (x, y, 1)`` with
    a perspective divide by the constant 1
    (``ops/affine.similarity_matrix``). Chroma planes use f = 0.5 cameras,
    which conjugates M into the half-resolution frame: exactly the
    ``params * [0.5, 0.5, 1, 1]`` transform :func:`warp_frame_similarity`
    applies (not ``scaled_camera``'s pixel-centre variant).

    ``out_size`` (h, w) is the ``--upsample`` fold: a larger canvas whose
    sampling transforms already carry the shrunken log-scale. ``interp``
    ``bicubic`` or ``lanczos`` runs K1's 4-tap mode. The kernel reads the
    whole source plane, so nothing is planned from the corrections (an
    empty stack is fine)."""

    def __init__(self, width: int, height: int, interp: str = "bilinear",
                 out_size=None):
        if out_size is not None:
            self.out_h, self.out_w = out_size
        else:
            self.out_w = width - width % 2
            self.out_h = height - height % 2
        self.interp = interp
        self.cam = Camera.make(1.0, 1.0, 0.0, 0.0, width, height,
                               CameraModel.RECTILINEAR)
        self.cam_c = Camera.make(0.5, 0.5, 0.0, 0.0, width // 2, height // 2,
                                 CameraModel.RECTILINEAR)

    @staticmethod
    def matrices(corrections: np.ndarray) -> np.ndarray:
        """(T, 4) params -> (T, 3, 3) float32 matrices for the kernel."""
        params = torch.from_numpy(np.asarray(corrections, np.float32).reshape(-1, 4))
        return similarity_matrix(params).numpy()

    def warp_yuv_batch(self, ys, us, vs, mats: torch.Tensor):
        """Per-frame uint8 plane sequences + (T, 3, 3) matrices -> list of
        T uint8 (y, u, v) triples."""
        wy, wu, wv = warp_kernel.warp_yuv_batch(
            torch.stack(list(ys)), torch.stack(list(us)), torch.stack(list(vs)),
            mats, self.cam, self.cam, self.cam_c, self.cam_c,
            (self.out_h, self.out_w), interp=self.interp)
        return list(zip(wy, wu, wv))

    def warp_yuv(self, y, u, v, mat: torch.Tensor):
        """One frame's uint8 planes through one matrix: the compare grid's
        per-cell path."""
        return warp_kernel.warp_yuv(y, u, v, mat, self.cam, self.cam,
                                    self.cam_c, self.cam_c,
                                    (self.out_h, self.out_w), interp=self.interp)
