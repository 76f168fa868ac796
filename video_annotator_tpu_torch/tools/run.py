"""The benchmark suite: the eight configs of the JAX package's
``benchmarks/run.py``, each through the port on one card.

1. ``720p_undistort_cpu``: 720p30 fisheye to rectilinear undistort of a
   10 s clip with a precomputed remap table, interpolation only, on the
   CPU (``ops/warp_plain.py``; the config's own definition, so its child
   runs with ``--device cpu`` whatever the suite's device).
2. ``1080p_sparse_flow``: Shi-Tomasi corners once, then per frame pair
   both frames staged (K3) and tracked (K2's per-frame form) and a robust
   similarity fit (``ops/affine.py::fit_similarity``), identity lens.
3. ``1080p_full_pipeline``: the same LK with unit-ray RANSAC and the
   inlier-gated fallback per frame, Kalman smoothing, then
   ``FrameWarper.warp_yuv_batch`` (K1's uint8 batch) in 32-frame batches.
4. ``4k_gyro_fused``: ``integrate_gyro`` of a 400 Hz gyro stream,
   Savitzky-Golay smoothing, and K1's uint8 batch at 3840x2880.
4b. ``4k_visual_full_pipeline`` and ``..._detect0``: the stock loop at
   3840x2880 with the analyse measured in: the paired analyser
   (``PairTracker``: K3, K2's pairs form, RANSAC) at the stock
   ``--analysis-scale auto``, smoothing, K1's uint8 batch; ``_detect0``
   detects corners at the tracking scale. The JAX tool's environment
   variables are kept: ``VAT_BENCH_FRAMES`` (192), ``VAT_BENCH_GEOM=uhd``
   (3840x2160), ``VAT_BENCH_ANALYSIS_SCALE``, ``VAT_BENCH_ANALYSIS_CHUNK``,
   ``VAT_BENCH_ANALYSIS_MODE`` (``tracked``: the sequential tracker) and
   ``VAT_BENCH_DETECT_LEVEL``.
4c. ``e2e_decode_overlap_720p``: 960x720, the host decode alone, the
   host-to-device feed alone through ``DevicePrefetcher``, the device's
   analyse and warp alone, then the streaming render through
   ``DeviceReduceSink`` end to end (over the encoded clip and its raw
   y4m twin, trials interleaved), the same render read back, and the
   two-phase render (``VAT_E2E_FRAMES``, 240; ``VAT_E2E_TRIALS``, 5).
   The input is an H.264 MP4 from the native writer (``--source mp4``),
   or with ``--source y4m`` the y4m alone, where the encoded legs do not
   run and their figures are null. At 960x720 the tracking pyramid's
   third level (240x180) is too small for K2's window and runs the plain
   level.
5. ``8x4k60_multistream``: 8 streams x 4 frames of 4K YUV through
   ``FrameWarper.warp_yuv_batch`` (K1's uint8 batch at T = 32), four
   dispatches, two in flight; and ``h2d_GBps``, a pinned-memory copy of
   one 4K YUV set to the card.

Timing: warm-up excluded; the best of ``--trials`` (6) trials,
``--sleep`` (4 s) apart; device work synchronised with
``torch.cuda.synchronize()`` and, where the JAX tool keeps two dispatches
in flight, a CUDA event after each dispatch waited on one dispatch later.

Usage::

    python -m video_annotator_tpu_torch.tools.run [--configs NAME ...]
        [--trials 6] [--sleep 4] [--source mp4|y4m] [--device cuda|cpu] [--out PATH]
    python -m video_annotator_tpu_torch.tools.run --one NAME [...]

Without ``--one`` every config runs in a child process of its own; the
stamped results go to ``--out`` (default ``chiprun_out/run.json`` in the
checkout) and the exit code is 1 if a child failed. ``--one`` runs one
config in this process and prints its stamped JSON line, with
``launches``: the launches of each CUDA kernel object (and of the plain LK
level, ``lk_plain_level``) that the config ran, warm-up and trials
included. Without a card it exits 1 unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from fractions import Fraction
from pathlib import Path

import numpy as np
import torch

from video_annotator_tpu_torch.tools.provenance import stamp

REPO = Path(__file__).resolve().parents[2]
TRIALS = 6
TRIAL_SLEEP = 4.0
BATCH = 32  # frames of one warp dispatch, the encode's batch


def _pause(seconds: float) -> None:
    """Sleep between trials: ``seconds``, at most ``--sleep``."""
    time.sleep(min(seconds, TRIAL_SLEEP))


def _best_of(fn, trials=None, sleep=None):
    """Best wall-clock of ``fn()`` (seconds) over several trials (at most
    ``--trials``)."""
    trials = TRIALS if trials is None else min(trials, TRIALS)
    best = float("inf")
    for t in range(trials):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
        if t < trials - 1:
            _pause(TRIAL_SLEEP if sleep is None else sleep)
    return best


def _result(name, fps, frames, realtime_fps, extra=None):
    out = {
        "config": name,
        "metric": "frames_per_second",
        "value": round(fps, 2),
        "unit": "fps",
        "frames_timed": frames,
        "realtime_factor": round(fps / realtime_fps, 2),
    }
    if extra:
        out.update(extra)
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _pipelined(dispatches, dev: torch.device) -> None:
    """Run each of ``dispatches`` (callables that enqueue device work)
    with two in flight: after each, wait for the one before it; then wait
    for all."""
    pending = []
    for dispatch in dispatches:
        dispatch()
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            pending.append(event)
            if len(pending) > 1:
                pending.pop(0).synchronize()
    _sync(dev)


def _synthetic_lumas(w, h, n, shake=0.006, device="cuda"):
    """n textured luma frames under a synthetic shaky camera, rendered on
    ``device``; float32 of the uint8 luma."""
    from video_annotator_tpu_torch.io.synthetic import SyntheticCamera, render_frame

    cfg = SyntheticCamera(width=w, height=h, num_frames=n, shake=shake)
    cam = cfg.camera()
    rots = torch.from_numpy(cfg.rotations()).to(device)
    frames = [render_frame(cam, r)[0].to(torch.float32) for r in rots]
    _sync(torch.device(device))
    return frames


def _frame_lk(dev: torch.device, shape):
    """``lk(prev, curr, pts, valid)`` of the 1080p configs: on a card both
    frames staged (K3) and tracked by K2's per-frame form (the plain level
    where K2 cannot stage a level), as JAX's ``pyramidal_lk_pallas``; on
    the CPU the plain ``pyramidal_lk``, as JAX's XLA LK there."""
    from video_annotator_tpu_torch.ops.lk import pyramidal_lk, resolve_lk
    from video_annotator_tpu_torch.ops.lk_kernel import pyramidal_lk_packed, stage_pyramid

    if resolve_lk(dev) == "kernel":
        def lk(prev, curr, pts, valid):
            return pyramidal_lk_packed(stage_pyramid(prev, plain_levels=True),
                                       stage_pyramid(curr, plain_levels=True), shape, pts, valid)
        return lk
    return pyramidal_lk


# --------------------------------------------------------------------------
# 1. 720p30 undistort, precomputed remap table, CPU, interpolation only
# --------------------------------------------------------------------------

def bench_720p_undistort_cpu(device="cpu"):
    from video_annotator_tpu_torch.camera import CameraModel, camera_from_dfov, get_output_camera
    from video_annotator_tpu_torch.ops.warp_plain import bilinear_sample, compute_warp_map

    dev = torch.device("cpu")
    w, h = 1280, 720
    n = 300  # 10 s at 30 fps
    in_cam = camera_from_dfov(145.8, (w, h), CameraModel.FISHEYE)
    out_cam = get_output_camera(in_cam, crop_borders=True)
    oh = out_cam.height - out_cam.height % 2
    ow = out_cam.width - out_cam.width % 2
    # The remap table is computed once; the timed loop is interpolation.
    coords = compute_warp_map(out_cam, in_cam, torch.eye(3), (oh, ow))
    rng = np.random.default_rng(0)
    frames = [torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32))
              for _ in range(8)]
    bilinear_sample(frames[0], coords)

    def run():
        return [bilinear_sample(frames[i % 8], coords) for i in range(n)]

    dt = _best_of(run, trials=3, sleep=0.5)
    return _result("720p_undistort_cpu", n / dt, n, 30.0, {"backend": dev.type})


# --------------------------------------------------------------------------
# 2. 1080p sparse-flow stabilisation, identity lens
# --------------------------------------------------------------------------

def bench_1080p_sparse_flow(device="cuda"):
    from video_annotator_tpu_torch.ops.affine import fit_similarity
    from video_annotator_tpu_torch.ops.corners import detect_corners

    dev = torch.device(device)
    w, h, n = 1920, 1080, 120
    frames = _synthetic_lumas(w, h, n, device=dev)
    lk = _frame_lk(dev, (h, w))

    def step(prev, curr, pts, valid, acc):
        new_pts, status = lk(prev, curr, pts, valid)
        params, _inliers = fit_similarity(pts, new_pts, status)
        return new_pts, status, acc + params

    pts, valid = detect_corners(frames[0], max_corners=200, min_distance=30)
    acc = torch.zeros(4, dtype=torch.float32, device=dev)
    step(frames[0], frames[1], pts, valid, acc)
    _sync(dev)

    def run():
        p, v, a = pts, valid, acc
        for i in range(1, n):
            p, v, a = step(frames[i - 1], frames[i], p, v, a)
        _sync(dev)

    dt = _best_of(run)
    return _result("1080p_sparse_flow", (n - 1) / dt, n - 1, 30.0)


# --------------------------------------------------------------------------
# 3. 1080p full pipeline: LK stabilisation + Kalman smoothing + undistort
# --------------------------------------------------------------------------

def bench_1080p_full_pipeline(device="cuda"):
    from video_annotator_tpu_torch import so3
    from video_annotator_tpu_torch.camera import CameraModel, camera_from_dfov, get_output_camera
    from video_annotator_tpu_torch.ops.corners import detect_corners
    from video_annotator_tpu_torch.ops.ransac import estimate_rotation, rotation_with_fallback
    from video_annotator_tpu_torch.pipeline.render import FrameWarper, Tracker
    from video_annotator_tpu_torch.smoothing.kalman import smooth_rotations_kalman

    dev = torch.device(device)
    w, h, n = 1920, 1080, 96
    in_cam = camera_from_dfov(145.8, (w, h), CameraModel.FISHEYE)
    out_cam = get_output_camera(in_cam, crop_borders=True)
    warper = FrameWarper(in_cam, out_cam, max_correction_deg=6.0, device=dev)
    threshold = 8.0 / float(in_cam.fx)

    frames = _synthetic_lumas(w, h, n, device=dev)
    frames8 = [f.to(torch.uint8) for f in frames]
    uu = torch.full((h // 2, w // 2), 128, dtype=torch.uint8, device=dev)
    vv = torch.full((h // 2, w // 2), 128, dtype=torch.uint8, device=dev)
    lk = _frame_lk(dev, (h, w))

    def track(prev, curr, pts, valid, prev_delta, r_acc, index):
        new_pts, status = lk(prev, curr, pts, valid)
        est = estimate_rotation(
            in_cam.unproject_unit(pts)[None], in_cam.unproject_unit(new_pts)[None],
            status[None], threshold_rad=threshold,
            pairs=Tracker.hypothesis_pairs(status[None], index))
        delta = rotation_with_fallback(est, prev_delta[None], min_inliers=40)[0]
        r_new = so3.orthonormalize(so3.matmul(delta, r_acc))
        return new_pts, status, delta, r_new

    def full_run():
        pts, valid = detect_corners(frames[0], max_corners=200, min_distance=30)
        r_acc = torch.eye(3, dtype=torch.float32, device=dev)
        prev_delta = r_acc
        rs = [r_acc]
        for i in range(1, n):
            pts, valid, prev_delta, r_acc = track(frames[i - 1], frames[i], pts, valid,
                                                  prev_delta, r_acc, i - 1)
            rs.append(r_acc)
        measured = torch.stack(rs)
        smoothed = smooth_rotations_kalman(measured)
        corr = so3.matmul(measured, smoothed.transpose(-1, -2))
        _pipelined([functools.partial(
            warper.warp_yuv_batch, frames8[i:i + BATCH], (uu,) * len(frames8[i:i + BATCH]),
            (vv,) * len(frames8[i:i + BATCH]), corr[i:i + BATCH])
            for i in range(0, n, BATCH)], dev)

    full_run()  # warm-up
    dt = _best_of(full_run)
    return _result("1080p_full_pipeline", n / dt, n, 30.0)


# --------------------------------------------------------------------------
# 4. 4K gyro trajectory + K1's uint8 batch
# --------------------------------------------------------------------------

def stock_warper(w: int, h: int, dev: torch.device, preset=None):
    """The stock 4K cameras (preset ``gopro_h4b_wide43_measured``, the
    cropped rectilinear output) and their FrameWarper at a 6-degree
    correction."""
    from video_annotator_tpu_torch.camera import (
        CameraPreset,
        get_output_camera,
        get_preset_camera,
    )
    from video_annotator_tpu_torch.pipeline.render import FrameWarper

    in_cam = get_preset_camera(preset or CameraPreset.GOPRO_H4B_WIDE43_MEASURED, (w, h))
    out_cam = get_output_camera(in_cam, crop_borders=True)
    return in_cam, FrameWarper(in_cam, out_cam, max_correction_deg=6.0, device=dev)


def random_planes(rng, w: int, h: int, dev: torch.device):
    """One uint8 YUV 4:2:0 frame of uniform noise on ``dev``."""
    return tuple(torch.from_numpy(rng.integers(0, 255, shape, dtype=np.uint8)).to(dev)
                 for shape in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))


def bench_4k_gyro_fused(device="cuda"):
    from video_annotator_tpu_torch import so3
    from video_annotator_tpu_torch.smoothing.gyro import integrate_gyro
    from video_annotator_tpu_torch.smoothing.savgol import smooth_rotations

    dev = torch.device(device)
    w, h = 3840, 2880
    n = 64
    fps = 60.0
    gyro_hz = 400.0  # GoPro GPMF GYRO stream rate
    _, warper = stock_warper(w, h, dev)

    rng = np.random.default_rng(0)
    s = int(n / fps * gyro_hz) + 1
    omega = torch.from_numpy((rng.normal(size=(s, 3)) * 0.3).astype(np.float32)).to(dev)
    sample_ts = torch.from_numpy((np.arange(s) / gyro_hz).astype(np.float32)).to(dev)
    frame_ts = torch.from_numpy((np.arange(n) / fps).astype(np.float32)).to(dev)

    def trajectory(om):
        measured = integrate_gyro(om, sample_ts, frame_ts)
        smoothed = smooth_rotations(measured, radius=30)
        return so3.matmul(measured, smoothed.transpose(-1, -2))

    y, u, v = random_planes(rng, w, h, dev)
    ys, us, vs = (y,) * BATCH, (u,) * BATCH, (v,) * BATCH

    def run():
        corr = trajectory(omega)
        _pipelined([functools.partial(warper.warp_yuv_batch, ys[:len(c)], us[:len(c)],
                                      vs[:len(c)], c) for c in corr.split(BATCH)], dev)

    run()  # warm-up
    dt = _best_of(run)
    return _result("4k_gyro_fused", n / dt, n, 60.0)


# --------------------------------------------------------------------------
# 4b. 4K visual-tracking full pipeline (analyse included)
# --------------------------------------------------------------------------

def paired_stacks(frames, chunk: int):
    """The paired analyser's chunks of a frame list: frames i - 1 .. i +
    chunk - 1 for i = 1, 1 + chunk, ..., the last repeated to chunk + 1."""
    stacks = []
    for i in range(1, len(frames), chunk):
        s = torch.stack(frames[i - 1:i + chunk])
        if s.shape[0] < chunk + 1:
            s = torch.cat([s, s[-1:].expand(chunk + 1 - s.shape[0], *s.shape[1:])])
        stacks.append(s)
    return stacks


def analyse_paired(pair_tracker, stacks, n: int) -> torch.Tensor:
    """(n, 3, 3) accumulated rotations of the chunks through
    ``PairTracker``, as ``pipeline/render.py::analyse`` chains them."""
    eye = torch.eye(3, dtype=torch.float32, device=stacks[0].device)
    r_base, prev_delta = eye, eye
    rs = [r_base[None]]
    off = 0
    for s in stacks:
        r_base, prev_delta, ras = pair_tracker(r_base, prev_delta, off, s)
        rs.append(ras)
        off += s.shape[0] - 1
    return torch.cat(rs)[:n]


def analyse_tracked(tracker, frames) -> torch.Tensor:
    """(n, 3, 3) accumulated rotations of the frames through ``Tracker``."""
    return torch.stack([tracker.push(y) for y in frames])


def bench_4k_visual_full_pipeline(device="cuda", detect_level=None, tag=""):
    """The stock loop at 4K with the analyse measured in: the paired
    analyser at the stock ``--analysis-scale auto`` (0.5 at 4K), SG
    smoothing (radius 30), K1's uint8 batch on full-size YUV. Frames are
    synthetic shaken footage rendered once on the card (decode is not
    measured here; ``e2e_decode_overlap_720p`` is)."""
    from video_annotator_tpu_torch import so3
    from video_annotator_tpu_torch.camera import CameraPreset
    from video_annotator_tpu_torch.io.synthetic import SyntheticCamera, render_frame
    from video_annotator_tpu_torch.io.video import VideoMeta
    from video_annotator_tpu_torch.pipeline.render import (
        PairTracker,
        RenderOptions,
        Tracker,
        resolve_analysis_scale,
    )
    from video_annotator_tpu_torch.smoothing.savgol import smooth_rotations

    dev = torch.device(device)
    uhd = os.environ.get("VAT_BENCH_GEOM") == "uhd"
    w, h = (3840, 2160) if uhd else (3840, 2880)
    preset = (CameraPreset.GOPRO_H4B_WIDE169_MEASURED if uhd
              else CameraPreset.GOPRO_H4B_WIDE43_MEASURED)
    n = int(os.environ.get("VAT_BENCH_FRAMES", "192"))
    scale_env = os.environ.get("VAT_BENCH_ANALYSIS_SCALE", "auto")
    scale = None if scale_env == "auto" else float(scale_env)
    in_cam, warper = stock_warper(w, h, dev, preset)

    cfg = SyntheticCamera(width=w, height=h, num_frames=n, shake=0.004)
    frames8 = [render_frame(in_cam, r)[0] for r in torch.from_numpy(cfg.rotations()).to(dev)]
    uu = torch.full((h // 2, w // 2), 128, dtype=torch.uint8, device=dev)
    vv = torch.full((h // 2, w // 2), 128, dtype=torch.uint8, device=dev)

    meta = VideoMeta(w, h, Fraction(60, 1))
    chunk = int(os.environ.get("VAT_BENCH_ANALYSIS_CHUNK", "16"))
    mode = os.environ.get("VAT_BENCH_ANALYSIS_MODE", "paired")
    if detect_level is None:
        detect_level = int(os.environ.get("VAT_BENCH_DETECT_LEVEL", "1"))
    opts = RenderOptions(preset=preset, analysis_scale="auto" if scale is None else scale,
                         analysis_chunk=chunk, analysis_mode=mode,
                         analysis_detect_level=detect_level)
    scale = resolve_analysis_scale(opts, meta)
    if mode == "paired":
        stacks = paired_stacks(frames8, chunk)

        def analyse_run():
            return analyse_paired(PairTracker(meta, opts, dev), stacks, n)
    else:
        def analyse_run():
            return analyse_tracked(Tracker(meta, opts, dev), frames8)
    _sync(dev)

    def smooth(m):
        return so3.matmul(m, smooth_rotations(m, radius=30).transpose(-1, -2))

    def warp_run(corr):
        _pipelined([functools.partial(
            warper.warp_yuv_batch, frames8[i:i + BATCH], (uu,) * len(frames8[i:i + BATCH]),
            (vv,) * len(frames8[i:i + BATCH]), corr[i:i + BATCH])
            for i in range(0, n, BATCH)], dev)

    def full_run():
        warp_run(smooth(analyse_run()))

    full_run()  # warm-up
    dt = _best_of(full_run)

    # Informational phase split (each synchronised, so they add up to >= dt).
    def analyse_synced():
        analyse_run()
        _sync(dev)

    dt_analyse = _best_of(analyse_synced, trials=2, sleep=1.0)
    corr = smooth(analyse_run())
    _sync(dev)
    dt_warp = _best_of(lambda: warp_run(corr), trials=2, sleep=1.0)

    return _result(
        "4k_visual_full_pipeline" + ("_uhd" if uhd else "") + tag,
        n / dt, n, 60.0,
        {
            "geometry": f"{w}x{h}",
            "analysis_scale": scale,
            "analysis_mode": mode,
            "analysis_detect_level": detect_level,
            "analyse_fps": round(n / dt_analyse, 2),
            "warp_fps": round(n / dt_warp, 2),
        },
    )


# --------------------------------------------------------------------------
# 4c. decode-included end to end, with the overlap ratios (720p class)
# --------------------------------------------------------------------------

def bench_e2e_decode_overlap(device="cuda", source="mp4"):
    """Host decode, then ``DevicePrefetcher``, the paired analyse and K1's
    uint8 batch, end to end in one streaming pass, with each stage's rate
    alone:

    - ``upload_overlap_ratio`` = e2e_device_sink_fps / feed_only_fps,
      with ``upload_overlap_ok`` when it is >= 0.8 and beats the serial
      model 1 / (1/decode + 1/feed + 1/compute) by 5%; ``link_limited``
      when e2e falls under 0.95 of the serial model (no ordering of the
      pipeline explains that), where the gate is recorded as null;
    - ``decode_hiding_ratio``: the device-sink render over the H.264 clip
      against the same render over its raw y4m twin, trials interleaved,
      the median and range of the per-trial ratios (``--source mp4``);
    - the same streaming render read back (``no_output``, every frame
      fetched) and the two-phase render of the same job, for context."""
    from video_annotator_tpu_torch import so3
    from video_annotator_tpu_torch.io.prefetch import DevicePrefetcher
    from video_annotator_tpu_torch.io.video import VideoMeta, open_reader, open_writer
    from video_annotator_tpu_torch.pipeline.render import (
        FrameWarper,
        PairTracker,
        RenderOptions,
        build_cameras,
        render,
    )
    from video_annotator_tpu_torch.smoothing.savgol import smooth_rotations
    from video_annotator_tpu_torch.tools.soak import make_input, write_once

    dev = torch.device(device)
    w, h = 960, 720
    n = int(os.environ.get("VAT_E2E_FRAMES", "240"))
    tmp = tempfile.gettempdir()
    y4m = os.path.join(tmp, f"e2e_overlap_{w}x{h}_{n}.y4m")
    src = os.path.join(tmp, f"e2e_overlap_{w}x{h}_{n}.{source}")
    write_once(src, lambda part: make_input(part, n, w, h))

    # Stage rate 1: host decode alone.
    def decode_all():
        r = open_reader(src)
        frames = [(y.copy(), u.copy(), v.copy()) for y, u, v in r]
        r.close()
        return frames

    t0 = time.perf_counter()
    host_frames = decode_all()
    decode_fps = len(host_frames) / (time.perf_counter() - t0)

    # Stage rate 2: host-to-device feed alone, through the pipeline's
    # prefetcher, each plane consumed by a sum and one scalar read at the end.
    def feed_all():
        pre = DevicePrefetcher(iter(host_frames), depth=3, device=dev)
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        for y, u, v in pre:
            acc = acc + y.sum(dtype=torch.int64) + u.sum(dtype=torch.int64) + v.sum(
                dtype=torch.int64)
        pre.close()
        int(acc)

    feed_all()  # warm the transfer path
    feed_fps = n / _best_of(feed_all, trials=2, sleep=1.0)

    # Stage rate 3: the device's analyse and warp at the same geometry.
    meta = VideoMeta(w, h, Fraction(30, 1), n)
    opts = RenderOptions(stabilise="smooth", stabilise_radius=30, analysis_mode="paired")
    in_cam, out_cam = build_cameras(meta, opts)
    warper = FrameWarper(in_cam, out_cam, max_correction_deg=8.0, device=dev)
    dev_frames = [tuple(torch.from_numpy(p).to(dev) for p in f) for f in host_frames]
    stacks = paired_stacks([f[0] for f in dev_frames], opts.analysis_chunk)
    _sync(dev)

    def compute_all():
        rs = analyse_paired(PairTracker(meta, opts, dev), stacks, n)
        corr = so3.matmul(rs, smooth_rotations(rs, radius=30).transpose(-1, -2))
        _pipelined([functools.partial(
            warper.warp_yuv_batch, *(tuple(f[p] for f in dev_frames[i:i + BATCH])
                                     for p in range(3)), corr[i:i + BATCH])
            for i in range(0, n, BATCH)], dev)

    compute_all()  # warm-up
    compute_fps = n / _best_of(compute_all, trials=2, sleep=1.0)

    def _trial_fps(fn, trials, sleep=2.0):
        out = []
        for t in range(trials):
            t0 = time.perf_counter()
            fn()
            out.append(n / (time.perf_counter() - t0))
            if t < trials - 1:
                _pause(sleep)
        return out

    trials = min(int(os.environ.get("VAT_E2E_TRIALS", "5")), TRIALS)
    dev_opts = RenderOptions(stabilise="smooth", stabilise_radius=30, analysis_mode="paired",
                             streaming=True, no_output=True, device_sink=True,
                             max_correction_deg=8.0)

    def run(path, options):
        render(path, None, options, device=dev)

    def write_y4m(part):
        sink = open_writer(part, meta)
        for f in host_frames:
            sink.write(f)
        sink.close()

    write_once(y4m, write_y4m)
    encoded = source != "y4m"
    ratios, dev_fps, y4m_fps = [], [], []
    if encoded:
        run(src, dev_opts)  # warm
    run(y4m, dev_opts)  # warm
    for t in range(trials):
        if encoded:
            t0 = time.perf_counter()
            run(src, dev_opts)
            dev_fps.append(n / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        run(y4m, dev_opts)
        y4m_fps.append(n / (time.perf_counter() - t0))
        if encoded:
            ratios.append(dev_fps[-1] / y4m_fps[-1])
        _pause(1.0)
    ratios.sort()
    e2e_y4m_fps = max(y4m_fps)
    e2e_device_fps = max(dev_fps) if encoded else e2e_y4m_fps
    sink_fps = dev_fps if encoded else y4m_fps

    # Context: the streaming render with every output frame read back.
    e2e_opts = dataclasses.replace(dev_opts, device_sink=False)
    run(src, e2e_opts)  # warm
    rb_fps = _trial_fps(lambda: run(src, e2e_opts), min(2, TRIALS))
    # The two-phase render of the same job.
    two_opts = dataclasses.replace(e2e_opts, streaming=False)
    run(src, two_opts)  # warm
    two_phase_fps = n / _best_of(lambda: run(src, two_opts), trials=2, sleep=2.0)

    bottleneck_fps = min(decode_fps, feed_fps, compute_fps)
    serial_model_fps = 1.0 / (1.0 / decode_fps + 1.0 / feed_fps + 1.0 / compute_fps)
    upload_overlap_ratio = e2e_device_fps / feed_fps
    link_limited = bool(e2e_device_fps < 0.95 * serial_model_fps)
    upload_overlap_ok = (None if link_limited else bool(
        upload_overlap_ratio >= 0.8 and e2e_device_fps > 1.05 * serial_model_fps))
    return _result(
        "e2e_decode_overlap_720p", e2e_device_fps, n, 30.0,
        {
            "geometry": f"{w}x{h}",
            "source": source,
            "trials": trials,
            "decode_only_fps": round(decode_fps, 2),
            "feed_only_fps": round(feed_fps, 2),
            "compute_only_fps": round(compute_fps, 2),
            "e2e_device_sink_fps": round(e2e_device_fps, 2),
            "e2e_device_sink_fps_spread": round(max(sink_fps) / min(sink_fps), 3),
            "serial_model_fps": round(serial_model_fps, 2),
            "upload_overlap_ratio": round(upload_overlap_ratio, 3),
            "link_limited": link_limited,
            "upload_overlap_ok": upload_overlap_ok,
            "e2e_readback_fps": round(max(rb_fps), 2),
            "e2e_readback_fps_spread": round(max(rb_fps) / min(rb_fps), 3),
            "e2e_rawfeed_fps": round(e2e_y4m_fps, 2),
            "e2e_rawfeed_fps_spread": round(max(y4m_fps) / min(y4m_fps), 3),
            "two_phase_fps": round(two_phase_fps, 2),
            "bottleneck_stage": (
                "feed" if bottleneck_fps == feed_fps else
                "decode" if bottleneck_fps == decode_fps else "compute"),
            "bottleneck_fps": round(bottleneck_fps, 2),
            "decode_hiding_ratio": round(ratios[len(ratios) // 2], 3) if ratios else None,
            "decode_hiding_ratio_range": ([round(ratios[0], 3), round(ratios[-1], 3)]
                                          if ratios else None),
        },
    )


# --------------------------------------------------------------------------
# 5. 8 x 4K60 multi-stream batched warp
# --------------------------------------------------------------------------

STREAMS, PER_STREAM, GROUPS = 8, 4, 4


def multistream(dev: torch.device, w: int = 3840, h: int = 2880):
    """``(run, frames)``: ``run()`` warps 8 streams x 4 frames of
    resident 4K YUV per dispatch through ``FrameWarper.warp_yuv_batch``,
    four dispatches, two in flight, and returns when all are done;
    ``frames`` is the frame count of one ``run``."""
    from video_annotator_tpu_torch import so3

    _, warper = stock_warper(w, h, dev)
    rng = np.random.default_rng(0)
    # One resident frame per stream (content does not affect warp cost);
    # per-stream, per-frame rotations.
    planes = [random_planes(rng, w, h, dev) for _ in range(STREAMS)]
    ys, us, vs = (tuple(p[i] for p in planes) * PER_STREAM for i in range(3))
    rots = [so3.exp(torch.from_numpy(
        (rng.normal(size=(STREAMS * PER_STREAM, 3)) * 0.01).astype(np.float32)).to(dev))
        for _ in range(GROUPS)]

    def run():
        _pipelined([functools.partial(warper.warp_yuv_batch, ys, us, vs, rots[g])
                    for g in range(GROUPS)], dev)

    return run, STREAMS * PER_STREAM * GROUPS


def h2d_gbps(dev: torch.device, w: int = 3840, h: int = 2880, reps: int = 4):
    """GB/s of a pinned-memory copy of one 4K YUV 4:2:0 frame set to the
    card (the prefetcher's path); None on the CPU."""
    if dev.type != "cuda":
        return None
    host = [torch.zeros(s, dtype=torch.uint8).pin_memory()
            for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    for p in host:
        p.to(dev, non_blocking=True)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        [p.to(dev, non_blocking=True) for p in host]
        torch.cuda.synchronize(dev)
    return (h * w * 3 // 2) * reps / (time.perf_counter() - t0) / 1e9


def bench_8x4k60_multistream(device="cuda"):
    dev = torch.device(device)
    run, n = multistream(dev)
    run()  # warm-up
    dt = _best_of(run)
    feed_bw = h2d_gbps(dev)
    agg_fps = n / dt
    return _result(
        "8x4k60_multistream", agg_fps, n, 60.0 * STREAMS,
        {
            "streams": STREAMS,
            "per_stream_fps": round(agg_fps / STREAMS, 2),
            "h2d_GBps": None if feed_bw is None else round(feed_bw, 3),
        },
    )


CONFIGS = {
    "720p_undistort_cpu": bench_720p_undistort_cpu,
    "1080p_sparse_flow": bench_1080p_sparse_flow,
    "1080p_full_pipeline": bench_1080p_full_pipeline,
    "4k_gyro_fused": bench_4k_gyro_fused,
    "4k_visual_full_pipeline": bench_4k_visual_full_pipeline,
    "4k_visual_full_pipeline_detect0": functools.partial(
        bench_4k_visual_full_pipeline, detect_level=0, tag="_detect0"),
    "e2e_decode_overlap_720p": bench_e2e_decode_overlap,
    "8x4k60_multistream": bench_8x4k60_multistream,
}


def config_device(name: str, device: str) -> str:
    """The device a config's child runs on: the CPU for ``*_cpu``."""
    return "cpu" if name.endswith("_cpu") else device


def main(argv=None) -> int:
    global TRIALS, TRIAL_SLEEP
    ap = argparse.ArgumentParser(description="the benchmark configs on one card")
    ap.add_argument("--one", choices=sorted(CONFIGS), default=None,
                    help="run a single config in this process, print one JSON line")
    ap.add_argument("--configs", nargs="+", choices=list(CONFIGS), default=list(CONFIGS),
                    help="the configs to run, each in a child process (default: all)")
    ap.add_argument("--trials", type=int, default=TRIALS, help="trials of each timing")
    ap.add_argument("--sleep", type=float, default=TRIAL_SLEEP,
                    help="seconds between trials (at most)")
    ap.add_argument("--source", choices=("mp4", "y4m"), default="mp4",
                    help="e2e_decode_overlap_720p's input: an H.264 MP4 through the native "
                         "writer (default), or the y4m alone")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; exits 1 without a card) or cpu (the plain versions)")
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "run.json"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("run: no CUDA device (--device cpu runs the plain versions)", file=sys.stderr)
        return 1
    TRIALS, TRIAL_SLEEP = max(1, args.trials), max(0.0, args.sleep)

    if args.one:
        from video_annotator_tpu_torch.ops import cuda_lib, lk_kernel

        kw = {"source": args.source} if args.one.startswith("e2e") else {}
        device = config_device(args.one, args.device)
        for k in (*cuda_lib.KERNELS.values(), lk_kernel.PLAIN_LEVEL):
            k.launches = 0
        result = CONFIGS[args.one](device=device, **kw)
        # What the config launched, warm-up and trials included.
        result["launches"] = {k.name: k.launches
                              for k in (*cuda_lib.KERNELS.values(), lk_kernel.PLAIN_LEVEL)
                              if k.launches}
        print(json.dumps(stamp(result, device)), flush=True)
        return 0

    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    results = []
    failed = False
    for name in args.configs:
        print(f"=== {name}", file=sys.stderr, flush=True)
        proc = subprocess.run(
            [sys.executable, "-m", "video_annotator_tpu_torch.tools.run", "--one", name,
             "--device", config_device(name, args.device), "--trials", str(TRIALS),
             "--sleep", str(TRIAL_SLEEP), "--source", args.source],
            capture_output=True, text=True, timeout=3600, env=env)
        line = next((ln for ln in reversed(proc.stdout.splitlines()) if ln.startswith("{")),
                    None)
        if proc.returncode != 0 or line is None:
            print(proc.stderr[-3000:], file=sys.stderr)
            results.append({"config": name, "error": proc.returncode})
            failed = True
            continue
        results.append(json.loads(line))
        print(line, file=sys.stderr, flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=2) + "\n")
    print(json.dumps(results))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
