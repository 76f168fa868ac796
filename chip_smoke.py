"""Drive the PyTorch/CUDA port's render paths once on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card::

    python3 chip_smoke.py

Phases (each synchronises the device; any failure exits non-zero before
the last line is printed):

1. Device and build: the card's name and power limit, torch and CUDA
   versions; the CUDA kernels built from ``csrc/`` with ``nvcc`` for
   ``sm_90a`` (build seconds and the ``-Xptxas -v`` report).
2. Each kernel against its plain PyTorch version on the same card inputs
   at the main paths' shapes, both timed with CUDA events, beside the
   kernel's bound: K1 on a 4K warp batch; K3 and K2's pairs form on one
   17-frame LK chunk at 1920x1440 with 200 corners per frame; K2's
   per-frame form on one 4K pair box-downsampled to 1920x1440 with the
   tracker's 200 corners.
3. Renders through the CLI on a 64-frame 3840x2880 synthetic clip, each
   with every launch count set to 0 just before it and read just after:
   a. the stock ``render --stabilise smooth`` (``--analysis-mode auto``,
      which must resolve to paired): every kernel of the path launched,
      64 frames of the expected size, the trajectory within 0.1 deg RMS
      of the synthetic ground truth, a written frame within one count of
      the plain warp of its source frame;
   b. the same with ``--streaming``: mode paired, trajectory within 1e-5
      rad of (a), the first, middle and last frames within one count of
      (a)'s;
   c. ``--analysis-mode tracked -a``: the trajectory within 0.1 deg RMS
      of the ground truth, through K2's per-frame form;
   d. ``--streaming --analysis-mode tracked --smoother kalman
      --stabilise-radius 15``: 64 frames of the expected size, the
      trajectory within 1e-5 rad of (c).
4. Where tracked analyse spends its time at 4K: host wall time per step
   and per span of ``Tracker.step``, then kernel launches and device time
   per step from torch.profiler; and the fixed-lag Kalman smoother of one
   streaming batch on the host (as the port runs it) and on the card.
5. A JSON line of per-kernel results, then the device line.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from video_annotator_tpu_torch import cli, so3
from video_annotator_tpu_torch.camera import CameraPreset
from video_annotator_tpu_torch.io.synthetic import SyntheticSource, render_frame
from video_annotator_tpu_torch.io.video import open_reader
from video_annotator_tpu_torch.ops import cuda_lib, lk_kernel, stage, warp_kernel
from video_annotator_tpu_torch.ops.corners import detect_corners
from video_annotator_tpu_torch.ops.lk import build_pyramid
from video_annotator_tpu_torch.ops.warp_plain import box_downsample
from video_annotator_tpu_torch.pipeline import render as trender
from video_annotator_tpu_torch.pipeline import streaming
from video_annotator_tpu_torch.pipeline.profiler import StageProfiler
from video_annotator_tpu_torch.pipeline.trajectory import Trajectory, trajectory_path
from video_annotator_tpu_torch.smoothing.kalman import smooth_rotations_kalman

W, H = 3840, 2880
FRAMES = 64
PRESET = "gopro_h4b_wide43_measured"
SOURCE = f"synthetic://shaky?w={W}&h={H}&n={FRAMES}"
WARP_FRAMES = 4
LK_CHUNK = 17
LK_ITERS = 8
MAX_RMS_DEG = 0.1
MIN_EQUAL = 0.999
MIN_STATUS_AGREEMENT = 0.99
FLOW_ATOL = 0.01
TRAJ_ATOL_RAD = 1e-5
PROFILE_FRAMES = 8

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# FLOP/s outside the tensor cores. A bound is the larger of bytes / rate
# and operations / rate for the work of one timed call.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Operations per item, counted from the kernels' sources (an FMA is 2):
# K1's map (ray, rotation, perspective divide, fisheye polynomial, atanf
# and sqrtf as one each, bounds tests) per output pixel, and its bilinear
# taps and rounding per plane; K3's round and clamp per source element;
# K2's template build (24 x 23 bilinear samples), Scharr gradients and
# normal-matrix sums over the 441 template elements, and per Newton
# iteration a bilinear sample, the residual and two sums per element.
WARP_MAP_OPS = 45
WARP_TAP_OPS = 20
STAGE_OPS = 3
LK_TEMPLATE_OPS = 24 * 23 * 9 + 441 * 26
LK_ITER_OPS = 441 * 14
# K2 bytes per point: its prev template footprint (25 x 24), one next
# patch (23 x 23), its 6 float and 4 int arguments and 3 float results.
LK_POINT_BYTES = 25 * 24 + 23 * 23 + 6 * 4 + 4 * 4 + 3 * 4


def log(msg: str = "") -> None:
    print(msg, flush=True)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take for ``nbytes`` moved and
    ``ops`` float32 operations, and which of the two binds."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def lk_bound(points: int, iters: int) -> dict:
    return bound(points * LK_POINT_BYTES,
                 points * (LK_TEMPLATE_OPS + iters * LK_ITER_OPS))


def u8_agreement(got: torch.Tensor, want: torch.Tensor):
    d = (got.to(torch.int16) - want.to(torch.int16)).abs()
    return int(d.max()), float((d == 0).float().mean())


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase_build():
    t0 = time.perf_counter()
    built = cuda_lib.build()
    cuda_lib.library()
    if not built.log:
        log(f"[build] {built.path.name}: reused, built earlier from the same "
            f"sources (load {time.perf_counter() - t0:.1f} s)")
        return
    log(f"[build] {built.path.name}: nvcc {built.seconds:.1f} s "
        f"(load total {time.perf_counter() - t0:.1f} s)")
    log("[build] nvcc -Xptxas -v:")
    for line in built.log.strip().splitlines():
        log("    " + line)


def stock_options(**kw):
    return trender.RenderOptions(stabilise="smooth", preset=CameraPreset(PRESET), **kw)


def stock_cameras():
    meta = trender.VideoMeta(W, H, 30, FRAMES)
    in_cam, out_cam = trender.build_cameras(meta, stock_options())
    return trender.FrameWarper(in_cam, out_cam)


def source_lumas(dev, n: int) -> torch.Tensor:
    cfg = SyntheticSource.from_uri(SOURCE).config
    cam = cfg.camera()
    rots = torch.from_numpy(cfg.rotations()[:n]).to(dev)
    return torch.stack([render_frame(cam, r)[0] for r in rots])


def phase_warp(dev, results):
    warper = stock_cameras()
    cfg = SyntheticSource.from_uri(SOURCE).config
    cam = cfg.camera()
    rots_src = torch.from_numpy(cfg.rotations()[:WARP_FRAMES]).to(dev)
    planes = [render_frame(cam, r) for r in rots_src]
    ys = torch.stack([p[0] for p in planes])
    uv = torch.stack([torch.stack([p[1], p[2]]) for p in planes])
    g = torch.Generator().manual_seed(11)
    rots = so3.exp(torch.randn((WARP_FRAMES, 3), generator=g) * 0.02).to(dev)
    oh, ow = warper.out_h, warper.out_w
    modes = (
        ("warp_luma", ys[:, None], warper.out_cam, warper.in_cam, (oh, ow), 0.0),
        ("warp_chroma", uv, warper.out_half, warper.in_half, (oh // 2, ow // 2), 128.0),
    )
    for name, src, oc, ic, size, border in modes:
        got = warp_kernel.warp_planes_u8(src, rots, oc, ic, size, border)
        want = warp_kernel.warp_planes_u8_plain(src, rots, oc, ic, size, border)
        torch.cuda.synchronize()
        max_err, equal = u8_agreement(got, want)
        ms = cuda_ms(lambda: warp_kernel.warp_planes_u8(src, rots, oc, ic, size, border), 20)
        plain_ms = cuda_ms(
            lambda: warp_kernel.warp_planes_u8_plain(src, rots, oc, ic, size, border), 3, 1)
        t, c = src.shape[:2]
        b = bound(src.numel() + rots.numel() * 4 + got.numel(),
                  t * size[0] * size[1] * (WARP_MAP_OPS + c * WARP_TAP_OPS))
        log(f"[K1 {name}] {tuple(src.shape)} -> {tuple(got.shape)}: max |diff| "
            f"{max_err} count, equal {equal:.6f}; kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms per {WARP_FRAMES}-frame launch; bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
        check(max_err <= 1 and equal >= MIN_EQUAL, f"{name} disagrees with plain")
        results[name] = dict(max_abs_err=float(max_err), ms=ms, plain_ms=plain_ms, **b)


def lk_chunk(dev):
    """A 17-frame chunk as the paired analyse sees it: 4K frames
    box-downsampled to 1920x1440, 200 corners per frame detected at
    960x720 with the tracker's own gates."""
    frames = source_lumas(dev, LK_CHUNK)
    tracker = trender.PairTracker(trender.VideoMeta(W, H, 30, FRAMES), stock_options(), dev)
    grays = box_downsample(frames.to(torch.float32), tracker.level)
    det = box_downsample(grays[:-1], tracker.detect_level)
    pts, valid = detect_corners(det, max_corners=trender.MAX_CORNERS,
                                min_distance=tracker.det_md,
                                border=tracker.det_border)
    pts = pts * tracker.det_scale + (tracker.det_scale - 1.0) * 0.5
    return grays, pts, valid


def compare_lk_levels(tag, levels, pts, valid, launch, plain):
    """Run K2 coarse to fine over ``levels`` (prev, next, band) with each
    level's guess from the kernel's coarser level; compare every level
    with the plain version on the same arguments and time level 0."""
    flow = torch.zeros_like(pts)
    status = valid
    max_err, worst_agree, timing = 0.0, 1.0, None
    for lvl in range(len(levels) - 1, -1, -1):
        if levels[lvl] is None:
            continue
        prev, nxt, band = levels[lvl]
        scale = 2.0 ** lvl
        pf, pi, okw = lk_kernel.level_args(prev, pts / scale, band, flow / scale)
        k = launch(prev, nxt, pf, pi)
        p = plain(prev, nxt, pf, pi)
        torch.cuda.synchronize()
        kok, pok = (k[:, 2] > 0.5) & okw, (p[:, 2] > 0.5) & okw
        agree = float((kok == pok).float().mean())
        both = kok & pok
        err = float((k[:, :2] - p[:, :2])[both].abs().max()) if both.any() else 0.0
        log(f"[{tag}] level {lvl} {tuple(prev.shape)}, {pf.shape[0]} points: "
            f"status agreement {agree:.4f}, max |dflow| {err:.2e} px over "
            f"{int(both.sum())} tracked")
        max_err, worst_agree = max(max_err, err), min(worst_agree, agree)
        if lvl == 0:
            timing = (cuda_ms(lambda: launch(prev, nxt, pf, pi), 20),
                      cuda_ms(lambda: plain(prev, nxt, pf, pi), 3, 1),
                      lk_bound(pf.shape[0], LK_ITERS))
        flow = k[:, :2] * scale
        status = status & kok
    ms, plain_ms, b = timing
    log(f"[{tag}] level 0 kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{b['bound_ms']:.5f} ms ({b['bound_by']}); {int(status.sum())} of "
        f"{status.numel()} points tracked through all levels")
    check(worst_agree >= MIN_STATUS_AGREEMENT, f"{tag} status disagrees with plain")
    check(max_err <= FLOW_ATOL, f"{tag} flow disagrees with plain")
    check(int(status.sum()) > status.numel() // 2, f"{tag} tracked too few points")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, **b)


def phase_stage_lk(dev, results):
    grays, pts, valid = lk_chunk(dev)
    # K3 on the level-0 stack (the largest) and on every level.
    got = stage.stage_u8(grays, slack=lk_kernel.SLACK_ROWS)
    want = stage.stage_u8_plain(grays, slack=lk_kernel.SLACK_ROWS)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "stage kernel is not bit-exact")
    staged = lk_kernel.stage_pyramid_pairs(grays)
    for level, stack in zip(build_pyramid(grays), staged):
        if stack is not None:
            check(torch.equal(stack, stage.stage_u8_plain(level, slack=lk_kernel.SLACK_ROWS)),
                  "stage kernel is not bit-exact on a pyramid level")
    ms = cuda_ms(lambda: stage.stage_u8(grays, slack=lk_kernel.SLACK_ROWS), 20)
    plain_ms = cuda_ms(lambda: stage.stage_u8_plain(grays, slack=lk_kernel.SLACK_ROWS), 5)
    b = bound(grays.numel() * 4 + got.numel(), grays.numel() * STAGE_OPS)
    log(f"[K3 stage] {tuple(grays.shape)} f32 -> {tuple(got.shape)} u8: bit-exact "
        f"on all {sum(s is not None for s in staged)} levels; kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    results["stage"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, **b)

    # K2, pairs form: every pair of the chunk in one launch per level.
    p_, n_ = pts.shape[:2]
    band = torch.arange(p_, device=dev).repeat_interleave(n_)
    levels = [None if s is None else (s, s, band) for s in staged]
    results["lk_level"] = compare_lk_levels(
        "K2 lk_level", levels, pts.reshape(-1, 2), valid.reshape(-1),
        lambda s, _, pf, pi: lk_kernel.lk_level(s, pf, pi, LK_ITERS),
        lambda s, _, pf, pi: lk_kernel.lk_level_plain(s, s, pf, pi, LK_ITERS))


def tracked_options(**kw):
    return stock_options(analysis_mode="tracked", **kw)


def phase_lk_frame(dev, results):
    """K2's per-frame form on one 4K pair at tracking resolution, with the
    tracker's own corners (200, track-resolution gates)."""
    frames = source_lumas(dev, 2)
    tracker = trender.Tracker(trender.VideoMeta(W, H, 30, FRAMES), tracked_options(), dev)
    pts, valid, (_, prev) = tracker.detect(frames[0])
    _, _, (gray, nxt) = tracker.detect(frames[1])
    log(f"[K2 lk_level_frame] pair at {tuple(gray.shape)}, {int(valid.sum())} corners")
    levels = [None if a is None else (a, b, None) for a, b in zip(prev, nxt)]
    results["lk_level_frame"] = compare_lk_levels(
        "K2 lk_level_frame", levels, pts, valid,
        lambda a, b, pf, pi: lk_kernel.lk_level_frame(a, b, pf, pi, LK_ITERS),
        lambda a, b, pf, pi: lk_kernel.lk_level_plain(a, b, pf, pi, LK_ITERS))


def rms_vs_truth(traj: Trajectory) -> float:
    cfg = SyntheticSource.from_uri(SOURCE).config
    r_true = torch.from_numpy(cfg.rotations())
    r_expect = so3.matmul(so3.transpose(r_true), r_true[0])
    est = torch.from_numpy(traj.rotations())
    err = so3.log(so3.matmul(est, so3.transpose(r_expect[: len(est)])))
    return math.degrees(float(torch.sqrt((err.norm(dim=-1) ** 2).mean())))


def drive(name, argv, label, needs):
    """One CLI render with every launch count at 0 just before it; check
    that each kernel of ``needs`` launched. Returns the launch counts, the
    resolved analysis mode and the stage times."""
    seen = {}
    orig = (trender.analyse, trender.encode, streaming.render_streaming,
            trender.resolve_analysis_mode)

    def timed(key, fn, prof_arg):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seen[key] = time.perf_counter() - t0
            seen["profiler"] = args[prof_arg]
            return out
        return wrapper

    def resolve(options, device):
        seen["mode"] = orig[3](options, device)
        return seen["mode"]

    # analyse(source, options, prof), encode(source, dest, traj, options,
    # prof), render_streaming(source, dest, options, prof).
    trender.analyse = timed("analyse", orig[0], 2)
    trender.encode = timed("encode", orig[1], 4)
    streaming.render_streaming = timed("streaming", orig[2], 3)
    trender.resolve_analysis_mode = streaming.resolve_analysis_mode = resolve
    for k in cuda_lib.KERNELS.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv)
    finally:
        (trender.analyse, trender.encode, streaming.render_streaming,
         trender.resolve_analysis_mode) = orig
        streaming.resolve_analysis_mode = orig[3]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in cuda_lib.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"[{name}] cli.main returned {rc}")
    log(f"[{name}] {' '.join(argv[3:])}: analysis mode {seen.get('mode')!r}; "
        f"launches {launches}")
    for kname in needs:
        check(launches[kname] > 0, f"[{name}] kernel {kname} was not launched")
    secs, calls = seen["profiler"].all_totals()
    log(f"[{name}] per-stage host wall time ({label}), warm-up included:")
    for stage_name in secs:
        log(f"    {stage_name}: {secs[stage_name]:.3f} s over {calls[stage_name]} calls")
    rates = [f"{key} {FRAMES / seen[key]:.2f} fps ({seen[key]:.2f} s)"
             for key in ("analyse", "encode", "streaming") if key in seen]
    log(f"[{name}] {label}: {', '.join(rates)}, whole render {wall:.2f} s; peak "
        f"device memory {peak / 2**30:.2f} GiB")
    return launches, seen.get("mode")


def check_output_size(name, dest):
    meta = open_reader(dest).meta
    warper = stock_cameras()
    log(f"[{name}] output {meta.width}x{meta.height}, {meta.num_frames} frames")
    check((meta.width, meta.height, meta.num_frames) ==
          (warper.out_w, warper.out_h, FRAMES), f"[{name}] output has the wrong size")


def check_same_trajectory(name, got: Trajectory, want: Trajectory):
    err = float(np.abs(got.params - want.params).max())
    log(f"[{name}] trajectory max |d rotvec| {err:.3e} rad against the reference run")
    check(got.num_frames == want.num_frames == FRAMES and err <= TRAJ_ATOL_RAD,
          f"[{name}] trajectory differs")


def check_frame_vs_plain(dest, traj, dev):
    """One written frame against the plain warp of its source frame."""
    warper = stock_cameras()
    t = FRAMES // 2 + 3
    corr = trender.compute_corrections(traj, stock_options(), dev)
    src = SyntheticSource.from_uri(SOURCE, device=dev)
    for i, planes in enumerate(src):
        if i == t:
            break
    rot = torch.from_numpy(corr[t:t + 1]).to(dev)
    y, u, v = (torch.from_numpy(np.array(p)).to(dev) for p in planes)
    want_y = warp_kernel.warp_planes_u8_plain(
        y[None, None], rot, warper.out_cam, warper.in_cam,
        (warper.out_h, warper.out_w), 0.0)[0, 0]
    want_uv = warp_kernel.warp_planes_u8_plain(
        torch.stack([u, v])[None], rot, warper.out_half, warper.in_half,
        (warper.out_h // 2, warper.out_w // 2), 128.0)[0]
    for i, written in enumerate(open_reader(dest)):
        if i == t:
            break
    for name, got, want in (("y", written[0], want_y), ("u", written[1], want_uv[0]),
                            ("v", written[2], want_uv[1])):
        err, equal = u8_agreement(torch.from_numpy(np.array(got)).to(dev), want)
        log(f"[render] frame {t} plane {name}: max |diff| {err}, equal {equal:.6f}")
        check(err <= 1, f"written frame {t} plane {name} differs from the plain warp")


def check_same_frames(name, got_path, want_path, dev):
    """The first, middle and last frames within one count, >= 99.9% equal."""
    which = (0, FRAMES // 2, FRAMES - 1)
    for i, (a, b) in enumerate(zip(open_reader(got_path), open_reader(want_path))):
        if i not in which:
            continue
        for plane, pa, pb in zip("yuv", a, b):
            err, equal = u8_agreement(torch.from_numpy(np.array(pa)).to(dev),
                                      torch.from_numpy(np.array(pb)).to(dev))
            log(f"[{name}] frame {i} plane {plane}: max |diff| {err}, equal {equal:.6f}")
            check(err <= 1 and equal >= MIN_EQUAL, f"[{name}] frame {i} differs")


def phase_renders(dev, label):
    """The four renders; returns the launch counts summed over them."""
    total = {n: 0 for n in cuda_lib.KERNELS}
    warp_stage = ("warp_luma", "warp_chroma", "stage")
    tmp = tempfile.mkdtemp(prefix="vat_torch_smoke_")
    base = ["render", SOURCE]
    stock = ["--stabilise", "smooth", "--preset", PRESET]
    tracked = stock + ["--analysis-mode", "tracked"]

    def run(name, dest, flags, needs):
        launches, mode = drive(name, base + [dest] + flags, label, needs)
        for n, c in launches.items():
            total[n] += c
        return mode

    try:
        two = os.path.join(tmp, "two.y4m")
        mode = run("render", two, stock, warp_stage + ("lk_level",))
        check(mode == "paired", "analysis mode did not resolve to paired")
        check_output_size("render", two)
        traj_two = Trajectory.load(trajectory_path(two))
        rms = rms_vs_truth(traj_two)
        log(f"[render] trajectory RMS vs ground truth {rms:.4f} deg")
        check(traj_two.num_frames == FRAMES and rms < MAX_RMS_DEG, "trajectory is off")
        check_frame_vs_plain(two, traj_two, dev)

        one = os.path.join(tmp, "one.y4m")
        mode = run("streaming", one, stock + ["--streaming"], warp_stage + ("lk_level",))
        check(mode == "paired", "streaming analysis mode did not resolve to paired")
        check_output_size("streaming", one)
        check_same_trajectory("streaming", Trajectory.load(trajectory_path(one)), traj_two)
        check_same_frames("streaming", one, two, dev)
        os.remove(one)
        os.remove(two)

        analysed = os.path.join(tmp, "tracked.y4m")
        run("tracked", analysed, tracked + ["-a"], ("stage", "lk_level_frame"))
        traj_tracked = Trajectory.load(trajectory_path(analysed))
        rms = rms_vs_truth(traj_tracked)
        log(f"[tracked] trajectory RMS vs ground truth {rms:.4f} deg")
        check(traj_tracked.num_frames == FRAMES and rms < MAX_RMS_DEG,
              "tracked trajectory is off")

        kalman = os.path.join(tmp, "kalman.y4m")
        run("tracked-kalman-streaming", kalman,
            tracked + ["--streaming", "--smoother", "kalman", "--stabilise-radius", "15"],
            warp_stage + ("lk_level_frame",))
        check_output_size("tracked-kalman-streaming", kalman)
        check_same_trajectory("tracked-kalman-streaming",
                              Trajectory.load(trajectory_path(kalman)), traj_tracked)
        os.remove(kalman)
        return total
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def phase_tracked_profile(dev, label):
    """Where tracked analyse spends its time at 4K, over PROFILE_FRAMES
    steps of ``Tracker.push`` after warm-up: host wall time and
    status-count host syncs per step, the host time of each of the
    step's own spans, then the same steps under torch.profiler."""
    frames = source_lumas(dev, 2 * PROFILE_FRAMES + 3)
    tracker = trender.Tracker(trender.VideoMeta(W, H, 30, FRAMES), tracked_options(), dev)
    for y in frames[:3]:  # detect + warm-up steps
        tracker.push(y)
    torch.cuda.synchronize()
    syncs = tracker.host_syncs
    tracker.profiler = StageProfiler(warmup=0)
    t0 = time.perf_counter()
    for y in frames[3:3 + PROFILE_FRAMES]:
        tracker.push(y)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_FRAMES
    log(f"[tracked profile] {label}: {wall_ms:.3f} ms per step host wall, "
        f"{(tracker.host_syncs - syncs) / PROFILE_FRAMES:.2f} status-count host "
        f"syncs per step; the step's spans, host ms per step (enqueue time, "
        f"except 'key frame', whose status read waits for the device):")
    secs, _ = tracker.profiler.totals()
    for name, total in secs.items():
        log(f"    {name}: {total * 1e3 / PROFILE_FRAMES:.3f} ms")
    log(f"    corner detection alone, as on a key frame: "
        f"{host_ms(lambda: tracker.detect(frames[0])):.3f} ms")
    trace_steps(tracker, frames[3 + PROFILE_FRAMES:], wall_ms)


def phase_kalman_window(dev, label):
    """The fixed-lag Kalman smoother of one streaming batch (32 frames and
    a radius of 15 on each side): on the host with the window copied each
    way, as the port runs it, against the same loop on the card."""
    g = torch.Generator().manual_seed(13)
    window = so3.exp(torch.cumsum(torch.randn((32 + 2 * 15, 3), generator=g) * 0.01, 0)).to(dev)
    host = trender._kalman_virtual(window)
    card = smooth_rotations_kalman(window)
    err = float((host - card).abs().max())
    host_call = host_ms(lambda: trender._kalman_virtual(window))
    card_call = host_ms(lambda: smooth_rotations_kalman(window))
    log(f"[kalman window] {tuple(window.shape)} on {label}: host round trip "
        f"{host_call:.3f} ms, on the card {card_call:.3f} ms per batch (host "
        f"wall, synchronised, idle device); max |diff| {err:.2e}")
    check(err <= 1e-4, "the Kalman smoother differs between host and card")


def trace_steps(tracker, frames, wall_ms):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for y in frames:
            tracker.push(y)
        torch.cuda.synchronize()
    events = prof.key_averages()
    n = len(frames)
    launches = sum(e.count for e in events if "LaunchKernel" in e.key)
    busy_ms = sum(_device_us(e) for e in events) / 1e3 / n
    log(f"[tracked profile] traced: {launches / n:.1f} kernel launches per frame")
    if busy_ms <= 0:
        log("[tracked profile] device busy time: not measured (the profiler "
            "reported no device time)")
        return
    log(f"[tracked profile] device busy {busy_ms:.3f} ms per frame under the "
        f"profiler; device idle share of the untraced wall "
        f"{max(0.0, 1.0 - busy_ms / wall_ms):.3f}")
    for e in sorted(events, key=_device_us, reverse=True)[:10]:
        if _device_us(e) > 0:
            log(f"    {_device_us(e) / 1e3 / n:8.4f} ms/frame  "
                f"{e.count / n:5.1f}/frame  {e.key[:90]}")
    # The port's own kernels on this path, device time per launch (CUDA
    # events over back-to-back launches of a kernel this small measure the
    # host's launch rate instead).
    for e in events:
        if "lk_level_kernel" in e.key or "stage_kernel" in e.key:
            log(f"    {e.key[:60]}: {_device_us(e) / e.count / 1e3:.4f} ms device per "
                f"launch, {e.count / n:.1f} launches per frame")


def host_ms(fn, reps: int = 5) -> float:
    """Host wall ms per call of ``fn``, synchronised, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def main(argv=None) -> int:
    if sys.argv[1:] if argv is None else argv:
        print("usage: python3 chip_smoke.py", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    label = card_label()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(label)  # name, power limit: as nvidia-smi prints them
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    phase_build()
    results = {}
    phase_warp(dev, results)
    phase_stage_lk(dev, results)
    phase_lk_frame(dev, results)
    log(f"[kernels] times above measured on {label}")
    launches = phase_renders(dev, label)
    phase_tracked_profile(dev, label)
    phase_kalman_window(dev, label)
    log(f"[smoke] all phases passed in {time.perf_counter() - t0:.1f} s")
    kernels = []
    for name, k in cuda_lib.KERNELS.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
