"""Drive the PyTorch/CUDA port's stock render path once on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card::

    python3 chip_smoke.py

Phases (each synchronises the device; any failure exits non-zero before
the last line is printed):

1. Device and build: the card's name and power limit, torch and CUDA
   versions; the CUDA kernels K1-K3 built from ``csrc/`` with ``nvcc``
   for ``sm_90a`` (build seconds and the ``-Xptxas -v`` report).
2. Each kernel against its plain PyTorch version on the same card inputs
   at the main path's shapes (4K warp batch, one 17-frame LK chunk at
   1920x1440 with 200 corners per frame, its staged pyramid), and both
   timed with CUDA events.
3. The stock ``render --stabilise smooth`` through the CLI on a 64-frame
   3840x2880 synthetic clip with ``--analysis-mode auto``: every kernel
   must have been launched, the output must hold 64 frames of the
   expected size, the trajectory must be within 0.1 deg RMS of the
   synthetic ground truth, and a written frame must match the plain warp
   of its source frame within one count.
4. A JSON line of per-kernel results, then the device line.
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
from video_annotator_tpu_torch.pipeline.trajectory import Trajectory, trajectory_path

W, H = 3840, 2880
FRAMES = 64
PRESET = "gopro_h4b_wide43_measured"
SOURCE = f"synthetic://shaky?w={W}&h={H}&n={FRAMES}"
WARP_FRAMES = 4
LK_CHUNK = 17
MAX_RMS_DEG = 0.1
MIN_EQUAL = 0.999
MIN_STATUS_AGREEMENT = 0.99
FLOW_ATOL = 0.01


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


def stock_cameras():
    meta = trender.VideoMeta(W, H, 30, FRAMES)
    opts = trender.RenderOptions(stabilise="smooth", preset=CameraPreset(PRESET))
    in_cam, out_cam = trender.build_cameras(meta, opts)
    return trender.FrameWarper(in_cam, out_cam)


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
        log(f"[K1 {name}] {tuple(src.shape)} -> {tuple(got.shape)}: max |diff| "
            f"{max_err} count, equal {equal:.6f}; kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms per {WARP_FRAMES}-frame launch")
        check(max_err <= 1 and equal >= MIN_EQUAL, f"{name} disagrees with plain")
        results[name] = dict(max_abs_err=float(max_err), ms=ms, plain_ms=plain_ms)


def lk_chunk(dev):
    """A 17-frame chunk as the analyse phase sees it: 4K frames
    box-downsampled to 1920x1440, 200 corners per frame detected at
    960x720 with the tracker's own gates."""
    cfg = SyntheticSource.from_uri(SOURCE).config
    cam = cfg.camera()
    rots = torch.from_numpy(cfg.rotations()[:LK_CHUNK]).to(dev)
    frames = torch.stack([render_frame(cam, r)[0] for r in rots])
    tracker = trender.PairTracker(
        trender.VideoMeta(W, H, 30, FRAMES),
        trender.RenderOptions(stabilise="smooth", preset=CameraPreset(PRESET)), dev)
    grays = box_downsample(frames.to(torch.float32), tracker.level)
    det = box_downsample(grays[:-1], tracker.detect_level)
    pts, valid = detect_corners(det, max_corners=trender.MAX_CORNERS,
                                min_distance=tracker.det_md,
                                border=tracker.det_border)
    pts = pts * tracker.det_scale + (tracker.det_scale - 1.0) * 0.5
    return grays, pts, valid


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
    log(f"[K3 stage] {tuple(grays.shape)} f32 -> {tuple(got.shape)} u8: bit-exact "
        f"on all {sum(s is not None for s in staged)} levels; kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms")
    results["stage"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms)

    # K2: every level of the chunk, kernel and plain on the same arguments
    # (each level's guess from the kernel's coarser level).
    p_, n_ = pts.shape[:2]
    flat = pts.reshape(-1, 2)
    band = torch.arange(p_, device=dev).repeat_interleave(n_)
    flow = torch.zeros_like(flat)
    status = valid.reshape(-1)
    max_err, worst_agree, timing = 0.0, 1.0, None
    for lvl in range(len(staged) - 1, -1, -1):
        stack = staged[lvl]
        if stack is None:
            continue
        scale = 2.0 ** lvl
        pf, pi, okw = lk_kernel.level_args(stack, flat / scale, band, flow / scale)
        k = lk_kernel.lk_level(stack, pf, pi, 8)
        p = lk_kernel.lk_level_plain(stack, pf, pi, 8)
        torch.cuda.synchronize()
        kok, pok = (k[:, 2] > 0.5) & okw, (p[:, 2] > 0.5) & okw
        agree = float((kok == pok).float().mean())
        both = kok & pok
        err = float((k[:, :2] - p[:, :2])[both].abs().max()) if both.any() else 0.0
        log(f"[K2 lk_level] level {lvl} {tuple(stack.shape)}, {pf.shape[0]} points: "
            f"status agreement {agree:.4f}, max |dflow| {err:.2e} px over "
            f"{int(both.sum())} tracked")
        max_err, worst_agree = max(max_err, err), min(worst_agree, agree)
        if lvl == 0:
            timing = (cuda_ms(lambda: lk_kernel.lk_level(stack, pf, pi, 8), 20),
                      cuda_ms(lambda: lk_kernel.lk_level_plain(stack, pf, pi, 8), 3, 1))
        flow = k[:, :2] * scale
        status = status & kok
    log(f"[K2 lk_level] level 0 kernel {timing[0]:.3f} ms, plain {timing[1]:.3f} ms; "
        f"{int(status.sum())} of {status.numel()} points tracked through all levels")
    check(worst_agree >= MIN_STATUS_AGREEMENT, "LK status disagrees with plain")
    check(max_err <= FLOW_ATOL, "LK flow disagrees with plain")
    check(int(status.sum()) > status.numel() // 2, "LK tracked too few points")
    results["lk_level"] = dict(max_abs_err=max_err, ms=timing[0], plain_ms=timing[1])


def rms_vs_truth(traj: Trajectory) -> float:
    cfg = SyntheticSource.from_uri(SOURCE).config
    r_true = torch.from_numpy(cfg.rotations())
    r_expect = so3.matmul(so3.transpose(r_true), r_true[0])
    est = torch.from_numpy(traj.rotations())
    err = so3.log(so3.matmul(est, so3.transpose(r_expect[: len(est)])))
    return math.degrees(float(torch.sqrt((err.norm(dim=-1) ** 2).mean())))


def phase_render(dev, label):
    tmp = tempfile.mkdtemp(prefix="vat_torch_smoke_")
    try:
        dest = os.path.join(tmp, "out.y4m")
        seen = {}
        orig_analyse, orig_encode = trender.analyse, trender.encode

        def timed(name, fn, prof_arg):
            def wrapper(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                seen[name] = time.perf_counter() - t0
                seen["profiler"] = args[prof_arg]
                return out
            return wrapper

        def resolve(options, device):
            seen["mode"] = orig_resolve(options, device)
            return seen["mode"]

        orig_resolve = trender.resolve_analysis_mode
        # render(source, dest, options, prof): analyse(source, options, prof),
        # encode(source, dest, traj, options, prof).
        trender.analyse = timed("analyse", orig_analyse, 2)
        trender.encode = timed("encode", orig_encode, 4)
        trender.resolve_analysis_mode = resolve
        for k in cuda_lib.KERNELS.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            rc = cli.main(["render", SOURCE, dest, "--stabilise", "smooth",
                           "--preset", PRESET])
        finally:
            trender.analyse, trender.encode = orig_analyse, orig_encode
            trender.resolve_analysis_mode = orig_resolve
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: k.launches for name, k in cuda_lib.KERNELS.items()}
        peak = torch.cuda.max_memory_allocated()
        check(rc == 0, f"cli.main returned {rc}")
        log(f"[render] analysis mode resolved to {seen['mode']!r}; launches {launches}")
        check(seen["mode"] == "paired", "analysis mode did not resolve to paired")
        for name, n in launches.items():
            check(n > 0, f"kernel {name} was not launched by the render")

        meta = open_reader(dest).meta
        warper = stock_cameras()
        log(f"[render] output {meta.width}x{meta.height}, {meta.num_frames} frames")
        check((meta.width, meta.height, meta.num_frames) ==
              (warper.out_w, warper.out_h, FRAMES), "output has the wrong size")
        traj = Trajectory.load(trajectory_path(dest))
        rms = rms_vs_truth(traj)
        log(f"[render] trajectory RMS vs ground truth {rms:.4f} deg")
        check(traj.num_frames == FRAMES and rms < MAX_RMS_DEG, "trajectory is off")

        # One written frame against the plain warp of its source frame.
        t = FRAMES // 2 + 3
        corr = trender.compute_corrections(
            traj, trender.RenderOptions(stabilise="smooth"), dev)
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

        secs, calls = seen["profiler"].all_totals()
        log(f"[render] per-stage host wall time ({label}), warm-up included:")
        for name in secs:
            log(f"    {name}: {secs[name]:.3f} s over {calls[name]} calls")
        log(f"[render] {label}: analyse {FRAMES / seen['analyse']:.2f} fps "
            f"({seen['analyse']:.2f} s), encode {FRAMES / seen['encode']:.2f} fps "
            f"({seen['encode']:.2f} s), whole render {wall:.2f} s; peak device "
            f"memory {peak / 2**30:.2f} GiB")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
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
    phase_build()
    results = {}
    phase_warp(dev, results)
    phase_stage_lk(dev, results)
    log(f"[kernels] times above measured on {label}")
    launches = phase_render(dev, label)
    kernels = []
    for name, k in cuda_lib.KERNELS.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
