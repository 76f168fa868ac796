"""Single-pass streaming render: decode once, bounded-lookahead smoothing.

Port of ``video_annotator_tpu/pipeline/streaming.py``. Frames and their
measured rotations queue in a lookahead ring until ``radius`` future
frames exist; each batch of ``--warp-batch`` frames is then smoothed with
:func:`make_window_corrections` over a clamp-replicated window, warped
(K1) and written as it leaves the ring. At EOF the rest of the ring
smooths against the replicated last rotation. The windows and the
replicate padding are those of the two-phase ``compute_corrections``, so
the output equals the two-phase render's (within one count: that path
re-exponentiates the saved rotation vectors). The radius shrinks like
the two-phase one for clips shorter than the window, decided at the first
emission.

Either analyser tracks inside the ring through its ``push`` and
``finish``: ``--analysis-mode paired`` (:class:`PairTracker`) buffers
arriving frames into groups of ``--analysis-chunk`` and tracks each in one
batched pass keyed by the global pair index, so the trajectory is the
two-phase paired analyse's; ``tracked`` (:class:`Tracker`) tracks frame by
frame.

The ring holds ``radius + warp_batch`` decoded YUV frames on the device
(about 17 MB a frame at 3840x2880). The corrections are not known up
front, so the ``--prefilter auto`` level map probes the JAX package's
budget: ``--max-correction`` plus the attitude plus, under
``--horizon-lock``, the initial tilt and 2 degrees. The JAX package's
check of each batch's correction against that budget is dropped: it
guarded the Pallas kernel's source windows, and K1 reads the whole
source plane.

``--horizon-lock`` tracks even with ``--stabilise none`` (the lock needs
the measured attitude) and takes world-up from the source's telemetry
where it has any, else the first frame as level.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from video_annotator_tpu_torch import so3
from video_annotator_tpu_torch.io.prefetch import DeviceReduceSink
from video_annotator_tpu_torch.io.video import VideoMeta
from video_annotator_tpu_torch.pipeline.profiler import Progress, StageProfiler
from video_annotator_tpu_torch.pipeline.render import (
    DEFAULT_WARP_BATCH,
    FrameWarper,
    PairTracker,
    RenderOptions,
    Tracker,
    TrimmedFrames,
    _estimate_up0,
    build_cameras,
    make_window_corrections,
    max_rotation_deg,
    open_sink,
    open_trimmed,
    output_fps,
    resolve_analysis_mode,
)
from video_annotator_tpu_torch.pipeline.trajectory import Trajectory, trajectory_path

# The Kalman filter's memory is about (r_noise / q_noise) ** (1/4) = 10
# frames: a fixed-lag window shorter than that would seam at batch edges.
KALMAN_MIN_RADIUS = 10


def streaming_budget_deg(options: RenderOptions, up0) -> float:
    """The correction angle the prefilter's level map probes when the
    corrections are not known up front: ``--max-correction``, the largest
    rotation of the ``--roll/--pitch/--yaw`` attitude and, under
    ``--horizon-lock``, the tilt of the initial up vector plus 2 degrees
    (JAX ``streaming.py:119-142``)."""
    attitude = so3.from_euler(np.radians(options.roll), np.radians(options.pitch),
                              np.radians(options.yaw))
    attitude_deg = max_rotation_deg(attitude[None].cpu().numpy())
    lock_deg = 0.0
    if options.horizon_lock:
        u = np.asarray([0.0, -1.0, 0.0] if up0 is None else up0, np.float64)
        lock_deg = float(np.degrees(np.arccos(np.clip(-u[1], -1.0, 1.0)))) + 2.0
    return options.max_correction_deg + attitude_deg + lock_deg


def render_streaming(source: str, dest: Optional[str],
                     options: Optional[RenderOptions] = None,
                     profiler: Optional[StageProfiler] = None,
                     device="cuda") -> VideoMeta:
    """One-pass track + smooth + warp + write with a lookahead window."""
    options = options or RenderOptions()
    prof = profiler or StageProfiler()
    if options.analyse_only or options.encode_only:
        raise ValueError("--streaming is single-pass; drop -a/-c")
    if options.stabilise == "smooth" and options.smoother not in ("savgol", "kalman"):
        raise ValueError(f"unknown smoother {options.smoother!r} for --streaming")
    if (options.stabilise == "smooth" and options.smoother == "kalman"
            and options.stabilise_radius < KALMAN_MIN_RADIUS):
        raise ValueError(
            f"--streaming --smoother kalman needs --stabilise-radius >= "
            f"{KALMAN_MIN_RADIUS} (the fixed-lag window must cover the "
            f"constant-velocity filter's ~10-frame memory; below it the "
            f"smoother would seam at batch boundaries) -- use --smoother "
            f"savgol for shorter lookahead or the two-phase path for the "
            f"global RTS")
    mode = resolve_analysis_mode(options, device)
    dev = torch.device(device)
    with prof.stage("open"):
        reader, meta, first, last = open_trimmed(source, options, dev)
        # stabilise none without a horizon lock needs no measured attitude:
        # the tracker is skipped and the corrections are the attitude alone.
        needs_motion = options.stabilise != "none" or options.horizon_lock
        tracker = None
        if needs_motion:
            tracker = (PairTracker if mode == "paired" else Tracker)(meta, options, dev, prof)
        in_cam, out_cam = build_cameras(meta, options)
        up0 = (_estimate_up0(source, float(first) / float(meta.fps), dev)
               if options.horizon_lock else None)
        warper = FrameWarper(in_cam, out_cam, streaming_budget_deg(options, up0),
                             options.prefilter == "auto", options.interp, dev)
        n_expect = (last - first) if meta.num_frames else 0
        out_meta = VideoMeta(width=warper.out_w, height=warper.out_h,
                             fps=output_fps(options, meta), num_frames=n_expect)
        overlay = None
        if options.device_sink:
            # The frames fold into a checksum on the device: no readback, no
            # writer thread, none of the host wrappers (crop, HUD, preview).
            writer = DeviceReduceSink()
        else:
            def hud(sink):
                # The corrections come a batch at a time here, so the HUD is
                # text only: no curves over the whole clip to plot up front.
                nonlocal overlay
                from video_annotator_tpu_torch.pipeline.debug import DebugOverlayWriter

                overlay = DebugOverlayWriter(sink)
                return overlay
            writer = open_sink(source, dest, out_meta, options,
                               hud if options.debug else None, prof)
        source_frames = TrimmedFrames(reader, first, last, options, dev, prof)
    batch = max(1, int(options.warp_batch or DEFAULT_WARP_BATCH))
    want_radius = options.stabilise_radius if options.stabilise == "smooth" else 0

    frames: deque = deque()  # (y, u, v) device triples awaiting emission
    rots: list = []  # (3, 3) measured rotations, one per tracked frame
    emitted = 0
    batch_corr = None
    radius_eff = 0
    eye = torch.eye(3, dtype=torch.float32, device=dev)

    def emit(n: int):
        """Warp and write frames [emitted, emitted + n), n <= batch."""
        nonlocal emitted, batch_corr, radius_eff
        if batch_corr is None:
            # The first emission comes before EOF only if the clip outlasts
            # the window, so len(rots) - 1 caps the radius as in two-phase.
            if options.stabilise == "smooth":
                radius_eff = min(want_radius, max(len(rots) - 1, 1))
            batch_corr = make_window_corrections(radius_eff, options, up0)
        t0 = emitted
        last_i = len(rots) - 1
        window = torch.stack([rots[min(max(k, 0), last_i)]
                              for k in range(t0 - radius_eff, t0 + batch + radius_eff)])
        with prof.stage("smooth"):
            # The rotations as the trajectory file gives them back to the
            # two-phase encode (exp of the saved log, on the host), so both
            # paths smooth the same bits and render the same frames.
            corr = batch_corr(so3.exp(so3.log(window).cpu()))
        if overlay is not None:
            from video_annotator_tpu_torch.pipeline.debug import rotation_angles_deg

            degs = rotation_angles_deg(corr.cpu().numpy())
            for i in range(n):
                overlay.text[t0 + i] = f"frame {t0 + i}  correction {degs[i]:.2f} deg"
        ys, us, vs = zip(*([frames[i] for i in range(n)] + [frames[n - 1]] * (batch - n)))
        with prof.stage("warp"):
            outs = warper.warp_yuv_batch(ys, us, vs, corr)
        with prof.stage("encode"):
            for triple in outs[:n]:
                writer.write(triple)
        for _ in range(n):
            frames.popleft()
        emitted += n
        prog.tick(n)

    prog = Progress("render", total=n_expect or None)
    try:
        with source_frames:
            for y, u, v in source_frames:
                frames.append((y, u, v))
                with prof.stage("track"):
                    rots.extend(tracker.push(y) if tracker is not None else eye[None])
                # Emit every batch whose full lookahead window is present.
                while len(rots) - want_radius - emitted >= batch:
                    emit(batch)
        with prof.stage("track"):
            if tracker is not None:
                rots.extend(tracker.finish())
        while emitted < len(rots):
            emit(min(batch, len(rots) - emitted))
    except BaseException:
        try:
            writer.close()
        except Exception:
            pass
        raise
    prog.close()
    with prof.stage("encode"):
        writer.close()

    # The trajectory checkpoint, so a later --encode-only can reuse this
    # pass's analysis; an identity trajectory (stabilise none) is not saved.
    if dest and rots and needs_motion:
        with prof.stage("save"):
            rotvecs = so3.log(torch.stack(rots)).cpu().numpy().astype(np.float64)
            Trajectory(params=rotvecs, kind="so3", fps=meta.fps, width=meta.width,
                       height=meta.height, source=source,
                       up0=up0).save(trajectory_path(dest))
    return out_meta
