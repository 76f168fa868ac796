"""Drive the PyTorch/CUDA port's render paths once on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card::

    python3 chip_smoke.py

Phases (each synchronises the device; any failure exits non-zero before
the last line is printed):

1. Device and build: the card's name and power limit, torch and CUDA
   versions; the CUDA kernels built from ``csrc/`` with ``nvcc`` for
   ``sm_90a`` (build seconds and the ``-Xptxas -v`` report); whether
   ``make -C native`` built the libav reader and writer (the make's last
   line where it did not).
2. Each kernel against its plain PyTorch version on the same card inputs
   at the main paths' shapes, both timed with CUDA events, beside the
   kernel's bound: K1's uint8 batch, luma and chroma, with one rotation
   per frame and one per tile row, on 4 and on 32 4K frames (the render's
   batch), each launch with 0 differing values from its plain version;
   K1's float mode on one 4K luma
   plane and on the two chroma planes of one frame (0 differing values); K1's one-frame uint8
   mode over identity pinhole cameras with a similarity matrix (0
   differing values from its plain version, and held within one count of
   ``warp_similarity``); K3 and K2's pairs form on one 17-frame LK
   chunk at 1920x1440 with 200 corners per frame; the pyramid kernel
   (``csrc/pyramid.cu``) on the cells' 17-frame chunks, 1920x1440
   integers and 1920x1080 quarters, at levels 1 and 2 (0 differing values
   from its plain twin, and from the two banded ``torch.matmul`` products
   where those are exact), timed beside both; the Wahba kernel
   (``csrc/wahba.cu``) on one refinement's 16 correlations, within 2e-6
   of its plain twin, the PyTorch chain it replaces, timed beside it with
   both queued behind a sleeping kernel; K2's per-frame form on
   one 4K pair box-downsampled to 1920x1440 with the tracker's 200
   corners, K2's level 0 timed over 100 launches queued behind a
   sleeping kernel. K1's per-tile-row rotation mode (the rolling-shutter
   form) through its one-frame and float entries at the same 4K shapes
   with (1, 440, 3, 3) stacks,
   each beside the time of the same launch with whole-frame rotations,
   and once with a stack shorter than ceil(out_h / 8) (the clipped row
   index). K1's variants in ``csrc/warp_modes.cu`` (``MODE_CASES``): the
   4-tap (lanczos), ray-grid (an equirect output of the stock canvas) and
   per-tile mip (``--prefilter auto --scale 0.4``: a 3840x2880 source to
   1872x1408) modes alone through every entry, with one rotation per frame
   and one per tile row, then bicubic and the combinations the renders of
   3l launch; each counted under its own kernel object alone, with 0
   differing values from its plain version, the kernel timed alone
   on prepared levels (the time to build the levels logged beside it).
   K1's float frame batch (row 6) at 8 4K frames and its band (row 9) for
   2, 3 and 4 ranks, bilinear, bicubic and with an equirect output: every
   launch with 0 differing values from its plain version, and the bands,
   concatenated and cropped, equal to the one-frame float launch; a
   band's kernel timed queued behind a sleeping kernel (its launch is
   shorter than its wrapper's host time) and bounded by the source rows
   its map reaches. The measurement path (rows 11 and 12, K1's
   diagnostic builds): each probe of ``csrc/roofline.cu`` against its
   plain version at outer 4 on the inputs that ``tools/roofline.py``
   launches it on, 1 and 528 tiles (0 differing values, the fused chain
   too), each of K1's three diagnostic builds against its plain twin on
   the 4- and 16-frame 4K batches that the tool launches (0 differing
   values);
   then, with every launch count at 0 just before and read just after,
   ``tools/roofline.py``'s measurements (the FMA and gather rates on one
   SM and card-wide at outer 100 000, K1's 4K luma steady state in each
   build, its floor and the decomposition) and ``benchtool`` at
   1920x1440, which must return 0.
3. Renders through the CLI on 3840x2880 synthetic clips (64 frames unless
   stated), each with every launch count set to 0 just before it and read
   just after:
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
      trajectory within 1e-5 rad of (c);
   e. ``--filter vidstab --stabilise smooth``: 64 frames at the input
      size, the first, middle and last frames within one count of
      ``warp_frame_similarity`` on the saved trajectory's corrections;
   f. ``--filter deshake --stabilise smooth`` (32 frames): the first and
      last frames within one count of ``warp_frame_deshake`` on the card
      and the middle frame of the same warp on CPU tensors (this family
      launches none of the kernels);
   g. ``--compare none,smooth,vidstab,deshake --no-cell-labels`` (8
      frames, a 9360x7040 canvas): the canvas size, and every cell of the
      first and last frames within one count of that cell's plain warp.
   h. ``--stabilise smooth --rolling-shutter 0.75``: the trajectory within
      1e-5 rad of (a)'s, every written frame within one count of the plain
      per-tile-row warp under the same row rotations, the launches counted
      under the ``rs`` kernel objects and none under the whole-frame ones;
      then, outside the renders' launch counts, the library's one-frame
      entries (``FrameWarper.warp_yuv``, ``FrameWarper.__call__``; no CLI
      option reaches them with per-tile-row rotations, so the kernels
      line gives their four kernel objects 0 launches) on the first,
      middle and last frames under the same row rotations, each within
      one count of the written frame;
   i. ``--horizon-lock`` alone (no telemetry in a synthetic clip: up taken
      as [0, -1, 0]): it analyses, the trajectory within 1e-5 rad of
      (a)'s, the middle frame within one count of the plain warp under
      the levelled corrections;
   j. ``--compare none,smooth+lock,horizon,vidstab --no-cell-labels`` (8
      frames): every cell of the first and last frames as in (g);
   k. the gyro path: a telemetry-only MP4 (no video track) written for the
      synthetic clip, GYRO at 400 Hz from its ground-truth rotations and
      ACCL as gravity along a tilted up vector; ``render <that.mp4> out -a
      --gyro --horizon-lock``: the trajectory within 0.1 deg RMS of the
      ground truth, up within 0.1 deg of the tilted vector; then ``render
      synthetic://... out --encode-only --stabilise smooth
      --rolling-shutter 0.75 --horizon-lock`` from that trajectory file:
      the first, middle and last frames within one count of the plain
      per-tile-row warp.
   l. K1's modes through the CLI, 24 frames each (the grids 8): ``--interp
      lanczos`` (v360's resampler), ``--projection equirect``,
      ``--prefilter auto --scale 0.4`` (the level maps must engage a level;
      the share of tiles at each level is printed) and the same with
      ``--streaming`` (trajectory equal, frames within one count),
      ``--filter vidstab --interp bicubic`` (vidstab's resampler, between
      identity cameras), all three modes at once with ``--rolling-shutter
      0.75`` (bicubic, stereographic, prefilter at 0.4: the batch's
      ``*_bicubic_rays_mip_rs`` objects), ``--compare none,smooth --prefilter auto
      --scale 0.4`` (the float entries' mip mode) and ``--compare
      none,smooth,vidstab --interp bicubic --projection stereographic``
      (the float entries' 4-tap ray-grid variant, the one-frame entries'
      4-tap). Each launches its variants' kernel objects, every one of them
      measured in phase 2; the first and last frames of
      each are held to the plain warp of the same mode, the differing
      values counted.
   m. where the native libraries built: the stock render of 24 frames to
      ``.mp4`` (libx264 at QP 19), decoded back through the port's
      ``NativeVideoSource`` (frame count and size, encode fps); where they
      did not, a line saying that the render did not run and why.
   n. after (a): ``--encode-only --crop 'iw/2:ih/2:(iw-ow)/2:(ih-oh)/2'``
      from (a)'s trajectory file, every frame equal byte for byte to the
      same window of (a)'s frames; then with ``--debug --preview DIR``
      too: the cropped size, the HUD in the luma alone, a PNG of the
      cropped size every 30 frames;
   o. after (b): the same streaming render through ``render()`` with
      ``RenderOptions(device_sink=True)``: its fps beside (b)'s y4m fps,
      and its checksum equal to the int32-wrapped sum of (b)'s planes;
   p. a 16-frame stock render with ``--trace DIR``: the Chrome trace must
      name K1's ``warp_kernel`` and K2's ``lk_level_kernel``;
   q. after (k): the match workflow through the CLI on three 640x480 y4m
      chapters: ``join`` (the route it took), ``probe`` of the joined clip
      and of (k)'s telemetry MP4, ``workflow tag --sets-json``,
      ``workflow split`` (two sets rendered with ``--stabilise smooth
      --crop ...`` in child processes of ``python -m
      video_annotator_tpu_torch``, two at once), ``workflow encode``.
   The deshake analyse and the compare render then run once more under
   torch.profiler, for the device's busy time and idle share.
   Then the three phases of ``dryrun_multichip`` through ``parallel/``
   at world size 1 (an NCCL group over a ``HashStore``), with the launch
   counts at 0 just before and read just after: the pipeline step on a
   (2, 60) x 1280x960 clip at radius 30 (non-identity corrections), the
   8 x 4K stream batch in the three variants of row 6, the similarity
   and deshake batch warps at 8 x 4K, the spatial warp and its bands
   for 2, 3 and 4 ranks; each held to its unsharded counterpart, wall ms
   for each; the step's own launches of row 6, K3 and K2 at its shapes
   held to their plain versions.
4. Where tracked analyse spends its time at 4K: host wall time per step
   and per span of ``Tracker.step``, then kernel launches and device time
   per step from torch.profiler; and the fixed-lag Kalman smoother of one
   streaming batch on the host (as the port runs it) and on the card;
   and the per-frame parts of the 2D families alone on an idle card; and
   the telemetry parts: ``rs_row_rotations_gyro`` for 64 frames of 440
   tile rows, and ``integrate_gyro`` over 240 000 samples (10 minutes at
   400 Hz) on the card, with the largest angle between it and a float64
   sequential scan of the same float32 inputs.
5. The tools, each with every launch count at 0 just before it and read
   just after:
   a. ``calibrate``: 8 chessboard views of a 3840x2880 fisheye camera
      (the tests' camera and poses scaled by 6) written as y4m; ``python
      -m video_annotator_tpu_torch calibrate board.y4m --device cuda -o
      params.xml --show-undistorted DIR`` in a child process, its fit
      within the tests' tolerances of the true camera scaled by 6 and
      under 1 px RMS; the same fit in this process, timed twice (the first
      fit of a process warms ``torch.func``); then
      ``show_undistorted`` in this process (K1's float one-frame kernel),
      its 5 PNGs equal to the child's and within one count of the plain
      warp of the same frames;
   b. ``tools/quality.py --n 48`` at its 640x480: 18 rows written, the
      nine rows that track at scale 1 and the three at scale 0.5 under
      0.1 deg of trajectory RMS (the scale-0.25 row printed, not gated),
      every stabilised row with a positive reduction; then the tracked and
      paired analyses of the tool's whole 150-frame clip (frames 97 to 98 move
      13.4 px), each under 0.1 deg, K2 and the plain LK level both
      launched (at 640x480 K2 stages two of the three levels); outside
      the counts, the same with K2 alone (the levels it cannot stage kept
      at the coarse guess) for its RMS, and the analyse fps of both loops
      on the clip's first 64 frames resident on the card;
   c. ``tools/fidelity.py --dispatches 4``: PSNR >= 45 dB in luma, U and V
      and in every family, p50 and p99 ms per frame of the 32-frame
      batch;
   d. ``tools/run.py`` over its eight configs in child processes at their
      own geometries, ``--trials 2 --sleep 0``, ``VAT_BENCH_FRAMES=64``,
      ``VAT_E2E_FRAMES=96``, ``VAT_E2E_TRIALS=2``, the e2e config over the
      y4m (the encoded MP4 where the native libraries built): each
      config's JSON, none failed, each config's kernels launched (the
      children's counts, added to the ``kernels`` line; e2e at 960x720
      runs the plain level);
   e. ``tools/soak.py`` at 1920x1440 x 180 frames (y4m, or mp4 where the
      native libraries built), ``--no-attribution``, the card's ceiling of
      8192 MB: segment fps, decay-free, peak and plateau RSS (its render
      children's launches are not counted; at this length the late slope
      measures the children's start, not a leak, and is left in the JSON;
      the phase's time is its four children's start, whatever the length);
   f. ``tools/host_feed.py`` where the native libraries built, else a line
      saying that it did not run and why;
   g. ``tools/bracket.py --pairs 2`` in this process: row 6's slope and
      the multistream fps, alternated.
   Each prints its JSON and its seconds on lines of its own. Every CLI
   render of phase 3 tracks at 1920x1440 or more and must call the plain
   LK level zero times; the script prints how often the phases above
   called it.
6. A JSON line of per-kernel results, then the device line.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from video_annotator_tpu_torch import benchtool, calibrate, cli, so3
from video_annotator_tpu_torch.camera import Camera, CameraModel, CameraPreset, get_output_camera
from video_annotator_tpu_torch.io import gopro, prefetch
from video_annotator_tpu_torch.io.synthetic import (
    SyntheticCamera,
    SyntheticSource,
    render_chessboard,
    render_frame,
    write_telemetry_mp4,
)
from video_annotator_tpu_torch.io.video import open_reader, open_writer
from video_annotator_tpu_torch.models import deshake, similarity
from video_annotator_tpu_torch.ops import cuda_lib, lk, lk_kernel, roofline_kernel, stage, warp_kernel
from video_annotator_tpu_torch.ops.corners import detect_corners
from video_annotator_tpu_torch.ops.affine import fit_similarity
from video_annotator_tpu_torch.ops.lk import build_pyramid
from video_annotator_tpu_torch.ops.phasecorr import phase_correlate
from video_annotator_tpu_torch.ops.warp_plain import box_downsample, num_tile_rows, warp_image
from video_annotator_tpu_torch.parallel import mesh as pmesh
from video_annotator_tpu_torch.parallel import pipeline as ppipeline
from video_annotator_tpu_torch.parallel import streams as pstreams
from video_annotator_tpu_torch.pipeline import compare
from video_annotator_tpu_torch.pipeline import render as trender
from video_annotator_tpu_torch.pipeline import streaming
from video_annotator_tpu_torch.pipeline.profiler import StageProfiler
from video_annotator_tpu_torch.pipeline.trajectory import Trajectory, trajectory_path
from video_annotator_tpu_torch.smoothing.gyro import integrate_gyro
from video_annotator_tpu_torch.smoothing.kalman import smooth_rotations_kalman
from video_annotator_tpu_torch.smoothing.rolling import (
    rs_row_rotations,
    rs_row_rotations_gyro,
    scan_fractions,
)
from video_annotator_tpu_torch.tools import bracket, fidelity, quality, roofline
from video_annotator_tpu_torch.tools import run as bench_run

W, H = 3840, 2880
FRAMES = 64
PRESET = "gopro_h4b_wide43_measured"
SOURCE = f"synthetic://shaky?w={W}&h={H}&n={FRAMES}"
DESHAKE_FRAMES = 32
COMPARE_FRAMES = 8
COMPARE_MODES = ("none", "smooth", "vidstab", "deshake")
LOCK_MODES = ("none", "smooth+lock", "horizon", "vidstab")
READOUT = 0.75  # --rolling-shutter: the readout as a fraction of 1 / fps
RS_SHORT_BY = 10  # tile rows missing from the short stack of the clip case
# World-up of the gyro path's telemetry in frame-0 camera coordinates: the
# camera rolled 6 degrees and pitched 3.
TILTED_UP = (math.sin(math.radians(6.0)) * math.cos(math.radians(3.0)),
             -math.cos(math.radians(6.0)) * math.cos(math.radians(3.0)),
             math.sin(math.radians(3.0)))
MAX_UP_DEG = 0.1
GYRO_SAMPLES = 240_000  # 10 minutes at 400 Hz
WARP_FRAMES = 4
WARP_BATCH = trender.DEFAULT_WARP_BATCH  # frames of a render's warp launch: 32
LK_CHUNK = 17
LK_ITERS = 8
LK_REPS = 100  # K2's launches a reading, queued: each is near the launch floor
MAX_RMS_DEG = 0.1
MIN_EQUAL = 0.999
MIN_STATUS_AGREEMENT = 0.99
FLOW_ATOL = 0.01
TRAJ_ATOL_RAD = 1e-5
PROFILE_FRAMES = 8

# A bound (``roofline.bound``) is the larger of bytes / rate and
# operations / rate for the work of one timed call, at the published H100
# SXM peaks. Operations per item, counted from the kernels' sources (a
# product and a sum are one each; a division, sqrtf and atanf count as one
# each).
# K1's map per output pixel and its bilinear taps and rounding per plane:
# tools/roofline.py, whose floor reads them too. K3's round and clamp per
# source element; K2's template build (24 x 23 bilinear samples), Scharr
# gradients and normal-matrix sums over the 441 template elements, and per
# Newton iteration a bilinear sample, the residual and two sums per element.
WARP_MAP_OPS_RECT = roofline.MAP_OPS_RECT
WARP_TAP_OPS = roofline.TAP_OPS
WARP_TAP_OPS_F32 = 17  # the float mode neither rounds nor clamps
# K1's modes (csrc/warp_modes.cu). A ray grid replaces the inline ray (4)
# and its 3x3 product (12) by the full product with a third component
# (15). A 4-tap weight: bicubic |t|, its two cubics (11) and two tests;
# lanczos |t|, the clamp, pi t, pi t / 2, two sinf, (pi t)^2, the
# division, the products (3) and two tests; lanczos also sums each set of
# four and multiplies the sums (7 per pixel) and divides once per plane.
# Per pixel the floors and fractions, 4. Per plane 16 taps, each its
# bounds tests (2), the border subtracted, its product and its sum, then
# four row products and sums and the border added: 4 x 4 x 5 + 8 + 1 = 89,
# 3 more to round and clamp. A mip pixel reads its level, scales both
# coordinates (3 each) and picks the level (1): 8.
WARP_RAYS_MAP_OPS = WARP_MAP_OPS_RECT - 4 - 12 + 15
WEIGHT_OPS = {"bicubic": 14, "lanczos": 13}
LANCZOS_NORM_OPS = 7
TAP4_OPS_F32 = 89
TAP4_OPS = TAP4_OPS_F32 + 3
MIP_OPS = 8
MIP_SCALE = 0.4  # --scale of the prefilter render: a 4K source at about 1080p
MODE_FRAMES = 24  # frames of each render of K1's modes
# K1's variants in csrc/warp_modes.cu held to their plain versions and timed
# at 4K, as (interp, projection, --prefilter auto at MIP_SCALE, entries,
# rotation forms: per tile row or not): each mode alone through every entry
# in both forms, lanczos being v360's resampler; then bicubic and the
# combinations in the entries and forms that the mode renders launch.
MODE_ENTRIES = ("warp_luma", "warp_chroma", "warp_frame_f32", "warp_planes_f32",
                "warp_yuv_luma", "warp_yuv_chroma")
MODE_CASES = (
    ("lanczos", "rect", False, MODE_ENTRIES, (False, True)),
    ("bilinear", "equirect", False, MODE_ENTRIES, (False, True)),
    ("bilinear", "rect", True, MODE_ENTRIES, (False, True)),
    ("bicubic", "rect", False, ("warp_luma", "warp_chroma", "warp_yuv_luma",
                                "warp_yuv_chroma"), (False,)),
    ("bicubic", "stereographic", False, ("warp_frame_f32", "warp_planes_f32"), (False,)),
    ("bicubic", "stereographic", True, ("warp_luma", "warp_chroma"), (True,)),
)
STAGE_OPS = 3
PYR_OPS = 30  # float32 operations an output of the pyramid kernel: 10 + 5 fmaf
# The Wahba kernel at a PairTracker chunk's batch, one refinement's
# correlations; float32 operations a matrix, counted in csrc/wahba.cu: 82
# a power step (two starts of a 4x4 product, a norm and 4 divisions), 139
# for K, the shift, the Rayleigh quotients and the matrix.
WAHBA_BATCH = 16
WAHBA_ITERS = 120
WAHBA_REPS = 100
WAHBA_OPS = 82 * WAHBA_ITERS + 139
WAHBA_ATOL = 2e-6
# The parallel layer (rows 6 and 9): STREAMS 4K streams on one card (the
# README's 8 x 4K60 batch), the variants its phase launches, the rank
# counts of the spatial warp's bands (3 clamps: 440 tile rows).
STREAMS = 8
PARALLEL_VARIANTS = (("bilinear", "rect"), ("bicubic", "rect"), ("bilinear", "equirect"))
BAND_SHARDS = (2, 3, 4)
PARALLEL_KERNELS = ("warp_frames_f32", "warp_frames_f32_bicubic", "warp_frames_f32_rays",
                    "warp_band_f32", "warp_band_f32_bicubic", "warp_band_f32_rays",
                    "warp_luma", "warp_chroma", "stage", "lk_level")
PIPE_CORNERS = 32  # build_pipeline_step's max_corners: the dryrun's
NATIVE_FRAMES = 24
LK_TEMPLATE_OPS = 24 * 23 * 9 + 441 * 26
LK_ITER_OPS = 441 * 14
# K2 bytes per point: its prev template footprint (25 x 24), one next
# patch (23 x 23), its 6 float and 4 int arguments and 3 float results.
LK_POINT_BYTES = 25 * 24 + 23 * 23 + 6 * 4 + 4 * 4 + 3 * 4
# The roofline phase holds the probes of rows 11 and 12 to their plain
# versions on the inputs that tools/roofline.py launches them on, over
# ROOF_CHECK_OUTER outer steps (the plain versions are Python loops: they
# cannot take its 100 000), bit for bit, the fused chain too (its plain
# version rounds each step once, through float64).
ROOF_CHECK_OUTER = 4
# The keys that label a probe's plain_ms in the kernels line: the outer
# steps and tiles it was timed at, and the kernel's own time there.
PLAIN_LABELS = ("plain_outer", "plain_tiles", "ms_at_plain_outer")
BENCHTOOL_ARGS = ["--size", "1920x1440", "--reps", "10"]
CROP_SPEC = "iw/2:ih/2:(iw-ow)/2:(ih-oh)/2"  # the centred half of the canvas
PREVIEW_EVERY = 30
TRACE_FRAMES = 16
CHAPTERS = ("GOPR0001.y4m", "GP010001.y4m", "GP020001.y4m")
CHAPTER_URI = "synthetic://shaky?w=640&h=480&n=12&fps=30&seed={seed}"
MATCH_SETS = ({"start": 0.0, "end": 0.5, "score": "21-19"},
              {"start": 0.6, "end": 1.1, "score": "15-21"})
SET_FRAMES = 15  # 0.5 s at 30 fps
# The calibrate phase: 8 chessboard views of a fisheye camera at 4K, the
# tests' 640x480 camera and poses (tests/test_calibrate.py) scaled by 6, and
# the tests' tolerances of the truth (:171-176) scaled with it.
BOARD_SCALE = 6
BOARD_VIEWS = 8
BOARD_CAMERA = (300.0, 302.0, 321.0, 239.0)  # fx, fy, cx, cy at 640x480
BOARD_DIST = (0.02, -0.005, 0.0, 0.0)
BOARD_TOL = (6.0, 6.0, 8.0, 8.0)  # px at 640x480
MAX_BOARD_RMS = 1.0  # px, the tests' bound, not scaled
UNDISTORTED_VIEWS = 5  # show_undistorted's default max_frames
# The quality phase: the tool's 640x480 clip, 48 frames; the rows that
# track at scale 1 and at --analysis-scale 0.5 (320x240: K2 stages one of
# its three levels, the plain level runs the other two), held to the
# accuracy guard, and every row to a positive reduction. The row at 0.25
# (160x120) has its trajectory RMS printed, not gated: the JAX package's
# XLA LK reads 0.2407 deg there too. Then the tracked and paired analyses
# of the tool's whole 150-frame clip (frames 97 to 98 move 13.4 px), each
# held to the guard; at 640x480 K2 stages two of the three levels the
# plain LK tracks, and the third runs the plain level.
QUALITY_FRAMES = 48
QUALITY_CLIP = "synthetic://shaky?w=640&h=480&n=150&seed=11&shake=0.008&pan=0.002"
CLIP_FPS_FRAMES = 64  # the clip's first frames, resident, for the analyse fps
CLIP_FPS_ROUNDS = 2  # rounds of (every level, K2 alone) after a warm-up of each
# The tools' phases: tools/run.py's eight configs in child processes, frames
# and trials cut through its own switches; the soak at 1920x1440.
RUN_ENV = {"VAT_BENCH_FRAMES": "64", "VAT_E2E_FRAMES": "96", "VAT_E2E_TRIALS": "2"}
RUN_ARGS = ["--trials", "2", "--sleep", "0"]
RUN_KERNELS = {"1080p_sparse_flow": ("stage", "lk_level_frame"),
               "1080p_full_pipeline": ("stage", "lk_level_frame", "warp_luma", "warp_chroma"),
               "4k_gyro_fused": ("warp_luma", "warp_chroma"),
               "4k_visual_full_pipeline": ("stage", "lk_level", "warp_luma", "warp_chroma"),
               "4k_visual_full_pipeline_detect0": ("stage", "lk_level", "warp_luma",
                                                   "warp_chroma"),
               "e2e_decode_overlap_720p": ("stage", "lk_level", "warp_luma", "warp_chroma",
                                           lk_kernel.PLAIN_LEVEL.name),
               "8x4k60_multistream": ("warp_luma", "warp_chroma")}
# A render child on the card holds about 5.6 GB of RSS from its start (the
# CUDA libraries; PERF.md section 6), over the JAX tool's 4096 MB
# default sized for its TPU children: the ceiling here is the card's.
SOAK_ARGS = ["--frames", "180", "--width", "1920", "--height", "1440", "--no-attribution",
             "--max-rss-mb", "8192"]
BRACKET_PAIRS = 2
QUALITY_GATED = ("rotation_smooth_savgol", "rotation_smooth_paired",
                 "rotation_smooth_paired_detect0", "rotation_smooth_kalman",
                 "rotation_smooth_kalman_streaming", "rotation_fixed",
                 "rotation_smooth_bicubic", "rotation_smooth_lanczos",
                 "rotation_smooth_prefilter", "rotation_smooth_scale05",
                 "rotation_smooth_paired_scale05", "rotation_smooth_paired_scale05_detect0")
QUALITY_KERNELS = ("warp_luma", "warp_chroma", "stage", "lk_level", "lk_level_frame",
                   "warp_luma_bicubic", "warp_luma_lanczos", "warp_luma_rs", "warp_chroma_rs")
FIDELITY_DISPATCHES = 4
FIDELITY_KERNELS = ("warp_yuv_luma", "warp_yuv_chroma", "warp_luma", "warp_chroma",
                    "warp_yuv_luma_bicubic", "warp_yuv_luma_lanczos")


def log(msg: str = "") -> None:
    print(msg, flush=True)


card_label = roofline.card_label  # the card's name and power limit, as nvidia-smi gives them
cuda_ms = roofline.event_ms  # mean device ms of fn over reps calls (CUDA events)
queued_ms = roofline.queued_ms  # the same, the calls queued behind a sleeping kernel
bound = roofline.bound  # the least time at the published peaks, and what binds


def warp_map_ops(in_camera) -> int:
    """Operations of K1's map per output pixel, by the branch of
    ``source_coords`` that this input camera takes."""
    return roofline.map_ops(in_camera)


def lk_bound(points: int, iters: int) -> dict:
    return bound(points * LK_POINT_BYTES,
                 points * (LK_TEMPLATE_OPS + iters * LK_ITER_OPS))


def u8_agreement(got: torch.Tensor, want: torch.Tensor):
    d = (got.to(torch.int16) - want.to(torch.int16)).abs()
    return int(d.max()), float((d == 0).float().mean())


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def zero_launches():
    for k in (*cuda_lib.KERNELS.values(), lk_kernel.PLAIN_LEVEL):
        k.launches = 0


def launch_counts() -> dict:
    """Every kernel object's launches since :func:`zero_launches`, and the
    plain LK level's calls (``lk_plain_level``: not a kernel, so not in
    the ``kernels`` line)."""
    return {n: k.launches for n, k in
            (*cuda_lib.KERNELS.items(), (lk_kernel.PLAIN_LEVEL.name, lk_kernel.PLAIN_LEVEL))}


def check_launched(name, needs) -> dict:
    """Log the nonzero launch counts; each kernel of ``needs`` must have
    launched. Returns every count."""
    launches = launch_counts()
    log(f"[{name}] launches {({n: c for n, c in launches.items() if c})}")
    for kname in needs:
        check(launches.get(kname, 0) > 0, f"[{name}] kernel {kname} was not launched")
    return launches


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
    """K1's uint8 batch at the stock 4K shapes, luma and chroma, with one
    rotation per frame and one per tile row, on the first 4 frames and on
    the render's batch of 32: every launch bit for bit against its plain
    version; the kernels line keeps the 32-frame launch, the main path's."""
    warper = stock_cameras()
    cfg = SyntheticSource.from_uri(SOURCE).config
    cam = cfg.camera()
    rots_src = torch.from_numpy(cfg.rotations()[:WARP_BATCH]).to(dev)
    planes = [render_frame(cam, r) for r in rots_src]
    ys = torch.stack([p[0] for p in planes])[:, None]
    uv = torch.stack([torch.stack([p[1], p[2]]) for p in planes])
    del planes
    oh, ow = warper.out_h, warper.out_w
    rows = row_stacks(dev, (WARP_BATCH,), num_tile_rows(oh), 19)
    rows_c = warp_kernel.chroma_row_rotations(rows, num_tile_rows(oh // 2))
    modes = (
        ("warp_luma", ys, rows, warper.out_cam, warper.in_cam, (oh, ow), 0.0),
        ("warp_chroma", uv, rows_c, warper.out_half, warper.in_half, (oh // 2, ow // 2), 128.0),
    )
    for name, src_all, stack_all, oc, ic, size, border in modes:
        for frames in (WARP_FRAMES, WARP_BATCH):
            src, stack = src_all[:frames], stack_all[:frames]
            timed = {}
            for rs, rot in ((False, stack[:, 0].contiguous()), (True, stack.contiguous())):
                kname = name + ("_rs" if rs else "")
                kernel = cuda_lib.KERNELS[kname]
                before = kernel.launches
                got = warp_kernel.warp_planes_u8(src, rot, oc, ic, size, border)
                check(kernel.launches == before + 1, f"{kname} was not the kernel launched")
                want = warp_kernel.warp_planes_u8_plain(src, rot, oc, ic, size, border)
                torch.cuda.synchronize()
                max_err, equal = u8_agreement(got, want)
                differ = int((got != want).sum())
                del want
                ms = cuda_ms(lambda: warp_kernel.warp_planes_u8(src, rot, oc, ic, size, border),
                             20)
                plain_ms = cuda_ms(lambda: warp_kernel.warp_planes_u8_plain(
                    src, rot, oc, ic, size, border), 3, 1)
                t, c = src.shape[:2]
                b = bound(src.numel() + rot.numel() * 4 + got.numel(),
                          t * size[0] * size[1] * (warp_map_ops(ic) + c * WARP_TAP_OPS))
                del got
                timed[rs] = ms
                log(f"[K1 {kname}] {tuple(src.shape)} with {tuple(rot.shape)} rotations: "
                    f"max |diff| {max_err} count, {differ} differing values; kernel {ms:.3f} "
                    f"ms, plain {plain_ms:.3f} ms per {frames}-frame launch; bound "
                    f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
                check(differ == 0, f"{kname} at {frames} frames is not bit for bit its plain version")
                if frames == WARP_BATCH:
                    results[kname] = dict(max_abs_err=float(max_err), ms=ms, plain_ms=plain_ms,
                                          **b)
            log(f"[K1 {name}] {frames} frames: per tile row / whole-frame "
                f"{timed[True] / timed[False]:.4f}")


def source_frame(dev, uri: str, t: int):
    """Frame ``t`` of a synthetic source as uint8 (y, u, v) tensors."""
    cfg = SyntheticSource.from_uri(uri).config
    rot = torch.from_numpy(cfg.rotations()[t]).to(dev)
    return render_frame(cfg.camera(), rot)


def phase_warp_float(dev, results):
    """K1's float mode, as a rotation cell of the compare grid calls it:
    one 4K luma plane, then the U and V planes of the frame through one
    map, stock cameras, a 3 degree rotation."""
    warper = stock_cameras()
    y, u, v = (p.to(torch.float32) for p in source_frame(dev, SOURCE, 0))
    rot = so3.exp(torch.tensor([0.0, 0.0, math.radians(3.0)])).to(dev)
    oh, ow = warper.out_h, warper.out_w
    modes = (
        ("warp_frame_f32", y[None], warper.out_cam, warper.in_cam, (oh, ow), 0.0,
         lambda s, *a: warp_kernel.warp_frame_f32(s[0], *a)[None]),
        ("warp_planes_f32", torch.stack([u, v]), warper.out_half, warper.in_half,
         (oh // 2, ow // 2), 128.0, warp_kernel.warp_planes_f32),
    )
    for name, src, oc, ic, size, border, entry in modes:
        got = entry(src, rot, oc, ic, size, border)
        want = warp_kernel.warp_planes_f32_plain(src, rot, oc, ic, size, border)
        torch.cuda.synchronize()
        max_err = float((got - want).abs().max())
        differ = int((got != want).sum())
        ms = cuda_ms(lambda: entry(src, rot, oc, ic, size, border), 20)
        plain_ms = cuda_ms(
            lambda: warp_kernel.warp_planes_f32_plain(src, rot, oc, ic, size, border), 3, 1)
        planes = src.shape[0]
        b = bound(4 * (src.numel() + rot.numel() + got.numel()),
                  size[0] * size[1] * (warp_map_ops(ic) + planes * WARP_TAP_OPS_F32))
        log(f"[K1 {name}] {tuple(src.shape)} f32 -> {tuple(got.shape)} f32: max |diff| "
            f"{max_err:.2e}, {differ} differing values; kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms per launch; bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        check(got.shape == want.shape and differ == 0,
              f"{name} is not bit for bit its plain version")
        results[name] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, **b)


def phase_warp_one_frame(dev, results):
    """K1's uint8 mode with T = 1 over identity pinhole cameras, as a
    similarity cell of the compare grid calls it: against its plain
    version and against ``warp_similarity`` rounded, which computes
    ``s (ca x - sa y) + dx`` directly."""
    y, u, v = source_frame(dev, SOURCE, 0)
    params = torch.tensor([37.5, -21.25, 0.02, math.log(1.03)])
    warper = similarity.SimilarityWarper(W, H)
    mat = torch.from_numpy(similarity.SimilarityWarper.matrices(params.numpy()[None])[0]).to(dev)
    want = [warp_kernel.to_u8(p) for p in similarity.warp_frame_similarity(
        y.to(torch.float32), u.to(torch.float32), v.to(torch.float32), params.to(dev))]
    got = warper.warp_yuv(y, u, v, mat)
    modes = (
        ("warp_yuv_luma", y[None, None], warper.cam, (H, W), 0.0, got[0][None], want[0][None]),
        ("warp_yuv_chroma", torch.stack([u, v])[None], warper.cam_c, (H // 2, W // 2),
         128.0, torch.stack(got[1:]), torch.stack(want[1:])),
    )
    for name, src, cam, size, border, got_p, want_p in modes:
        plain = warp_kernel.warp_planes_u8_plain(src, mat[None], cam, cam, size, border)[0]
        torch.cuda.synchronize()
        max_err, equal = u8_agreement(got_p, plain)
        sim_err, sim_equal = u8_agreement(got_p, want_p)
        # warp_yuv launches luma and chroma together; time each launch alone.
        ms = cuda_ms(lambda: warp_kernel.warp_planes_u8(
            src, mat[None], cam, cam, size, border,
            kernels=warp_kernel.ONE_FRAME_KERNELS), 20)
        plain_ms = cuda_ms(lambda: warp_kernel.warp_planes_u8_plain(
            src, mat[None], cam, cam, size, border), 3, 1)
        b = bound(src.numel() + mat.numel() * 4 + got_p.numel(),
                  size[0] * size[1] * (warp_map_ops(cam) + src.shape[1] * WARP_TAP_OPS))
        log(f"[K1 {name}] {tuple(src.shape)} -> {tuple(got_p.shape)}: max |diff| {max_err} "
            f"count, equal {equal:.6f} against plain; {sim_err} count, equal "
            f"{sim_equal:.6f} against warp_similarity; kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms per launch; bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        check(equal == 1.0, f"{name} is not bit for bit its plain version")
        check(sim_err <= 1 and sim_equal >= MIN_EQUAL,
              f"{name} disagrees with warp_similarity")
        results[name] = dict(max_abs_err=float(max_err), ms=ms, plain_ms=plain_ms, **b)


def row_stacks(dev, lead: tuple, ny: int, seed: int) -> torch.Tensor:
    """``lead + (ny, 3, 3)`` rotations: a 1 degree pose that drifts by
    another degree down the frame, as a fast pan reads out."""
    g = torch.Generator().manual_seed(seed)
    base = torch.randn(lead + (1, 3), generator=g) * 0.02
    drift = torch.randn(lead + (1, 3), generator=g) * 0.02
    frac = (torch.arange(ny, dtype=torch.float32) / ny)[:, None]
    return so3.exp(base + drift * frac).to(dev)


def phase_warp_rs(dev, results):
    """K1's per-tile-row rotation mode through its one-frame and float
    entries at the stock 4K shape (the batch's in :func:`phase_warp`),
    each against its plain version, timed in turns with the same launch
    under whole-frame rotations (the mode's cost is that difference: the
    bound counts the stack's bytes, under 0.1% of the planes'), and the
    batch luma warp once with a short stack."""
    warper = stock_cameras()
    oh, ow = warper.out_h, warper.out_w
    ny, nyc = num_tile_rows(oh), num_tile_rows(oh // 2)
    cfg = SyntheticSource.from_uri(SOURCE).config
    cam = cfg.camera()
    rots_src = torch.from_numpy(cfg.rotations()[:WARP_FRAMES]).to(dev)
    planes = [render_frame(cam, r) for r in rots_src]
    ys = torch.stack([p[0] for p in planes])[:, None]
    uv = torch.stack([torch.stack([p[1], p[2]]) for p in planes])
    rows = row_stacks(dev, (WARP_FRAMES,), ny, 19)
    rows_c = warp_kernel.chroma_row_rotations(rows, nyc)
    luma = (warper.out_cam, warper.in_cam, (oh, ow), 0.0)
    chroma = (warper.out_half, warper.in_half, (oh // 2, ow // 2), 128.0)
    one = warp_kernel.ONE_FRAME_KERNELS

    def u8(src, rot, geometry, **kw):
        return warp_kernel.warp_planes_u8(src, rot, *geometry, **kw)

    def frame_f32(src, rot, geometry):
        return warp_kernel.warp_frame_f32(src[0], rot, *geometry)[None]

    def planes_f32(src, rot, geometry):
        return warp_kernel.warp_planes_f32(src, rot, *geometry)

    # (rs kernel object, its whole-frame twin, entry, plain, src, per-row
    # rotations, geometry, operations per tap)
    u8_plain = lambda src, rot, geo: warp_kernel.warp_planes_u8_plain(src, rot, *geo)
    f32_plain = lambda src, rot, geo: warp_kernel.warp_planes_f32_plain(src, rot, *geo)
    cases = (
        ("warp_yuv_luma_rs", None, lambda *a: u8(*a, kernels=one), u8_plain,
         ys[:1], rows[:1], luma, WARP_TAP_OPS),
        ("warp_yuv_chroma_rs", None, lambda *a: u8(*a, kernels=one), u8_plain,
         uv[:1], rows_c[:1], chroma, WARP_TAP_OPS),
        ("warp_frame_f32_rs", "warp_frame_f32", frame_f32, f32_plain,
         ys[0].to(torch.float32), rows[0], luma, WARP_TAP_OPS_F32),
        ("warp_planes_f32_rs", "warp_planes_f32", planes_f32, f32_plain,
         uv[0].to(torch.float32), rows_c[0], chroma, WARP_TAP_OPS_F32),
    )
    for name, twin, entry, plain, src, rot, geo, tap_ops in cases:
        kernel = cuda_lib.KERNELS[name]
        before = kernel.launches
        got = entry(src, rot, geo)
        check(kernel.launches == before + 1, f"{name} was not the kernel launched")
        want = plain(src, rot, geo)
        torch.cuda.synchronize()
        if got.dtype == torch.uint8:
            max_err, equal = u8_agreement(got, want)
            agrees = equal == 1.0  # bit for bit
            said = f"max |diff| {max_err} count, equal {equal:.6f}"
        else:
            max_err = float((got - want).abs().max())
            agrees = got.shape == want.shape and torch.equal(got, want)  # bit for bit
            said = f"max |diff| {max_err:.2e}, {int((got != want).sum())} differing values"
        whole = rot[..., 0, :, :].contiguous()  # one rotation per frame
        whole_a = cuda_ms(lambda: entry(src, whole, geo), 20)
        ms_a = cuda_ms(lambda: entry(src, rot, geo), 20)
        ms_b = cuda_ms(lambda: entry(src, rot, geo), 20)
        whole_b = cuda_ms(lambda: entry(src, whole, geo), 20)
        ms, whole_ms = (ms_a + ms_b) / 2, (whole_a + whole_b) / 2
        plain_ms = cuda_ms(lambda: plain(src, rot, geo), 3, 1)
        item = 1 if got.dtype == torch.uint8 else 4
        pixels = got.numel() // src.shape[-3]
        b = bound(item * (src.numel() + got.numel()) + 4 * rot.numel(),
                  pixels * (warp_map_ops(geo[1]) + src.shape[-3] * tap_ops))
        log(f"[K1 {name}] {tuple(src.shape)} with {tuple(rot.shape)} rotations -> "
            f"{tuple(got.shape)}: {said}; kernel {ms:.3f} ms ({ms_a:.3f}, {ms_b:.3f}), "
            f"the same launch with whole-frame rotations {whole_ms:.3f} ms "
            f"({whole_a:.3f}, {whole_b:.3f}): ratio {ms / whole_ms:.4f}; plain "
            f"{plain_ms:.3f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        check(agrees, f"{name} disagrees with plain")
        if twin is not None:
            log(f"[K1 {name}] {twin} in its own phase: {results[twin]['ms']:.3f} ms")
        results[name] = dict(max_abs_err=float(max_err), ms=ms, plain_ms=plain_ms, **b)

    short = rows[:, : ny - RS_SHORT_BY].contiguous()
    got = u8(ys, short, luma)
    want = u8_plain(ys, short, luma)
    full = u8(ys, torch.cat([short, short[:, -1:].expand(-1, RS_SHORT_BY, -1, -1)], 1), luma)
    torch.cuda.synchronize()
    max_err, equal = u8_agreement(got, want)
    log(f"[K1 warp_luma_rs] a stack of {ny - RS_SHORT_BY} rotations for {ny} tile rows: "
        f"max |diff| {max_err} count, equal {equal:.6f} against plain; equal to the "
        f"stack padded with its last rotation: {torch.equal(got, full)}")
    check(equal == 1.0 and torch.equal(got, full),
          "the clipped row index disagrees")


def level_shares(levels) -> list:
    """The share of the level map's tiles at each level 0..max."""
    lv = levels.levels.flatten().to(torch.int64)
    return [float((lv == i).float().mean()) for i in range(levels.max_level + 1)]


def variant_warper(dev, interp: str, projection: str, prefilter: bool):
    """A FrameWarper at the 4K shapes in K1's modes: the stock cameras, or
    another output projection of the stock canvas, and with ``prefilter``
    ``--scale 0.4`` of them with the level maps of a 8 degree budget."""
    meta = trender.VideoMeta(W, H, 30, FRAMES)
    extra = dict(scale=MIP_SCALE, prefilter="auto") if prefilter else {}
    cams = trender.build_cameras(meta, stock_options(projection=projection, **extra))
    return trender.FrameWarper(*cams, 8.0, prefilter, interp, dev)


def mode_bound(interp, rays, mip, src, out, rot, in_cam, stacks, levels) -> dict:
    """The least time of one modes launch: each input byte read once (the
    ray grid once per launch, the level planes in the share of tiles that
    read them), each output byte written once; the operations of
    ``csrc/warp_modes.cu`` per pixel."""
    item = src.element_size()
    planes = src.shape[-3]
    oh, ow = out.shape[-2:]
    pixels = out.numel() // planes
    ops = warp_map_ops(in_cam)
    nbytes = item * out.numel() + 4 * rot.numel()
    share = [1.0]
    if rays:
        ops += WARP_RAYS_MAP_OPS - WARP_MAP_OPS_RECT
        nbytes += 12 * oh * ow
    if mip:
        ops += MIP_OPS
        share = level_shares(levels)
        nbytes += levels.levels.numel() + sum(
            s.numel() * s.element_size() * f for s, f in zip(stacks, share[1:]))
    nbytes += item * src.numel() * share[0]
    if interp == "bilinear":
        tap_ops = WARP_TAP_OPS if item == 1 else WARP_TAP_OPS_F32
    else:
        ops += 8 * WEIGHT_OPS[interp] + 4
        tap_ops = TAP4_OPS if item == 1 else TAP4_OPS_F32
        if interp == "lanczos":
            ops += LANCZOS_NORM_OPS
            tap_ops += 1
    return bound(nbytes, pixels * (ops + planes * tap_ops))


def phase_warp_modes(dev, results):
    """K1's variants in ``csrc/warp_modes.cu`` (:data:`MODE_CASES`) at the
    4K shapes: each launched once through its entry and counted under its
    own kernel object alone, held to its plain version (largest
    difference, differing values), the kernel timed alone on prepared
    levels (the levels' build timed beside it), the plain version too."""
    cfg = SyntheticSource.from_uri(SOURCE).config
    cam = cfg.camera()
    rots_src = torch.from_numpy(cfg.rotations()[:WARP_FRAMES]).to(dev)
    planes = [render_frame(cam, r) for r in rots_src]
    ys = torch.stack([p[0] for p in planes])[:, None].contiguous()
    uv = torch.stack([torch.stack([p[1], p[2]]) for p in planes]).contiguous()
    g = torch.Generator().manual_seed(29)
    whole = so3.exp(torch.randn((WARP_FRAMES, 3), generator=g) * 0.02).to(dev)
    one = warp_kernel.ONE_FRAME_KERNELS
    # entry -> (source planes, chroma, whole-frame kernel objects)
    sources = {
        "warp_luma": (ys, False, warp_kernel.BATCH_KERNELS),
        "warp_chroma": (uv, True, warp_kernel.BATCH_KERNELS),
        "warp_frame_f32": (ys[0].to(torch.float32), False, None),
        "warp_planes_f32": (uv[0].to(torch.float32), True, None),
        "warp_yuv_luma": (ys[:1], False, one),
        "warp_yuv_chroma": (uv[:1], True, one),
    }
    for interp, projection, prefilter, entries, forms in MODE_CASES:
        warper = variant_warper(dev, interp, projection, prefilter)
        oh, ow = warper.out_h, warper.out_w
        if prefilter:
            for which, levels in zip(("luma", "chroma"), warper.levels):
                shares = ", ".join(f"level {i} {f:.4f}" for i, f in enumerate(level_shares(levels)))
                log(f"[K1 modes] {interp} {projection} --scale {MIP_SCALE} {which} level map "
                    f"{tuple(levels.levels.shape)}: {shares}")
                check(levels.max_level >= 1, f"the {which} level map engages no level")
        rows = row_stacks(dev, (WARP_FRAMES,), num_tile_rows(oh), 31)
        rows_c = warp_kernel.chroma_row_rotations(rows, num_tile_rows(oh // 2))
        for base in entries:
            src, is_chroma, kernels = sources[base]
            oc, ic = (warper.out_half, warper.in_half) if is_chroma else (warper.out_cam,
                                                                         warper.in_cam)
            size = (oh // 2, ow // 2) if is_chroma else (oh, ow)
            border = 128.0 if is_chroma else 0.0
            levels = warper.levels[int(is_chroma)]
            f32 = src.dtype == torch.float32
            suffix = warp_kernel.variant(oc, interp, levels)
            for rs in forms:
                rot = (rows_c if is_chroma else rows) if rs else whole
                rot = (rot[0] if f32 else rot[:src.shape[0]]).contiguous()
                if base == "warp_frame_f32":
                    def entry():
                        return warp_kernel.warp_frame_f32(src[0], rot, oc, ic, size, border,
                                                          interp, levels)[None]
                elif f32:
                    def entry():
                        return warp_kernel.warp_planes_f32(src, rot, oc, ic, size, border,
                                                           interp, levels)
                else:
                    def entry():
                        return warp_kernel.warp_planes_u8(src, rot, oc, ic, size, border,
                                                          kernels, interp, levels)
                plain = (warp_kernel.warp_planes_f32_plain if f32
                         else warp_kernel.warp_planes_u8_plain)
                want = plain(src, rot, oc, ic, size, border, interp, levels)
                before = {n: k.launches for n, k in cuda_lib.KERNELS.items()}
                got = entry()
                torch.cuda.synchronize()
                name = base + suffix + ("_rs" if rs else "")
                moved = {n for n, k in cuda_lib.KERNELS.items() if k.launches != before.get(n, 0)}
                # A uint8 mip launch stages its levels through K3 first.
                staged = {"stage"} if levels is not None and not f32 else set()
                obj = cuda_lib.KERNELS.get(name)
                check(moved == {name} | staged and obj.launches == before.get(name, 0) + 1,
                      f"{name}: launched {moved}")
                diff = (got.to(torch.float32) - want.to(torch.float32)).abs()
                max_err, differ = float(diff.max()), int((diff > 0).sum())
                agrees = got.shape == want.shape and differ == 0  # bit for bit
                stacks = warp_kernel.level_stacks(src, levels, border)
                out = torch.empty_like(got)
                ms = cuda_ms(lambda: warp_kernel.launch_modes(
                    src, out, rot, oc, ic, border, interp, levels, stacks, obj), 10)
                plain_ms = cuda_ms(lambda: plain(src, rot, oc, ic, size, border, interp, levels),
                                   2, 0)
                b = mode_bound(interp, oc.model != CameraModel.RECTILINEAR, levels is not None,
                               src, got, rot, ic, stacks, levels)
                extra = ""
                if levels is not None:
                    build_ms = cuda_ms(lambda: warp_kernel.level_stacks(src, levels, border), 5)
                    extra = (f"; its levels built per call (box_downsample"
                             f"{', K3' if not f32 else ''}) {build_ms:.3f} ms")
                log(f"[K1 {name}] {projection} output, {tuple(src.shape)} {src.dtype} with "
                    f"{tuple(rot.shape)} rotations -> {tuple(got.shape)}: max |diff| "
                    f"{max_err:.3g}, {differ} of {got.numel()} values differ; kernel "
                    f"{ms:.3f} ms, plain {plain_ms:.3f} ms; bound {b['bound_ms']:.4f} ms "
                    f"({b['bound_by']}){extra}")
                check(agrees, f"{name} is not bit for bit its plain version")
                results[name] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, **b)


def lk_chunk(dev):
    """A 17-frame chunk as the paired analyse sees it: 4K frames
    box-downsampled to 1920x1440, 200 corners per frame detected at
    960x720 with the tracker's own gates."""
    frames = source_lumas(dev, LK_CHUNK)
    tracker = trender.PairTracker(trender.VideoMeta(W, H, 30, FRAMES), stock_options(), dev)
    grays = box_downsample(frames.to(torch.float32), tracker.level)
    pts, valid = tracker.detect(grays[:-1])
    return grays, pts, valid


def compare_lk_levels(tag, levels, pts, valid, launch, plain, iters=LK_ITERS):
    """Run K2 coarse to fine over ``levels`` (prev, next, band) with each
    level's guess from the kernel's coarser level; compare every level
    with the plain version on the same arguments and time level 0
    (``launch`` and ``plain`` run ``iters`` Newton iterations)."""
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
            timing = (queued_ms(lambda: launch(prev, nxt, pf, pi), LK_REPS),
                      cuda_ms(lambda: plain(prev, nxt, pf, pi), 3, 1),
                      lk_bound(pf.shape[0], iters))
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


def phase_pyramid(dev, results):
    """The pyramid kernel on the paired analyse's 17-frame chunks: the
    1440p cell's (1920x1440 integers) and the 4K cell's (1920x1080
    quarters, ``box_downsample`` of 3840x2160), levels 1 and 2. Every
    launch equals its plain twin; both levels of the integer chunk and
    level 1 of the quarter chunk equal the banded ``torch.matmul``
    products (``library_ms``), whose second product at the quarter
    chunk's level 2 may round otherwise (logged)."""
    g = torch.Generator(dev).manual_seed(21)
    for kind, (h, w) in (("integer", (1440, 1920)), ("quarter", (1080, 1920))):
        if kind == "integer":
            img = torch.randint(0, 256, (LK_CHUNK, h, w), generator=g, device=dev).float()
        else:
            big = torch.randint(0, 256, (LK_CHUNK, 2 * h, 2 * w), generator=g, device=dev)
            img = box_downsample(big.float(), 1)
        for level in (1, 2):
            out = lk.pyr_down(img)
            banded = lk.pyr_down_banded(img)
            torch.cuda.synchronize()
            check(torch.equal(out, lk.pyr_down_plain(img)),
                  f"pyramid kernel differs from its plain twin ({kind}, level {level})")
            differ = int((out != banded).sum())
            if kind == "integer" or level == 1:
                check(differ == 0, f"pyramid kernel differs from torch.matmul ({kind}, level {level})")
            ms = cuda_ms(lambda: lk.pyr_down(img), 20)
            plain_ms = cuda_ms(lambda: lk.pyr_down_plain(img), 3, 1)
            library_ms = cuda_ms(lambda: lk.pyr_down_banded(img), 20)
            b = bound((img.numel() + out.numel()) * 4, out.numel() * PYR_OPS)
            log(f"[pyramid] {kind} {tuple(img.shape)} -> {tuple(out.shape)}: {differ} of "
                f"{out.numel()} values differ from torch.matmul "
                f"(max {float((out - banded).abs().max()):.3g}); kernel {ms:.4f} ms, plain "
                f"{plain_ms:.3f} ms, torch.matmul {library_ms:.4f} ms, bound "
                f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
            if kind == "integer" and level == 1:
                results["pyr_down"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                           library_ms=library_ms, **b)
            img = out


def phase_wahba(dev, results):
    """The Wahba kernel on one refinement's batch: (16, 3, 3) correlations
    of 200 noisy unit rays under random rotations, within 2e-6 of its
    plain twin, whose chain of about 680 PyTorch launches is the
    yardstick. Both are timed queued behind a sleeping kernel, so the
    readings are card time without the host's enqueue; the bound is the
    launch's own latency (the arithmetic floor is logged beside it)."""
    g = torch.Generator(dev).manual_seed(23)
    rot = so3.exp(torch.randn((WAHBA_BATCH, 3), generator=g, device=dev) * 0.5)
    p = torch.nn.functional.normalize(
        torch.randn((WAHBA_BATCH, 200, 3), generator=g, device=dev), dim=-1)
    q = torch.einsum("bij,bnj->bni", rot, p)
    q = q + torch.randn(q.shape, generator=g, device=dev) * 0.002
    B = torch.einsum("bni,bnj->bij", q, p).contiguous()
    before = so3.WAHBA.launches
    got = so3.rotation_from_correlation(B, WAHBA_ITERS)
    launched = so3.WAHBA.launches - before
    check(launched == 1, f"the Wahba solve launched {launched} times")
    want = so3.rotation_from_correlation_plain(B, WAHBA_ITERS)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    equal = float((got == want).float().mean())
    check(err <= WAHBA_ATOL, f"Wahba kernel differs from its plain twin by {err:.3g}")
    ms = queued_ms(lambda: so3.rotation_from_correlation(B, WAHBA_ITERS), WAHBA_REPS)
    plain_ms = queued_ms(lambda: so3.rotation_from_correlation_plain(B, WAHBA_ITERS), 1)
    plain_host_ms = host_ms(lambda: so3.rotation_from_correlation_plain(B, WAHBA_ITERS))
    b = bound(2 * B.numel() * 4, WAHBA_BATCH * WAHBA_OPS)
    log(f"[wahba] {tuple(B.shape)}: largest difference from the plain twin {err:.3g}, "
        f"{equal:.4f} of floats equal; kernel {ms:.4f} ms (queued), plain chain "
        f"{plain_ms:.4f} ms (queued; {plain_host_ms:.3f} ms on the host's clock); bound: "
        f"launch latency, arithmetic floor {b['bound_ms']:.2e} ms ({b['bound_by']})")
    results["wahba"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **b)


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


# Entry points a render goes through, timed where they are looked up:
# (module, attribute, what the time counts as, index of the profiler
# argument). ``render`` looks the 2D analysers up in their own modules,
# ``render_compare`` holds its own references to all three analysers.
TIMED = (
    (trender, "analyse", "analyse", 2),
    (trender, "analyse_gyro", "analyse", 2),
    (trender, "encode", "encode", 4),
    (trender, "encode_2d", "encode", 4),
    (streaming, "render_streaming", "streaming", 3),
    (similarity, "analyse_similarity", "analyse", 2),
    (deshake, "analyse_deshake", "analyse", 2),
    (compare, "analyse", "analyse", 2),
    (compare, "analyse_similarity", "analyse", 2),
    (compare, "analyse_deshake", "analyse", 2),
)


def drive(name, argv, label, needs, frames=FRAMES, grid=False):
    """One CLI render with every launch count at 0 just before it; check
    that each kernel of ``needs`` launched. Returns the launch counts, the
    resolved analysis mode and what the timed entry points returned (by
    attribute name) and the seconds by what they count as, ``wall`` for
    the whole render. ``grid``: a compare render, which has no encode
    entry point: what is left of the render after its analysers (opening
    the reader, the corrections, the warps, the tiling and the write) is
    reported as ``rest``."""
    seen, returned = {}, {}
    resolve_orig = trender.resolve_analysis_mode

    def timed(attr, key, fn, prof_arg):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seen[key] = seen.get(key, 0.0) + time.perf_counter() - t0
            seen["profiler"] = args[prof_arg]
            returned[attr] = out
            return out
        return wrapper

    def resolve(options, device):
        seen["mode"] = resolve_orig(options, device)
        return seen["mode"]

    originals = [(mod, attr, getattr(mod, attr)) for mod, attr, _, _ in TIMED]
    for mod, attr, key, prof_arg in TIMED:
        setattr(mod, attr, timed(attr, key, getattr(mod, attr), prof_arg))
    trender.resolve_analysis_mode = streaming.resolve_analysis_mode = resolve
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv)
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)
        trender.resolve_analysis_mode = streaming.resolve_analysis_mode = resolve_orig
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"[{name}] cli.main returned {rc}")
    log(f"[{name}] {' '.join(argv[3:])}: analysis mode {seen.get('mode')!r}; "
        f"launches {launches}")
    for kname in needs:
        check(launches.get(kname, 0) > 0, f"[{name}] kernel {kname} was not launched")
    # Every render here tracks at 1920x1440 or more, where K2 stages every level.
    check(launches[lk_kernel.PLAIN_LEVEL.name] == 0, f"[{name}] ran the plain LK level")
    secs, calls = seen["profiler"].all_totals()
    steady, steady_calls = seen["profiler"].totals()
    log(f"[{name}] per-stage host wall time ({label}), warm-up included; in "
        f"brackets each stage without its first calls:")
    for stage_name in secs:
        log(f"    {stage_name}: {secs[stage_name]:.3f} s over {calls[stage_name]} calls "
            f"[{steady[stage_name]:.3f} s over {steady_calls[stage_name]}]")
    if grid:
        seen["rest"] = wall - seen["analyse"]
    rates = [f"{key} {frames / seen[key]:.2f} fps ({seen[key]:.2f} s)"
             for key in ("analyse", "encode", "streaming", "rest") if key in seen]
    log(f"[{name}] {label}, {frames} frames: {', '.join(rates)}, whole render "
        f"{wall:.2f} s; peak device memory {peak / 2**30:.2f} GiB")
    times = {k: v for k, v in seen.items() if isinstance(v, float)}
    return launches, seen.get("mode"), returned, dict(times, wall=wall)


def check_output_size(name, dest):
    meta = open_reader(dest).meta
    warper = stock_cameras()
    log(f"[{name}] output {meta.width}x{meta.height}, {meta.num_frames} frames")
    check((meta.width, meta.height, meta.num_frames) ==
          (warper.out_w, warper.out_h, FRAMES), f"[{name}] output has the wrong size")


def check_same_trajectory(name, got: Trajectory, want: Trajectory, n: int = FRAMES):
    err = float(np.abs(got.params - want.params).max())
    log(f"[{name}] trajectory max |d rotvec| {err:.3e} rad against the reference run")
    check(got.num_frames == want.num_frames == n and err <= TRAJ_ATOL_RAD,
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


def check_level_frame(dest, traj, dev):
    """The ``--horizon-lock`` render (stabilise none): its size, which has
    no stabilise buffer, and the middle frame against the plain warp under
    the levelled corrections."""
    opts = trender.RenderOptions(horizon_lock=True, preset=CameraPreset(PRESET))
    in_cam, out_cam = trender.build_cameras(trender.VideoMeta(W, H, 30, FRAMES), opts)
    warper = trender.FrameWarper(in_cam, out_cam)
    meta = open_reader(dest).meta
    log(f"[horizon-lock] output {meta.width}x{meta.height}, {meta.num_frames} frames")
    check((meta.width, meta.height, meta.num_frames) == (warper.out_w, warper.out_h, FRAMES),
          "[horizon-lock] output has the wrong size")
    t = FRAMES // 2
    corr = trender.compute_corrections(traj, opts, dev)
    plain = trender.compute_corrections(
        traj, trender.RenderOptions(preset=CameraPreset(PRESET)), dev)
    log(f"[horizon-lock] largest correction {trender.max_rotation_deg(corr):.3f} deg "
        f"(without the lock {trender.max_rotation_deg(plain):.3f} deg)")
    check(trender.max_rotation_deg(corr) > 0.01, "[horizon-lock] the lock corrected nothing")
    rot = torch.from_numpy(corr[t:t + 1]).to(dev)
    y, u, v = source_frame(dev, SOURCE, t)
    want_y = warp_kernel.warp_planes_u8_plain(
        y[None, None], rot, warper.out_cam, warper.in_cam, (warper.out_h, warper.out_w))[0, 0]
    want_uv = warp_kernel.warp_planes_u8_plain(
        torch.stack([u, v])[None], rot, warper.out_half, warper.in_half,
        (warper.out_h // 2, warper.out_w // 2), 128.0)[0]
    check_planes("horizon-lock", t, written_frames(dest, (t,))[t],
                 (want_y, want_uv[0], want_uv[1]), dev)


def check_same_frames(name, got_path, want_path, dev, n: int = FRAMES):
    """The first, middle and last frames within one count, >= 99.9% equal."""
    which = (0, n // 2, n - 1)
    for i, (a, b) in enumerate(zip(open_reader(got_path), open_reader(want_path))):
        if i not in which:
            continue
        for plane, pa, pb in zip("yuv", a, b):
            err, equal = u8_agreement(torch.from_numpy(np.array(pa)).to(dev),
                                      torch.from_numpy(np.array(pb)).to(dev))
            log(f"[{name}] frame {i} plane {plane}: max |diff| {err}, equal {equal:.6f}")
            check(err <= 1 and equal >= MIN_EQUAL, f"[{name}] frame {i} differs")


def written_frames(dest, which):
    """{index: (y, u, v) uint8 numpy planes} of the frames ``which``."""
    out = {}
    reader = open_reader(dest)
    for i, planes in enumerate(reader):
        if i in which:
            out[i] = tuple(np.array(p) for p in planes)
        if i >= max(which):
            break
    reader.close()
    return out


def check_planes(name, t, got, want, dev):
    """Written uint8 planes against float or uint8 planes on any device."""
    for plane, g, w in zip("yuv", got, want):
        w = w if w.dtype == torch.uint8 else warp_kernel.to_u8(w)
        err, equal = u8_agreement(torch.from_numpy(g).to(dev), w.to(dev))
        log(f"[{name}] frame {t} plane {plane}: max |diff| {err}, equal {equal:.6f}")
        check(tuple(g.shape) == tuple(w.shape) and err <= 1 and equal >= MIN_EQUAL,
              f"[{name}] frame {t} plane {plane} differs from its plain warp")


def float_frame(dev, uri, t):
    return tuple(p.to(torch.float32) for p in source_frame(dev, uri, t))


def check_vidstab_frames(dest, dev):
    """The first, middle and last written frames against
    ``warp_frame_similarity`` on the saved trajectory's corrections."""
    meta = open_reader(dest).meta
    check((meta.width, meta.height, meta.num_frames) == (W, H, FRAMES),
          "[vidstab] output has the wrong size")
    traj = Trajectory.load(trajectory_path(dest))
    check(traj.kind == "similarity" and traj.num_frames == FRAMES,
          "[vidstab] trajectory has the wrong kind or length")
    opts = trender.RenderOptions(filter="vidstab", stabilise="smooth")
    corr = torch.from_numpy(similarity.similarity_corrections(traj, opts)).to(dev)
    log(f"[vidstab] trajectory ends at dx {traj.params[-1, 0]:.2f} px, dy "
        f"{traj.params[-1, 1]:.2f} px, angle {traj.params[-1, 2]:.5f} rad")
    which = (0, FRAMES // 2, FRAMES - 1)
    for t, got in written_frames(dest, which).items():
        want = similarity.warp_frame_similarity(*float_frame(dev, SOURCE, t), corr[t])
        check_planes("vidstab", t, got, want, dev)


def check_deshake_frames(dest, src, dev):
    """The first and last written frames against ``warp_frame_deshake`` on
    the card, the middle one against the same warp on CPU tensors."""
    n = DESHAKE_FRAMES
    meta = open_reader(dest).meta
    check((meta.width, meta.height, meta.num_frames) == (W, H, n),
          "[deshake] output has the wrong size")
    traj = Trajectory.load(trajectory_path(dest))
    check(traj.kind == "translation" and traj.num_frames == n,
          "[deshake] trajectory has the wrong kind or length")
    opts = trender.RenderOptions(filter="deshake", stabilise="smooth")
    corr = torch.from_numpy(deshake.deshake_corrections(traj, opts))
    log(f"[deshake] trajectory ends at dx {traj.params[-1, 0]:.2f} px, dy "
        f"{traj.params[-1, 1]:.2f} px; largest correction "
        f"{float(corr.abs().max()):.2f} px")
    for t, got in written_frames(dest, (0, n // 2, n - 1)).items():
        where = torch.device("cpu") if t == n // 2 else dev
        planes = tuple(p.to(where) for p in float_frame(dev, src, t))
        want = deshake.warp_frame_deshake(*planes, corr[t].to(where))
        check_planes(f"deshake, plain warp on {where.type}", t, got, want, dev)


def check_compare_cells(dest, src, returned, dev, modes=COMPARE_MODES, **opts):
    """The canvas size, and each cell of the first and last frames against
    the plain warp of that cell from the trajectories the grid's own
    analysers returned; ``opts`` are the render's ``--interp`` and
    ``--projection``."""
    n = COMPARE_FRAMES
    interp = opts.get("interp", "bilinear")
    in_cam, out_cam = trender.build_cameras(trender.VideoMeta(W, H, 30, FRAMES),
                                            stock_options(**opts))
    ch = out_cam.height - out_cam.height % 2
    cw = out_cam.width - out_cam.width % 2
    rows, cols = compare.comparison_grid_size(len(modes))
    meta = open_reader(dest).meta
    log(f"[compare] canvas {meta.width}x{meta.height}, {meta.num_frames} frames, "
        f"{rows}x{cols} cells of {cw}x{ch}")
    check((meta.width, meta.height, meta.num_frames) == (cw * cols, ch * rows, n),
          "[compare] canvas has the wrong size")

    def corrections(mode):
        """(family, per-frame corrections) of one cell, from its mode."""
        family, stabilise, lock = compare._parse_mode(mode)
        opts = trender.RenderOptions(stabilise=stabilise, horizon_lock=lock,
                                     preset=CameraPreset(PRESET))
        if family == "rotation":
            corr = trender.compute_corrections(returned["analyse"], opts, dev)
        elif family == "similarity":
            corr = similarity.similarity_corrections(returned["analyse_similarity"], opts)
        else:
            corr = deshake.deshake_corrections(returned["analyse_deshake"], opts)
        check(len(corr) == n, f"[compare] the trajectory of {mode} has the wrong length")
        return family, corr

    per_mode = [corrections(m) for m in modes]
    need = max((trender.max_rotation_deg(c) for f, c in per_mode if f == "rotation"),
               default=0.0)
    warper = trender.FrameWarper(in_cam, out_cam, max(8.0, need + 0.5),
                                 opts.get("prefilter") == "auto", interp, dev)

    def rotation_cell(planes, rot):
        rot = torch.from_numpy(rot).to(dev)
        y = warp_kernel.warp_planes_f32_plain(
            planes[0][None], rot, warper.out_cam, warper.in_cam, (ch, cw), 0.0, interp,
            warper.levels[0])[0]
        uv = warp_kernel.warp_planes_f32_plain(
            torch.stack(planes[1:]), rot, warper.out_half, warper.in_half,
            (ch // 2, cw // 2), 128.0, interp, warper.levels[1])
        return y, uv[0], uv[1]

    def padded(planes):
        """An input-size cell centred in the grid cell, black and neutral
        chroma around it."""
        out = []
        for p, scale, fill in zip(planes, (1, 2, 2), (0, 128, 128)):
            h, w = ch // scale, cw // scale
            cell = torch.full((h, w), fill, dtype=torch.uint8, device=dev)
            oy, ox = (h - p.shape[0]) // 2, (w - p.shape[1]) // 2
            cell[oy:oy + p.shape[0], ox:ox + p.shape[1]] = warp_kernel.to_u8(p)
            out.append(cell)
        return out

    def cell(planes, family, corr):
        if family == "rotation":
            return rotation_cell(planes, corr)
        corr = torch.from_numpy(corr).to(dev)
        if family == "similarity":
            return padded(similarity.warp_frame_similarity(*planes, corr, interp=interp))
        return padded(deshake.warp_frame_deshake(*planes, corr))

    for t, canvas in written_frames(dest, (0, n - 1)).items():
        planes = float_frame(dev, src, t)
        cells = [cell(planes, family, corr[t]) for family, corr in per_mode]
        for i, (mode, want) in enumerate(zip(modes, cells)):
            r, c = divmod(i, cols)
            got = tuple(p[r * (ch // s):(r + 1) * (ch // s), c * (cw // s):(c + 1) * (cw // s)]
                        for p, s in zip(canvas, (1, 2, 2)))
            check_planes(f"compare cell {mode}", t, got, want, dev)


def scanline_rotations(traj, opts, dev, warper=None):
    """(T, ny, 3, 3) luma and (T, nyc, 3, 3) chroma row rotations of a
    ``--rolling-shutter`` render of ``traj`` by the velocity model, from
    the library's parts (not through ``encode``), for ``warper``'s
    cameras (the stock ones by default)."""
    warper = warper or stock_cameras()
    corr = torch.from_numpy(trender.compute_corrections(traj, opts, dev)).to(dev)
    fractions = scan_fractions(warper.out_cam, warper.in_cam,
                               num_tile_rows(warper.out_h)).to(dev)
    rows = rs_row_rotations(corr, torch.from_numpy(traj.rotations()).to(dev),
                            opts.rolling_shutter, fractions)
    return rows, warp_kernel.chroma_row_rotations(rows, num_tile_rows(warper.out_h // 2))


def check_frames_vs_plain(name, dest, rot_y, rot_c, which, dev, warper=None,
                          source=SOURCE):
    """The written frames ``which`` against the plain warp of their source
    frames under ``rot_y[t]`` (luma) and ``rot_c[t]`` (chroma): one (3, 3)
    each, or per-tile-row stacks, through ``warper``'s cameras and modes
    (the stock warper by default). Within one count, 99.9% equal; the
    differing values are counted."""
    warper = warper or stock_cameras()
    oh, ow = warper.out_h, warper.out_w
    worst, least, differ = 0, 1.0, 0
    reader = open_reader(dest)
    for t, planes in enumerate(reader):
        if t not in which:
            continue
        y, u, v = source_frame(dev, source, t)
        want_y = warp_kernel.warp_planes_u8_plain(
            y[None, None], rot_y[t:t + 1], warper.out_cam, warper.in_cam, (oh, ow), 0.0,
            warper.interp, warper.levels[0])[0, 0]
        want_uv = warp_kernel.warp_planes_u8_plain(
            torch.stack([u, v])[None], rot_c[t:t + 1], warper.out_half, warper.in_half,
            (oh // 2, ow // 2), 128.0, warper.interp, warper.levels[1])[0]
        for plane, got, want in zip("yuv", planes, (want_y, want_uv[0], want_uv[1])):
            got = torch.from_numpy(np.array(got)).to(dev)
            err, equal = u8_agreement(got, want)
            worst, least = max(worst, err), min(least, equal)
            differ += int((got != want).sum()) if got.shape == want.shape else got.numel()
            check(tuple(got.shape) == tuple(want.shape) and err <= 1 and equal >= MIN_EQUAL,
                  f"[{name}] frame {t} plane {plane} differs from its plain warp: "
                  f"max |diff| {err}, equal {equal:.6f}")
        if t >= max(which):
            break
    reader.close()
    log(f"[{name}] {len(which)} written frames against their plain warps: max |diff| "
        f"{worst} count, {differ} values differ, least equal share {least:.6f}")


def check_one_frame_rs(dest, rot_y, which, dev):
    """The library's one-frame entries (no CLI option reaches them with
    per-tile-row rotations: ``--compare`` refuses ``--rolling-shutter``):
    ``FrameWarper.warp_yuv`` and ``FrameWarper.__call__`` on the frames
    ``which`` of the clip under the row rotations of the render ``dest``.
    The uint8 entry must reproduce the written frame, the float entry
    round to it. A check of the entries, not a render: its launches are
    logged here and stay out of the renders' counts."""
    warper = stock_cameras()
    written = written_frames(dest, which)
    zero_launches()
    for t in which:
        planes = source_frame(dev, SOURCE, t)
        check_planes("one-frame rs, uint8", t, written[t],
                     warper.warp_yuv(*planes, rot_y[t]), dev)
        check_planes("one-frame rs, float", t, written[t],
                     warper(*(p.to(torch.float32) for p in planes), rot_y[t]), dev)
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"[one-frame rs] FrameWarper.warp_yuv and FrameWarper.__call__ on "
        f"{len(which)} frames, outside every render: launches {launches}")
    for name in ("warp_yuv_luma_rs", "warp_yuv_chroma_rs", "warp_frame_f32_rs",
                 "warp_planes_f32_rs"):
        check(launches[name] == len(which), f"[one-frame rs] {name} was not launched")


def mode_warper(dest, dev, **opts):
    """The render ``dest``'s own warper (cameras, modes, level maps probing
    its budget) and luma rotations, from its saved trajectory."""
    o = stock_options(**opts)
    in_cam, out_cam = trender.build_cameras(trender.VideoMeta(W, H, 30, FRAMES), o)
    corr = trender.compute_corrections(Trajectory.load(trajectory_path(dest)), o, dev)
    budget = max(o.max_correction_deg, trender.max_rotation_deg(corr) + 0.5)
    warper = trender.FrameWarper(in_cam, out_cam, budget, o.prefilter == "auto", o.interp,
                                 dev)
    return warper, torch.from_numpy(corr).to(dev), budget


def check_mode_render(name, dest, dev, n, **opts):
    """A render in one of K1's modes: its size, and its first and last
    frames against the plain warp of the same mode."""
    warper, corr, budget = mode_warper(dest, dev, **opts)
    meta = open_reader(dest).meta
    log(f"[{name}] output {meta.width}x{meta.height}, {meta.num_frames} frames; the largest "
        f"correction probed by a level map {budget:.3f} deg")
    check((meta.width, meta.height, meta.num_frames) == (warper.out_w, warper.out_h, n),
          f"[{name}] output has the wrong size")
    check_frames_vs_plain(name, dest, corr, corr, (0, n - 1), dev, warper,
                          source=mode_source(n))
    return warper


def mode_source(n: int) -> str:
    return f"synthetic://shaky?w={W}&h={H}&n={n}"


def check_vidstab_bicubic(dest, dev, n):
    """The ``--filter vidstab --interp bicubic`` render: its first and last
    frames against the plain version of K1's 4-tap mode between identity
    cameras, and within one count of ``warp_frame_similarity``."""
    traj = Trajectory.load(trajectory_path(dest))
    opts = trender.RenderOptions(filter="vidstab", stabilise="smooth", interp="bicubic")
    corr = similarity.similarity_corrections(traj, opts)
    sim = similarity.SimilarityWarper(W, H, interp="bicubic")
    mats = torch.from_numpy(similarity.SimilarityWarper.matrices(corr)).to(dev)
    # The identity cameras make SimilarityWarper's geometry a FrameWarper's.
    warper = trender.FrameWarper(sim.cam, sim.cam, interp="bicubic")
    warper.in_half = warper.out_half = sim.cam_c
    check_frames_vs_plain("vidstab-bicubic", dest, mats, mats, (0, n - 1), dev, warper,
                          source=mode_source(n))
    corr = torch.from_numpy(corr).to(dev)
    for t, got in written_frames(dest, (n // 2,)).items():
        want = similarity.warp_frame_similarity(*float_frame(dev, mode_source(n), t), corr[t],
                                                interp="bicubic")
        check_planes("vidstab-bicubic, warp_frame_similarity", t, got, want, dev)


def up_angle_deg(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    return math.degrees(math.acos(min(1.0, max(-1.0, cos))))


def int32_checksum(path) -> int:
    """The sum of every byte of a y4m's frames, wrapped to int32 as the
    device sink wraps it."""
    total = 0
    reader = open_reader(path)
    for planes in reader:
        total += sum(int(np.asarray(p).sum(dtype=np.int64)) for p in planes)
    reader.close()
    return (total + 2**31) % 2**32 - 2**31


def phase_device_sink(written, y4m_seconds, dev, label):
    """(a) The streaming stock render with ``device_sink``: the frames fold
    into a checksum on the card, nothing is read back or written. Its fps
    beside the same render written to y4m (``written``, the streaming
    render before it), and its checksum held to the int32-wrapped sum of
    that render's planes. Returns the launch counts of the run."""
    seen = []

    class Recording(prefetch.DeviceReduceSink):
        def close(self):
            super().close()
            seen.append(self.checksum)

    options = stock_options(streaming=True, no_output=True, device_sink=True)
    original = streaming.DeviceReduceSink
    streaming.DeviceReduceSink = Recording
    zero_launches()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trender.render(SOURCE, None, options, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        streaming.DeviceReduceSink = original
    launches = launch_counts()
    for kname in ("warp_luma", "warp_chroma", "stage", "lk_level"):
        check(launches[kname] > 0, f"[device-sink] kernel {kname} was not launched")
    want = int32_checksum(written)
    log(f"[device-sink] streaming stock render, {FRAMES} frames, device sink: "
        f"{FRAMES / secs:.2f} fps ({secs:.2f} s); the same render written to y4m "
        f"{FRAMES / y4m_seconds:.2f} fps ({y4m_seconds:.2f} s), on {label}; "
        f"launches {launches}")
    log(f"[device-sink] checksum {seen}, the y4m render's planes summed in int32 {want}")
    check(seen == [want], "[device-sink] the checksum is not the written planes' sum")
    return launches


def png_size(path):
    """(width, height) from a PNG's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    check(head[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])


def phase_crop(tmp, run, full, dev):
    """(b) The two-phase stock render again from the same trajectory file
    with ``--crop CROP_SPEC``: every frame equal, byte for byte, to the same
    window of the uncropped render ``full``; then with ``--debug --preview
    DIR`` too: the cropped size, the HUD drawn into the luma alone, and a
    PNG of the cropped size every PREVIEW_EVERY frames."""
    crop = os.path.join(tmp, "crop.y4m")
    shutil.copy(trajectory_path(full), trajectory_path(crop))
    flags = ["--stabilise", "smooth", "--preset", PRESET, "--encode-only",
             "--crop", CROP_SPEC]
    run("crop", crop, flags, ("warp_luma", "warp_chroma"))
    fmeta, cmeta = open_reader(full).meta, open_reader(crop).meta
    ch, cw, cy, cx = trender.parse_crop_rect(CROP_SPEC, fmeta.width, fmeta.height)
    check((cmeta.width, cmeta.height, cmeta.num_frames) == (cw, ch, FRAMES),
          "[crop] output has the wrong size")
    n = 0
    for i, (f, c) in enumerate(zip(open_reader(full), open_reader(crop))):
        window = (f[0][cy:cy + ch, cx:cx + cw],
                  f[1][cy // 2:(cy + ch) // 2, cx // 2:(cx + cw) // 2],
                  f[2][cy // 2:(cy + ch) // 2, cx // 2:(cx + cw) // 2])
        check(all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(c, window)),
              f"[crop] frame {i} differs from the uncropped render's window")
        n += 1
    check(n == FRAMES, f"[crop] {n} frames compared")
    log(f"[crop] --crop '{CROP_SPEC}': {cw}x{ch} at ({cx}, {cy}) of the "
        f"{fmeta.width}x{fmeta.height} canvas; all {n} frames equal, byte for byte, to "
        f"the uncropped render's window")
    hud = os.path.join(tmp, "crop_debug.y4m")
    shutil.copy(trajectory_path(full), trajectory_path(hud))
    preview = os.path.join(tmp, "preview")
    run("crop-debug-preview", hud, flags + ["--debug", "--preview", preview],
        ("warp_luma", "warp_chroma"))
    hmeta = open_reader(hud).meta
    check((hmeta.width, hmeta.height, hmeta.num_frames) == (cw, ch, FRAMES),
          "[crop-debug-preview] output has the wrong size")
    first = written_frames(hud, (0,))[0], written_frames(crop, (0,))[0]
    drawn = int((first[0][0] != first[1][0]).sum())
    check(drawn > 0 and all(np.array_equal(a, b) for a, b in zip(first[0][1:], first[1][1:])),
          "[crop-debug-preview] the HUD is not in the luma alone")
    pngs = sorted(os.listdir(preview))
    want = [f"preview_{i:06d}.png" for i in range(0, FRAMES, PREVIEW_EVERY)]
    sizes = {png_size(os.path.join(preview, name)) for name in pngs}
    log(f"[crop-debug-preview] {hmeta.width}x{hmeta.height}; the HUD changed {drawn} luma "
        f"values of frame 0; {len(pngs)} preview PNGs of {sizes}")
    check(pngs == want and sizes == {(cw, ch)}, "[crop-debug-preview] wrong preview PNGs")
    for path in (crop, hud):
        os.remove(path)


def phase_trace(tmp, run, flags, needs):
    """(c) A TRACE_FRAMES-frame stock render with ``--trace DIR``: the
    Chrome trace it writes must hold K1's and K2's kernels, or the device
    was not traced."""
    src = f"synthetic://shaky?w={W}&h={H}&n={TRACE_FRAMES}"
    trace_dir = os.path.join(tmp, "trace")
    dest = os.path.join(tmp, "traced.y4m")
    run("trace", dest, flags + ["--trace", trace_dir], needs, source=src, frames=TRACE_FRAMES)
    files = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    check(len(files) == 1, f"[trace] {trace_dir} holds {files}")
    path = os.path.join(trace_dir, files[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    k1 = {n: c for n, c in kernels.items() if "warp_kernel" in n}
    k2 = {n: c for n, c in kernels.items() if "lk_level_kernel" in n}
    log(f"[trace] {files[0]}: {os.path.getsize(path) / 2**20:.1f} MiB, {len(events)} events, "
        f"{sum(kernels.values())} kernel launches of {len(kernels)} kernels; K1 {k1}; K2 {k2}")
    check(k1 and k2, "[trace] the trace does not name K1's and K2's kernels")
    shutil.rmtree(trace_dir)
    os.remove(dest)


def cli_json(argv):
    """``cli.main(argv)``'s exit code and the JSON it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, json.loads(out.getvalue()) if rc == 0 else None


def phase_workflow(tmp, telemetry):
    """(d) The match workflow through the CLI on three 640x480 y4m chapters:
    ``join`` (the route it took), ``probe`` of the joined clip and of the
    gyro phase's telemetry MP4, ``workflow tag --sets-json``, ``workflow
    split`` (each set rendered with ``--stabilise smooth --crop CROP_SPEC``
    in a child process of the port's CLI, two at once on the card), then
    ``workflow encode``."""
    d = os.path.join(tmp, "match")
    os.makedirs(d)
    t0 = time.perf_counter()
    for seed, name in enumerate(CHAPTERS):
        reader = open_reader(CHAPTER_URI.format(seed=seed))
        writer = open_writer(os.path.join(d, name), reader.meta)
        for planes in reader:
            writer.write(tuple(np.asarray(p) for p in planes))
        writer.close()
        reader.close()
    routes, join = [], gopro.join

    def recording_join(*args, **kwargs):
        routes.append(join(*args, **kwargs))
        return routes[-1]

    joined = os.path.join(d, "match_0001.y4m")
    gopro.join = recording_join
    try:
        rc = cli.main(["join", "0001", "-o", joined, "--directory", d])
    finally:
        gopro.join = join
    check(rc == 0 and routes, f"[workflow] join returned {rc}")
    chapter = SyntheticSource.from_uri(CHAPTER_URI.format(seed=0)).meta
    rc, info = cli_json(["probe", joined])
    video = info["video"] if info else None
    log(f"[workflow] join of {len(CHAPTERS)} chapters took the {routes[0]!r} route; probe: "
        f"{video}")
    check(rc == 0 and video["num_frames"] == len(CHAPTERS) * chapter.num_frames
          and (video["width"], video["height"]) == (chapter.width, chapter.height),
          "[workflow] the joined clip does not probe as the chapters")
    rc, info = cli_json(["probe", telemetry])
    log(f"[workflow] probe of the telemetry MP4: tracks {info and info['tracks']}, "
        f"gpmf {info and info['gpmf']}")
    check(rc == 0 and info["video"] is None and info["gpmf"]["gyro"]["samples"] > 0,
          "[workflow] the telemetry MP4 does not probe")
    rc = cli.main(["workflow", "tag", "0001", "--directory", d,
                   "--sets-json", json.dumps(list(MATCH_SETS))])
    check(rc == 0, f"[workflow] tag returned {rc}")
    children, run = [], subprocess.run

    def recording_run(cmd, **kwargs):
        done = run(cmd, **kwargs)
        children.append((cmd, done.returncode, done.stderr))
        return done

    t_split = time.perf_counter()
    subprocess.run = recording_run
    try:
        rc = cli.main(["workflow", "split", "0001", "--directory", d, "--concurrency", "2",
                       "--render-args", f"--stabilise smooth --preset {PRESET} --crop {CROP_SPEC}"])
    finally:
        subprocess.run = run
    split_s = time.perf_counter() - t_split
    for cmd, code, err in children:
        log(f"[workflow] child: {' '.join(cmd[1:4])} ... {' '.join(cmd[6:])}: exit {code}"
            + (f"; {err[-300:]}" if code else ""))
    check(rc == 0 and len(children) == len(MATCH_SETS)
          and all(cmd[1:3] == ["-m", "video_annotator_tpu_torch"] and code == 0
                  for cmd, code, _ in children),
          "[workflow] split's renders did not all run in the port's CLI")
    in_cam, out_cam = trender.build_cameras(chapter, stock_options())
    canvas = trender.FrameWarper(in_cam, out_cam)
    ch, cw, _, _ = trender.parse_crop_rect(CROP_SPEC, canvas.out_w, canvas.out_h)
    for i in range(1, len(MATCH_SETS) + 1):
        out = os.path.join(d, f"match_0001_set{i}.y4m")
        meta = open_reader(out).meta
        check(os.path.exists(out + ".complete")
              and (meta.width, meta.height, meta.num_frames) == (cw, ch, SET_FRAMES),
              f"[workflow] set {i}: {meta.width}x{meta.height}, {meta.num_frames} frames")
    log(f"[workflow] split: {len(children)} sets of {cw}x{ch}, {SET_FRAMES} frames each, "
        f"rendered by child processes two at once in {split_s:.2f} s")
    rc = cli.main(["workflow", "encode", "0001", "--directory", d])
    finals = []
    for i in range(1, len(MATCH_SETS) + 1):
        reader = open_reader(os.path.join(d, f"match_0001_set{i}_final.mp4"))
        finals.append((reader.meta.width, reader.meta.height, sum(1 for _ in reader)))
        reader.close()
    log(f"[workflow] encode: {finals}; the workflow took {time.perf_counter() - t0:.2f} s")
    check(rc == 0 and finals == [(cw, ch, SET_FRAMES)] * len(MATCH_SETS),
          "[workflow] encode did not write every set")
    shutil.rmtree(d)


def phase_renders(dev, label, native_ok, native_why):
    """The renders; returns the launch counts summed over them."""
    total = {n: 0 for n in cuda_lib.KERNELS}
    warp_stage = ("warp_luma", "warp_chroma", "stage")
    tmp = tempfile.mkdtemp(prefix="vat_torch_smoke_")
    stock = ["--stabilise", "smooth", "--preset", PRESET]
    tracked = stock + ["--analysis-mode", "tracked"]

    def run(name, dest, flags, needs, source=SOURCE, counts=None, **kw):
        launches, mode, returned, times = drive(
            name, ["render", source, dest] + flags, label, needs, **kw)
        for n, c in launches.items():
            total[n] = total.get(n, 0) + c
        if counts is not None:
            counts.update(launches)
        return mode, returned, times

    try:
        two = os.path.join(tmp, "two.y4m")
        mode, _, _ = run("render", two, stock, warp_stage + ("lk_level",))
        check(mode == "paired", "analysis mode did not resolve to paired")
        check_output_size("render", two)
        traj_two = Trajectory.load(trajectory_path(two))
        rms = rms_vs_truth(traj_two)
        log(f"[render] trajectory RMS vs ground truth {rms:.4f} deg")
        check(traj_two.num_frames == FRAMES and rms < MAX_RMS_DEG, "trajectory is off")
        check_frame_vs_plain(two, traj_two, dev)
        phase_crop(tmp, run, two, dev)

        one = os.path.join(tmp, "one.y4m")
        mode, _, times = run("streaming", one, stock + ["--streaming"],
                             warp_stage + ("lk_level",))
        check(mode == "paired", "streaming analysis mode did not resolve to paired")
        check_output_size("streaming", one)
        check_same_trajectory("streaming", Trajectory.load(trajectory_path(one)), traj_two)
        check_same_frames("streaming", one, two, dev)
        os.remove(two)
        for n, c in phase_device_sink(one, times["streaming"], dev, label).items():
            total[n] += c
        os.remove(one)
        phase_trace(tmp, run, stock, warp_stage + ("lk_level",))

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

        smooth = ["--stabilise", "smooth"]
        vid = os.path.join(tmp, "vidstab.y4m")
        run("vidstab", vid, ["--filter", "vidstab"] + smooth,
            warp_stage + ("lk_level_frame",))
        check_vidstab_frames(vid, dev)
        os.remove(vid)

        src = f"synthetic://shaky?w={W}&h={H}&n={DESHAKE_FRAMES}"
        shake = os.path.join(tmp, "deshake.y4m")
        flags = ["--filter", "deshake"] + smooth
        _, _, times = run("deshake", shake, flags, (), source=src, frames=DESHAKE_FRAMES)
        check_deshake_frames(shake, src, dev)
        os.remove(shake)
        trace_render("deshake analyse", ["render", src, shake, "-a"] + flags,
                     DESHAKE_FRAMES, times["analyse"])

        src = f"synthetic://shaky?w={W}&h={H}&n={COMPARE_FRAMES}"
        grid = os.path.join(tmp, "grid.y4m")
        flags = ["--compare", ",".join(COMPARE_MODES), "--no-cell-labels",
                 "--preset", PRESET]
        _, returned, times = run(
            "compare", grid, flags,
            ("warp_frame_f32", "warp_planes_f32", "warp_yuv_luma", "warp_yuv_chroma",
             "stage", "lk_level", "lk_level_frame"),
            source=src, frames=COMPARE_FRAMES, grid=True)
        check_compare_cells(grid, src, returned, dev)
        os.remove(grid)
        trace_render("compare", ["render", src, grid] + flags, COMPARE_FRAMES,
                     times["wall"])
        os.remove(grid)

        flags = ["--compare", ",".join(LOCK_MODES), "--no-cell-labels", "--preset", PRESET]
        _, returned, _ = run(
            "compare-lock", grid, flags,
            ("warp_frame_f32", "warp_planes_f32", "warp_yuv_luma", "warp_yuv_chroma",
             "stage", "lk_level", "lk_level_frame"),
            source=src, frames=COMPARE_FRAMES, grid=True)
        check_compare_cells(grid, src, returned, dev, modes=LOCK_MODES)
        os.remove(grid)

        rs_kernels = ("warp_luma_rs", "warp_chroma_rs")
        rolling = os.path.join(tmp, "rolling.y4m")
        rs_flags = ["--rolling-shutter", str(READOUT)]
        launches = {}
        run("rolling-shutter", rolling, stock + rs_flags,
            rs_kernels + ("stage", "lk_level"), counts=launches)
        check(launches["warp_luma"] == launches["warp_chroma"] == 0,
              "[rolling-shutter] a whole-frame warp was launched")
        check_output_size("rolling-shutter", rolling)
        check_same_trajectory("rolling-shutter", Trajectory.load(trajectory_path(rolling)),
                              traj_two)
        rot_y, rot_c = scanline_rotations(traj_two, stock_options(rolling_shutter=READOUT), dev)
        check_frames_vs_plain("rolling-shutter", rolling, rot_y, rot_c, range(FRAMES), dev)
        check_one_frame_rs(rolling, rot_y, (0, FRAMES // 2, FRAMES - 1), dev)
        os.remove(rolling)

        level = os.path.join(tmp, "level.y4m")
        run("horizon-lock", level, ["--horizon-lock", "--preset", PRESET],
            warp_stage + ("lk_level",))
        traj_level = Trajectory.load(trajectory_path(level))
        check(traj_level.up0 is None, "[horizon-lock] a synthetic clip has no telemetry")
        check_same_trajectory("horizon-lock", traj_level, traj_two)
        check_level_frame(level, traj_level, dev)
        os.remove(level)

        telemetry = os.path.join(tmp, "telemetry.mp4")
        cfg = SyntheticSource.from_uri(SOURCE).config
        write_telemetry_mp4(telemetry, cfg, TILTED_UP)
        gyro = os.path.join(tmp, "gyro.y4m")
        run("gyro", gyro, ["-a", "--gyro", "--horizon-lock"], (), source=telemetry)
        traj_gyro = Trajectory.load(trajectory_path(gyro))
        rms = rms_vs_truth(traj_gyro)
        off = up_angle_deg(traj_gyro.up0, TILTED_UP)
        log(f"[gyro] {os.path.getsize(telemetry)} bytes of telemetry, "
            f"{traj_gyro.num_frames} frames at {float(traj_gyro.fps):.2f} fps: trajectory "
            f"RMS vs ground truth {rms:.4f} deg; up {np.round(traj_gyro.up0, 5).tolist()} is "
            f"{off:.4f} deg from the telemetry's")
        check(traj_gyro.num_frames == FRAMES and rms < MAX_RMS_DEG, "gyro trajectory is off")
        check(off < MAX_UP_DEG, "the gravity estimate is off")
        check(not os.path.exists(gyro), "[gyro] -a wrote frames")
        os.replace(trajectory_path(gyro), trajectory_path(rolling))
        lock_flags = stock + rs_flags + ["--encode-only", "--horizon-lock"]
        run("gyro-rolling-shutter", rolling, lock_flags, rs_kernels)
        check_output_size("gyro-rolling-shutter", rolling)
        rot_y, rot_c = scanline_rotations(
            traj_gyro, stock_options(rolling_shutter=READOUT, horizon_lock=True), dev)
        check_frames_vs_plain("gyro-rolling-shutter", rolling, rot_y, rot_c,
                              (0, FRAMES // 2, FRAMES - 1), dev)
        os.remove(rolling)
        phase_workflow(tmp, telemetry)
        phase_mode_renders(tmp, run)
        phase_native_render(tmp, run, native_ok, native_why)
        return total
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_mode_renders(tmp, run):
    """The renders of K1's 4-tap, ray-grid and mip modes (MODE_FRAMES
    frames each, the grid COMPARE_FRAMES)."""
    dev = torch.device("cuda")
    n = MODE_FRAMES
    src = mode_source(n)
    stock = ["--stabilise", "smooth", "--preset", PRESET]
    both = lambda variant: (f"warp_luma_{variant}", f"warp_chroma_{variant}")  # noqa: E731

    lanczos = os.path.join(tmp, "lanczos.y4m")
    run("lanczos", lanczos, stock + ["--interp", "lanczos"], both("lanczos"), source=src,
        frames=n)
    check_mode_render("lanczos", lanczos, dev, n, interp="lanczos")
    os.remove(lanczos)

    equirect = os.path.join(tmp, "equirect.y4m")
    run("equirect", equirect, stock + ["--projection", "equirect"], both("rays"), source=src,
        frames=n)
    check_mode_render("equirect", equirect, dev, n, projection="equirect")
    os.remove(equirect)

    pre = os.path.join(tmp, "prefilter.y4m")
    flags = stock + ["--prefilter", "auto", "--scale", str(MIP_SCALE)]
    run("prefilter", pre, flags, both("mip"), source=src, frames=n)
    warper = check_mode_render("prefilter", pre, dev, n, prefilter="auto", scale=MIP_SCALE)
    for which, levels in zip(("luma", "chroma"), warper.levels):
        shares = ", ".join(f"level {i} {f:.4f}" for i, f in enumerate(level_shares(levels)))
        log(f"[prefilter] {which} level map {tuple(levels.levels.shape)}: {shares}")
        check(levels.max_level >= 1, f"[prefilter] the {which} level map engages no level")
    streamed = os.path.join(tmp, "prefilter-streaming.y4m")
    run("prefilter-streaming", streamed, flags + ["--streaming"], both("mip"), source=src,
        frames=n)
    check_same_trajectory("prefilter-streaming", Trajectory.load(trajectory_path(streamed)),
                          Trajectory.load(trajectory_path(pre)), n)
    check_same_frames("prefilter-streaming", streamed, pre, dev, n)
    os.remove(pre)
    os.remove(streamed)

    vid = os.path.join(tmp, "vidstab-bicubic.y4m")
    run("vidstab-bicubic", vid, ["--filter", "vidstab", "--stabilise", "smooth", "--interp",
                                 "bicubic"], both("bicubic") + ("lk_level_frame",),
        source=src, frames=n)
    check_vidstab_bicubic(vid, dev, n)
    os.remove(vid)

    combined = os.path.join(tmp, "all-modes.y4m")
    opts = dict(interp="bicubic", projection="stereographic", prefilter="auto",
                scale=MIP_SCALE, rolling_shutter=READOUT)
    flags = stock + ["--interp", "bicubic", "--projection", "stereographic", "--prefilter",
                     "auto", "--scale", str(MIP_SCALE), "--rolling-shutter", str(READOUT)]
    run("all-modes-rolling-shutter", combined, flags, both("bicubic_rays_mip_rs"),
        source=src, frames=n)
    o = stock_options(**opts)
    in_cam, out_cam = trender.build_cameras(trender.VideoMeta(W, H, 30, FRAMES), o)
    geometry = trender.FrameWarper(in_cam, out_cam)
    rot_y, rot_c = scanline_rotations(Trajectory.load(trajectory_path(combined)), o, dev,
                                      geometry)
    need = trender.max_rotation_deg(rot_y.reshape(-1, 3, 3).cpu().numpy())
    budget = max(o.max_correction_deg, need + 0.5)
    warper = trender.FrameWarper(in_cam, out_cam, budget, True, "bicubic", dev)
    check(all(lv.max_level >= 1 for lv in warper.levels),
          "[all-modes-rolling-shutter] the level maps engage no level")
    check_frames_vs_plain("all-modes-rolling-shutter", combined, rot_y, rot_c, (0, n - 1),
                          dev, warper, source=src)
    os.remove(combined)

    csrc = f"synthetic://shaky?w={W}&h={H}&n={COMPARE_FRAMES}"
    grid = os.path.join(tmp, "grid-prefilter.y4m")
    modes = ("none", "smooth")
    flags = ["--compare", ",".join(modes), "--no-cell-labels", "--preset", PRESET,
             "--prefilter", "auto", "--scale", str(MIP_SCALE)]
    _, returned, _ = run("compare-prefilter", grid, flags,
                         ("warp_frame_f32_mip", "warp_planes_f32_mip"), source=csrc,
                         frames=COMPARE_FRAMES, grid=True)
    check_compare_cells(grid, csrc, returned, dev, modes=modes, prefilter="auto",
                        scale=MIP_SCALE)
    os.remove(grid)

    grid = os.path.join(tmp, "grid-modes.y4m")
    modes = ("none", "smooth", "vidstab")
    flags = ["--compare", ",".join(modes), "--no-cell-labels", "--preset", PRESET,
             "--interp", "bicubic", "--projection", "stereographic"]
    _, returned, _ = run(
        "compare-modes", grid, flags,
        ("warp_frame_f32_bicubic_rays", "warp_planes_f32_bicubic_rays",
         "warp_yuv_luma_bicubic", "warp_yuv_chroma_bicubic"),
        source=csrc, frames=COMPARE_FRAMES, grid=True)
    check_compare_cells(grid, csrc, returned, dev, modes=modes, interp="bicubic",
                        projection="stereographic")
    os.remove(grid)


def _device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def device_events(prof):
    """The profile's averaged events that ran on the card (kernels and
    copies). A host operator's entry repeats the device time of the
    kernels it launched, so a sum over every entry would count those
    twice."""
    on_card = torch.autograd.DeviceType.CUDA
    timed = [e for e in prof.key_averages() if _device_us(e) > 0]
    events = [e for e in timed if getattr(e, "device_type", None) == on_card]
    # A build that does not tag its entries: the card's own have no host time.
    return events or [e for e in timed if e.self_cpu_time_total == 0]


def report_device_time(tag, events, n, unit, wall_ms, top=10):
    """Device busy ms per ``unit`` (a frame, a step) summed over the
    card's own events, its idle share of the untraced ``wall_ms`` per
    unit, and the ``top`` events by device time."""
    busy_ms = sum(_device_us(e) for e in events) / 1e3 / n
    if busy_ms <= 0:
        log(f"[{tag}] device busy time: not measured (the profiler reported "
            f"no device time)")
        return
    log(f"[{tag}] device busy {busy_ms:.3f} ms per {unit} under the profiler, "
        f"{sum(e.count for e in events) / n:.1f} kernels and copies per {unit}; "
        f"device idle share of the untraced wall ({wall_ms:.3f} ms per {unit}) "
        f"{max(0.0, 1.0 - busy_ms / wall_ms):.3f}")
    for e in sorted(events, key=_device_us, reverse=True)[:top]:
        log(f"    {_device_us(e) / 1e3 / n:8.4f} ms/{unit}  "
            f"{e.count / n:6.1f}/{unit}  {e.key[:90]}")


def trace_render(name, argv, frames, wall_s):
    """The render ``argv`` once more under torch.profiler: where the
    device's time goes, against the untraced run's ``wall_s``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        rc = cli.main(argv)
        torch.cuda.synchronize()
    check(rc == 0, f"[{name}] the traced render returned {rc}")
    report_device_time(f"{name} profile", device_events(prof), frames, "frame",
                       wall_s * 1e3 / frames)


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


def phase_2d_parts(dev, label):
    """The per-frame parts of the 2D families alone on an idle card, host
    wall ms per call, synchronised: what a frame costs without the source
    and the writer that the renders above share the host and the card
    with."""
    frames = source_lumas(dev, 2)
    level = trender.analysis_level(stock_options(), trender.VideoMeta(W, H, 30, FRAMES))
    prev, curr = (box_downsample(f.to(torch.float32), level) for f in frames)
    g = torch.Generator().manual_seed(17)
    pts = (torch.rand((trender.MAX_CORNERS, 2), generator=g)
           * torch.tensor([curr.shape[1], curr.shape[0]])).to(dev)
    moved = pts * 1.001 + torch.tensor([1.5, -0.75], device=dev)
    valid = torch.ones(len(pts), dtype=torch.bool, device=dev)
    planes = float_frame(dev, SOURCE, 0)
    offset = torch.tensor([3.25, -7.5], device=dev)
    parts = (
        (f"phase_correlate, one {tuple(curr.shape)} pair",
         lambda: phase_correlate(curr, prev)),
        (f"fit_similarity, {len(pts)} points", lambda: fit_similarity(pts, moved, valid)),
        (f"warp_frame_deshake, one {W}x{H} frame",
         lambda: deshake.warp_frame_deshake(*planes, offset)),
        ("its blurred background alone (two banded products)",
         lambda: deshake.gauss_blur(planes[0])),
        (f"warp_frame_similarity (the CPU path's warp), one {W}x{H} frame",
         lambda: similarity.warp_frame_similarity(
             *planes, torch.tensor([3.25, -7.5, 0.01, 0.02], device=dev))),
    )
    log(f"[2d parts] {label}: host wall ms per call, synchronised, idle card:")
    for what, fn in parts:
        log(f"    {what}: {host_ms(fn):.3f} ms")


def phase_telemetry_parts(dev, label):
    """The telemetry layers alone on the card: the scanline poses of one
    64-frame clip from its gyro stream, and the gyro integration of a
    10-minute clip (240 000 samples at 400 Hz, 18 000 frames) by the
    prefix product, against a float64 sequential scan of the same float32
    samples on the host."""
    warper = stock_cameras()
    ny = num_tile_rows(warper.out_h)
    fractions = scan_fractions(warper.out_cam, warper.in_cam, ny).to(dev)
    g = torch.Generator().manual_seed(23)
    n = 1000  # 2.5 s at 400 Hz
    ts = (torch.arange(n, dtype=torch.float32) / 400.0).to(dev)
    omega = (torch.randn((n, 3), generator=g) * 0.5).to(dev)
    frame_ts = (torch.arange(FRAMES, dtype=torch.float32) / 30.0).to(dev)
    corr = so3.exp(torch.randn((FRAMES, 3), generator=g) * 0.02).to(dev)
    rows = rs_row_rotations_gyro(corr, omega, ts, frame_ts, READOUT / 30.0, fractions)
    host = rs_row_rotations_gyro(corr.cpu(), omega.cpu(), ts.cpu(), frame_ts.cpu(),
                                 READOUT / 30.0, fractions.cpu())
    err = float((rows.cpu() - host).abs().max())
    ms = host_ms(lambda: rs_row_rotations_gyro(corr, omega, ts, frame_ts,
                                               READOUT / 30.0, fractions))
    log(f"[telemetry parts] {label}: rs_row_rotations_gyro, {FRAMES} frames x {ny} tile "
        f"rows from {n} gyro samples: {ms:.3f} ms per call (host wall, synchronised, idle "
        f"card); max |diff| {err:.2e} against the same call on CPU tensors")
    check(tuple(rows.shape) == (FRAMES, ny, 3, 3) and err <= 1e-4,
          "rs_row_rotations_gyro differs between card and host")

    s = GYRO_SAMPLES
    t = torch.arange(s, dtype=torch.float64) / 400.0
    # A hand-held camera: slow sways plus shake, rad/s.
    omega = torch.stack([0.4 * torch.sin(t * 1.3) + 0.2 * torch.sin(t * 17.0),
                         0.3 * torch.cos(t * 0.7) + 0.2 * torch.sin(t * 23.0 + 1.0),
                         0.2 * torch.sin(t * 2.9 + 0.5)], dim=-1).to(torch.float32)
    omega = omega + torch.randn((s, 3), generator=g) * 0.05
    ts = t.to(torch.float32)
    frame_ts = torch.arange(int(s / 400.0 * 30.0), dtype=torch.float32) / 30.0
    card = integrate_gyro(omega.to(dev), ts.to(dev), frame_ts.to(dev))
    ms = host_ms(lambda: integrate_gyro(omega.to(dev), ts.to(dev), frame_ts.to(dev)), 3)
    t0 = time.perf_counter()
    scan = sequential_integrate(omega, ts, frame_ts)
    scan_s = time.perf_counter() - t0
    angle = so3.log(so3.matmul(card.cpu().double(), so3.transpose(scan))).norm(dim=-1)
    unit = (so3.matmul(card, so3.transpose(card))
            - torch.eye(3, device=dev)).abs().max()
    log(f"[telemetry parts] integrate_gyro, {s} samples -> {len(frame_ts)} frames: "
        f"{ms:.3f} ms per call on the card, uploads included (host wall, synchronised); "
        f"the float64 sequential scan on the host {scan_s:.2f} s; largest angle between "
        f"them {math.degrees(float(angle.max())):.6f} deg (at the last frame "
        f"{math.degrees(float(angle[-1])):.6f}); largest |R R^T - I| {float(unit):.2e}")
    check(math.degrees(float(angle.max())) < 0.05,
          "the prefix product drifted from the sequential scan")


# --- calibrate, quality and fidelity ---------------------------------------


def board_poses():
    """The tests' 8 board poses (tests/test_calibrate.py, seed 4)."""
    rng = np.random.default_rng(4)
    poses = []
    for _ in range(BOARD_VIEWS):
        w = torch.from_numpy((rng.normal(size=3) * np.array([0.22, 0.22, 0.1])).astype(np.float32))
        t = np.array([-4.0 + rng.uniform(-1.2, 1.2), -2.5 + rng.uniform(-1.0, 1.0),
                      rng.uniform(11.0, 16.0)])
        poses.append((so3.exp(w).numpy(), t))
    return poses


def read_fit(path):
    """(fx, fy, cx, cy, dist, rms) of a FileStorage written by ``calibrate``."""
    import cv2

    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
    try:
        k = fs.getNode("camera_matrix").mat()
        d = fs.getNode("distortion_coefficients").mat().ravel()
        rms = fs.getNode("avg_reprojection_error").real()
    finally:
        fs.release()
    return float(k[0, 0]), float(k[1, 1]), float(k[0, 2]), float(k[1, 2]), d, rms


def phase_calibrate(dev, label):
    """``calibrate`` on 8 chessboard views of a fisheye camera at 4K: the
    CLI in a child process (fit on the card, FileStorage out, undistorted
    views), the fit held to the true camera; the same fit timed in this
    process; then ``show_undistorted`` in this process with the launch
    counts at 0 just before, its PNGs equal to the child's and within one
    count of the plain warp of the same frames."""
    import cv2

    s = BOARD_SCALE
    fx, fy, cx, cy = (v * s for v in BOARD_CAMERA)
    true_cam = Camera.make(fx, fy, cx, cy, 640 * s, 480 * s, CameraModel.FISHEYE,
                           dist=BOARD_DIST)
    tmp = tempfile.mkdtemp(prefix="vat_torch_calibrate_")
    try:
        board = os.path.join(tmp, "board.y4m")
        frames = render_chessboard(true_cam, board_poses())
        writer = open_writer(board, trender.VideoMeta(true_cam.width, true_cam.height, 30))
        uv = np.full((true_cam.height // 2, true_cam.width // 2), 128, np.uint8)
        for y in frames:
            writer.write((y, uv, uv))
        writer.close()
        params, views = os.path.join(tmp, "params.xml"), os.path.join(tmp, "views")
        argv = [sys.executable, "-m", "video_annotator_tpu_torch", "calibrate", board,
                "--device", "cuda", "-o", params, "--show-undistorted", views,
                "--frames", str(BOARD_VIEWS), "--interval", "0"]
        t0 = time.perf_counter()
        done = subprocess.run(argv, capture_output=True, text=True, timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        cli_s = time.perf_counter() - t0
        check(done.returncode == 0, f"[calibrate] the CLI exited {done.returncode}: "
              f"{done.stderr[-2000:]}")
        got = read_fit(params)
        log(f"[calibrate] {' '.join(argv[3:])}: exit 0 in {cli_s:.2f} s (process start, "
            f"detection, fit, undistorted views); {done.stdout.splitlines()[0]}")
        log(f"[calibrate] fit fx {got[0]:.3f} fy {got[1]:.3f} cx {got[2]:.3f} cy {got[3]:.3f} "
            f"dist {np.round(got[4], 5).tolist()} rms {got[5]:.4f} px; true fx {fx} fy {fy} "
            f"cx {cx} cy {cy} dist {list(BOARD_DIST)}")
        for v, want, tol, what in zip(got[:4], (fx, fy, cx, cy), BOARD_TOL, "fx fy cx cy".split()):
            check(abs(v - want) < tol * s, f"[calibrate] {what} {v} is off {want} by more than "
                  f"{tol * s}")
        check(got[5] < MAX_BOARD_RMS, f"[calibrate] rms {got[5]} px")

        obj, img, size = calibrate.detect_board_views(board, max_views=BOARD_VIEWS,
                                                      interval_s=0.0)
        fit_s = []
        for _ in range(2):  # the first fit of a process warms torch.func and its kernels
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cam, rms = calibrate.calibrate(obj, img, size, CameraModel.FISHEYE, device=dev)
            fit_s.append(time.perf_counter() - t0)
        rel = max(abs(a - b) / abs(b) for a, b in zip((cam.fx, cam.fy, cam.cx, cam.cy), got))
        log(f"[calibrate] {label}: the fit alone ({len(img)} views of {len(obj)} corners, "
            f"4000 Adam steps as a CUDA graph and the LM polish on the card) {fit_s[0]:.2f} s "
            f"wall the first time in this process, {fit_s[1]:.2f} s the second; rms "
            f"{rms:.4f} px; intrinsics within {rel:.2e} relative of the CLI's")
        check(rel < 1e-3 and abs(rms - got[5]) < 0.01, "[calibrate] the fit is not the CLI's")

        again = os.path.join(tmp, "again")
        zero_launches()
        n = calibrate.show_undistorted(cam, board, again, max_frames=UNDISTORTED_VIEWS,
                                       interval_s=0.0, device=dev)
        torch.cuda.synchronize()
        launches = check_launched("calibrate", ("warp_frame_f32",))
        check(n == UNDISTORTED_VIEWS and launches["warp_frame_f32"] == n,
              f"[calibrate] {n} views, {launches['warp_frame_f32']} launches")
        out_cam = Camera.make(cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
                              CameraModel.RECTILINEAR)
        eye = torch.eye(3, device=dev)
        worst = 0
        for i in range(n):
            name = f"undistorted_{i:03d}.png"
            child = cv2.imread(os.path.join(views, name), cv2.IMREAD_GRAYSCALE)
            mine = cv2.imread(os.path.join(again, name), cv2.IMREAD_GRAYSCALE)
            check(child is not None and np.array_equal(child, mine),
                  f"[calibrate] {name} differs between the CLI and show_undistorted")
            src = torch.from_numpy(frames[i]).to(dev, torch.float32)
            plain = np.clip(warp_image(src, out_cam, cam, eye).cpu().numpy(), 0,
                            255).astype(np.uint8)
            worst = max(worst, int(np.abs(child.astype(np.int16) - plain).max()))
        log(f"[calibrate] {n} undistorted {cam.width}x{cam.height} views through K1's float "
            f"one-frame kernel: equal to the CLI's PNGs, max |diff| {worst} against the "
            f"plain warp")
        check(worst <= 1, "[calibrate] an undistorted view is off the plain warp")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_quality(dev, label):
    """``tools/quality.py --n 48`` at its 640x480: the 18 rows written, the
    tracking rows at scales 1 and 0.5 within the accuracy guard, every
    stabilised row reducing shake; the launch counts at 0 just before."""
    path = os.path.join(tempfile.mkdtemp(prefix="vat_torch_quality_"), "quality.json")
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = quality.main(["--n", str(QUALITY_FRAMES), "--device", "cuda", "--out", path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = check_launched("quality", QUALITY_KERNELS)
    check(rc == 0, f"[quality] returned {rc}")
    with open(path) as f:
        rows = {r["config"]: r for r in json.load(f)}
    shutil.rmtree(os.path.dirname(path))
    log(f"[quality] {label}: {len(rows)} rows at 640x480 x {QUALITY_FRAMES} frames in "
        f"{wall:.2f} s")
    for name, r in rows.items():
        log(f"[quality] {name}: shake {r['value']} px ({r['hf_shake_deg_rms']} deg), "
            f"reduction {r.get('reduction_db')} dB, trajectory RMS {r.get('traj_rms_deg')} deg"
            + (" (not gated)" if "_scale025" in name else ""))
    check(len(rows) == 18 and set(QUALITY_GATED) <= set(rows), "[quality] rows are missing")
    for name in QUALITY_GATED:
        check(rows[name]["traj_rms_deg"] < MAX_RMS_DEG,
              f"[quality] {name}: trajectory RMS {rows[name]['traj_rms_deg']} deg")
    for name, r in rows.items():
        if "reduction_db" in r:
            check(r["reduction_db"] > 0, f"[quality] {name} does not reduce the shake")
    return launches


def phase_fidelity(dev, label):
    """``tools/fidelity.py --dispatches 4``: PSNR >= 45 dB in every plane
    and family, p50 and p99 ms per frame; the launch counts at 0 just
    before."""
    path = os.path.join(tempfile.mkdtemp(prefix="vat_torch_fidelity_"), "fidelity.json")
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = fidelity.main(["--dispatches", str(FIDELITY_DISPATCHES), "--out", path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = check_launched("fidelity", FIDELITY_KERNELS)
    check(rc == 0, f"[fidelity] returned {rc}")
    with open(path) as f:
        r = json.load(f)
    shutil.rmtree(os.path.dirname(path))
    log(f"[fidelity] {label}, {r['geometry']} at {r['correction_deg']} deg: PSNR luma "
        f"{r['psnr_luma_db']} dB, U {r['psnr_chroma_u_db']} dB, V {r['psnr_chroma_v_db']} dB "
        f"against cv2.remap; warp_yuv_batch of {r['latency_batch']} frames, "
        f"{r['dispatches_timed']} dispatches: p50 {r['p50_warp_ms_per_frame']} ms, p99 "
        f"{r['p99_warp_ms_per_frame']} ms per frame ({wall:.2f} s in all)")
    for name, fam in r["families"].items():
        log(f"[fidelity] {name} ({fam['geometry']}): {fam['psnr_luma_db']} dB against "
            f"{fam['oracle']}")
    planes = (r["psnr_luma_db"], r["psnr_chroma_u_db"], r["psnr_chroma_v_db"])
    check(min(planes) >= fidelity.PSNR_GATE_DB, "[fidelity] a plane is under 45 dB")
    check(all(fam["psnr_luma_db"] >= fidelity.PSNR_GATE_DB for fam in r["families"].values()),
          "[fidelity] a family is under 45 dB")
    return launches


@contextlib.contextmanager
def k2_only_levels():
    """K2 alone, as the analysers tracked before the plain level: the LK
    route's staging (``lk_kernel.stage_pyramid_pairs``, which
    ``stage_pyramid`` calls too) without ``plain_levels``, so that the
    levels K2 cannot stage are None and the loops keep the coarse guess
    there (the JAX package's Pallas loops). Only to time the analyses
    against it."""
    stage = lk_kernel.stage_pyramid_pairs
    lk_kernel.stage_pyramid_pairs = lambda frames, levels, plain_levels=False: stage(frames, levels)
    try:
        yield
    finally:
        lk_kernel.stage_pyramid_pairs = stage


def clip_rms_deg(dev, mode: str, tmp: str) -> float:
    """Trajectory RMS (deg) of ``trender.analyse`` of the quality clip."""
    dest = os.path.join(tmp, f"{mode}.y4m")
    opts = trender.RenderOptions(stabilise="smooth", analysis_mode=mode,
                                 preset=CameraPreset.GOPRO_H4B_WIDE43_MEASURED)
    trender.analyse(QUALITY_CLIP, opts, device=dev).save(trajectory_path(dest))
    return quality.traj_rms_deg(dest, QUALITY_CLIP)


def clip_analyse_fps(dev, mode: str, lumas) -> tuple:
    """Analyse fps of the lumas, resident on the card, through the analyser
    of ``mode`` (decode excluded), synchronised: ``(every level, K2
    alone)``, each the best of ``CLIP_FPS_ROUNDS`` rounds that alternate
    the two, after a warm-up of each."""
    meta = trender.VideoMeta(640, 480, 30, len(lumas))
    opts = trender.RenderOptions(stabilise="smooth", analysis_mode=mode,
                                 preset=CameraPreset.GOPRO_H4B_WIDE43_MEASURED)
    analyser = trender.Tracker if mode == "tracked" else trender.PairTracker

    def seconds():
        t0 = time.perf_counter()
        bench_run.analyse_frames(analyser(meta, opts, dev), lumas)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def k2_seconds():
        with k2_only_levels():
            return seconds()

    seconds(), k2_seconds()
    best = [min(ts) for ts in zip(*[(seconds(), k2_seconds()) for _ in range(CLIP_FPS_ROUNDS)])]
    return tuple(len(lumas) / t for t in best)


def phase_quality_clip(dev, label):
    """The tracked and paired analyses of the quality tool's 150-frame clip
    at 640x480 through ``trender.analyse``, each under the 0.1 deg guard,
    K2 and the plain level both launched (the launch counts at 0 just
    before, read just after); then, outside the counts, the same analyses
    with K2 alone (``k2_only_levels``) for their RMS, and the analyse fps
    of both loops on the clip's first lumas resident on the card."""
    tmp = tempfile.mkdtemp(prefix="vat_torch_clip_")
    t0 = time.perf_counter()
    zero_launches()
    rms = {mode: clip_rms_deg(dev, mode, tmp) for mode in ("tracked", "paired")}
    torch.cuda.synchronize()
    launches = check_launched("quality clip", ("stage", "lk_level", "lk_level_frame",
                                               lk_kernel.PLAIN_LEVEL.name))
    with k2_only_levels():
        rms_k2 = {mode: clip_rms_deg(dev, mode, tmp) for mode in ("tracked", "paired")}
    source = SyntheticSource.from_uri(QUALITY_CLIP, device=dev)
    lumas = [torch.from_numpy(y).to(dev) for y, _, _ in itertools.islice(source, CLIP_FPS_FRAMES)]
    fps = {mode: clip_analyse_fps(dev, mode, lumas) for mode in ("tracked", "paired")}
    shutil.rmtree(tmp)
    for mode in ("tracked", "paired"):
        log(f"[quality clip] {label}: {mode} analyse of 640x480 x 150 frames: trajectory RMS "
            f"{rms[mode]:.4f} deg (K2 alone, the levels it cannot stage kept at the coarse "
            f"guess: {rms_k2[mode]:.4f}); analyse of the first {CLIP_FPS_FRAMES} frames, "
            f"resident: {fps[mode][0]:.2f} fps (K2 alone: {fps[mode][1]:.2f}, ratio "
            f"{fps[mode][0] / fps[mode][1]:.3f})")
    log(f"[quality clip] {time.perf_counter() - t0:.1f} s")
    for mode, value in rms.items():
        check(value < MAX_RMS_DEG, f"[quality clip] {mode}: trajectory RMS {value} deg")
    return launches


def tool_child(name: str, argv: list, env=None) -> float:
    """``python -m video_annotator_tpu_torch.tools.<name> argv`` in a child
    process from the checkout; its seconds. A non-zero exit fails the run."""
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", f"video_annotator_tpu_torch.tools.{name}",
                           *argv], capture_output=True, text=True, timeout=900,
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          env=dict(os.environ, **(env or {})))
    seconds = time.perf_counter() - t0
    check(done.returncode == 0, f"[{name}] exited {done.returncode}: {done.stderr[-3000:]}")
    return seconds


def phase_run_tool(dev, label, native_ok):
    """``tools/run.py`` over its eight configs, each in a child process at
    its own geometry (4K at full width), trials cut to 2 with no sleep,
    frames cut through ``RUN_ENV``; the e2e config over the encoded MP4
    where the native libraries built, else over the y4m. Each config's
    JSON on a line of its own, every one without an error, each of its
    kernels launched (the children's own counts, summed into the
    ``kernels`` line)."""
    path = os.path.join(tempfile.mkdtemp(prefix="vat_torch_run_"), "run.json")
    source = "mp4" if native_ok else "y4m"
    seconds = tool_child("run", [*RUN_ARGS, "--source", source, "--out", path], RUN_ENV)
    with open(path) as f:
        rows = json.load(f)
    shutil.rmtree(os.path.dirname(path))
    launches = {}
    for row in rows:
        log(f"[run] {json.dumps(row)}")
    check([r["config"] for r in rows] == list(bench_run.CONFIGS), "[run] configs are missing")
    for row in rows:
        check("error" not in row and row["value"] > 0, f"[run] {row['config']} failed")
        for kname in RUN_KERNELS.get(row["config"], ()):
            check(row["launches"].get(kname, 0) > 0,
                  f"[run] {row['config']} did not launch {kname}")
        for kname, count in row["launches"].items():
            launches[kname] = launches.get(kname, 0) + count
    log(f"[run] {label}: eight configs ({source} source, {RUN_ENV}) in {seconds:.1f} s; "
        f"launches {launches}")
    return launches


def phase_soak(dev, label, native_ok):
    """``tools/soak.py`` at 1920x1440 x 180 frames on the card (its render
    children's launches are their own, not counted here): the source mp4
    where the native libraries built, else y4m; segment fps, decay and
    RSS on a line of their own."""
    path = os.path.join(tempfile.mkdtemp(prefix="vat_torch_soak_"), "soak.json")
    source = "mp4" if native_ok else "y4m"
    seconds = tool_child("soak", [*SOAK_ARGS, "--source", source, "--out", path])
    with open(path) as f:
        r = json.load(f)
    shutil.rmtree(os.path.dirname(path))
    log(f"[soak] {json.dumps(r)}")
    log(f"[soak] {label}: {r['frames']} frames of {r['width']}x{r['height']} ({source}) in "
        f"{seconds:.1f} s: segments {r['segment_fps']} fps, decay-free {r['decay_free']}, "
        f"peak RSS {r['peak_rss_mb']} MB, plateau {r['steady_rss_mb']} MB")
    check(r["decay_free"] and r["rss_ok"] and min(r["segment_fps"]) > 0, "[soak] failed")
    return {}


def phase_host_feed(label, native_ok, why):
    """``tools/host_feed.py`` where the native libraries built (it decodes
    through them; no kernel); otherwise a line saying it did not run."""
    if not native_ok:
        log(f"[host_feed] did not run: the native libraries are {why}")
        return {}
    path = os.path.join(tempfile.mkdtemp(prefix="vat_torch_feed_"), "host_feed.json")
    seconds = tool_child("host_feed", ["--out", path])
    with open(path) as f:
        rows = json.load(f)
    shutil.rmtree(os.path.dirname(path))
    for row in rows:
        log(f"[host_feed] {json.dumps(row)}")
    log(f"[host_feed] {label}: {seconds:.1f} s")
    check(len(rows) == 4 and all(r.get("value", 1) > 0 for r in rows), "[host_feed] failed")
    return {}


def phase_bracket(dev, label):
    """``tools/bracket.py --pairs 2`` in this process, the launch counts at
    0 just before and read just after: row 6's slope and the multistream
    fps, alternated."""
    path = os.path.join(tempfile.mkdtemp(prefix="vat_torch_bracket_"), "bracket.json")
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        rc = bracket.main(["--pairs", str(BRACKET_PAIRS), "--out", path])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = check_launched("bracket", ("warp_frames_f32", "warp_luma", "warp_chroma"))
    check(rc == 0, f"[bracket] returned {rc}")
    with open(path) as f:
        r = json.load(f)
    shutil.rmtree(os.path.dirname(path))
    log(f"[bracket] {json.dumps(r)}")
    log(f"[bracket] {label}: {len(r['pairs'])} pairs in {seconds:.1f} s; best multistream "
        f"{r['best_multistream_fps']} fps")
    check(len(r["pairs"]) == BRACKET_PAIRS and r["best_multistream_fps"] > 0,
          "[bracket] failed")
    return launches


# --- rows 6 and 9: K1's float frame batch and band ------------------------


def parallel_warper(dev, projection: str = "rect"):
    """A FrameWarper of the stock 4K cameras, with another output projection
    of the stock canvas where ``projection`` is not ``rect``."""
    meta = trender.VideoMeta(W, H, 30, FRAMES)
    return trender.FrameWarper(*trender.build_cameras(
        meta, stock_options(projection=projection)), 8.0, False, "bilinear", dev)


def float_lumas(dev, n: int) -> torch.Tensor:
    """The first ``n`` luma planes of the stock clip as float32 (the
    parallel layer's streams)."""
    return source_lumas(dev, n).to(torch.float32).contiguous()


def frames_bound(interp, projection, src, out, rot, in_cam) -> dict:
    """The least time of a launch over (T, H, W) float planes into (T, h, w)
    or a band's (h, w) rows: the modes launch's count with each frame one
    plane."""
    return mode_bound(interp, projection != "rect", False, src.reshape(-1, 1, *src.shape[-2:]),
                      out.reshape(-1, 1, *out.shape[-2:]), rot, in_cam, [], None)


def source_rows_reached(coords, h: int, w: int, interp: str) -> int:
    """Rows of an (h, w) source that taps at ``coords`` (..., 2), (x, y)
    order, read: the rows of every in-image tap (two per pixel bilinear,
    four with 4 taps) of a pixel whose taps reach a column of the image."""
    taps = (0, 1) if interp == "bilinear" else (-1, 0, 1, 2)
    x0 = torch.floor(coords[..., 0])
    y0 = torch.floor(coords[..., 1])
    cols = (x0 + taps[-1] >= 0) & (x0 + taps[0] < w)
    reached = torch.zeros(h, dtype=torch.bool, device=coords.device)
    for j in taps:
        y = y0 + j
        hit = cols & (y >= 0) & (y < h)
        reached[y[hit].to(torch.int64)] = True
    return int(reached.sum())


def band_bound(interp, projection, frame, band, rot, oc, ic, size, n, off) -> dict:
    """The least time of one band launch: :func:`frames_bound` with the
    source read only in the rows that the band's map reaches (its plain
    version's coordinates), each once."""
    coords = warp_kernel.band_coords(rot, oc, ic, size, n, off)
    rows = source_rows_reached(coords, *frame.shape, interp)
    return dict(frames_bound(interp, projection, frame[:rows], band, rot, ic), src_rows=rows)


def launched_alone(name: str, fn):
    """``fn()``, synchronised, checked to launch kernel object ``name``
    once and no other."""
    before = {n: k.launches for n, k in cuda_lib.KERNELS.items()}
    got = fn()
    torch.cuda.synchronize()
    moved = {n for n, k in cuda_lib.KERNELS.items() if k.launches != before.get(n, 0)}
    check(moved == {name} and cuda_lib.KERNELS[name].launches == before.get(name, 0) + 1,
          f"{name}: launched {moved}")
    return got


def phase_warp_parallel(dev, results):
    """K1's float frame batch (row 6) at B = STREAMS 4K frames and its band
    (row 9) for 2, 3 and 4 ranks at the stock shapes, in each variant the
    parallel phase launches (PARALLEL_VARIANTS): every launch held to its
    plain version (0 differing values expected), counted under its own
    object alone; the bands, concatenated and cropped, against the
    one-frame float launch (row 5) bit for bit; kernel and plain timed,
    the bands' kernels queued behind a sleep (a band's launch is shorter
    than its wrapper's host time), their bound from the source rows they
    reach."""
    ys = float_lumas(dev, STREAMS)
    g = torch.Generator().manual_seed(37)
    rots = so3.exp(torch.randn((STREAMS, 3), generator=g) * 0.02).to(dev)
    for interp, projection in PARALLEL_VARIANTS:
        warper = parallel_warper(dev, projection)
        oc, ic, size = warper.out_cam, warper.in_cam, (warper.out_h, warper.out_w)
        suffix = warp_kernel.variant(oc, interp, None)

        name = "warp_frames_f32" + suffix
        got = launched_alone(name, lambda: warp_kernel.warp_frames_f32(
            ys, rots, oc, ic, size, interp=interp))
        want = warp_kernel.warp_frames_f32_plain(ys, rots, oc, ic, size, interp=interp)
        diff = (got - want).abs()
        max_err, differ = float(diff.max()), int((diff > 0).sum())
        ms = cuda_ms(lambda: warp_kernel.warp_frames_f32(ys, rots, oc, ic, size, interp=interp),
                     10)
        plain_ms = cuda_ms(lambda: warp_kernel.warp_frames_f32_plain(
            ys, rots, oc, ic, size, interp=interp), 2, 0)
        b = frames_bound(interp, projection, ys, got, rots, ic)
        log(f"[K1 {name}] {projection} output, {tuple(ys.shape)} f32 -> {tuple(got.shape)}: "
            f"max |diff| {max_err:.3g}, {differ} of {got.numel()} values differ; kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms per {STREAMS}-frame launch; bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
        check(got.shape == want.shape and differ == 0, f"{name} disagrees with plain")
        results[name] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, **b)

        name = "warp_band_f32" + suffix
        size_in = tuple(ys.shape[-2:])
        whole = warp_kernel.warp_frame_f32(ys[0], rots[0], oc, ic, size, interp=interp)
        one = "warp_frame_f32" + suffix
        if one not in results:  # row 5 in a variant no earlier phase measured
            want = warp_kernel.warp_planes_f32_plain(ys[:1], rots[0], oc, ic, size,
                                                     interp=interp)[0]
            check(torch.equal(whole, want), f"{one} disagrees with plain")
            results[one] = dict(
                max_abs_err=0.0,
                ms=cuda_ms(lambda: warp_kernel.warp_frame_f32(ys[0], rots[0], oc, ic, size,
                                                              interp=interp), 10),
                plain_ms=cuda_ms(lambda: warp_kernel.warp_planes_f32_plain(
                    ys[:1], rots[0], oc, ic, size, interp=interp), 2, 0),
                **frames_bound(interp, projection, ys[:1], whole, rots[0], ic))
            log(f"[K1 {one}] {projection} output, {tuple(ys[0].shape)} f32 -> "
                f"{tuple(whole.shape)}: equal to its plain version; kernel "
                f"{results[one]['ms']:.3f} ms, plain {results[one]['plain_ms']:.3f} ms; bound "
                f"{results[one]['bound_ms']:.4f} ms ({results[one]['bound_by']})")
        band_err, timed = 0.0, {}
        for n in BAND_SHARDS:
            rows = warp_kernel.band_tile_rows(size[0], n)
            bands = []
            for rank in range(n):
                args = (ys[0], rots[0], oc, ic, size, n, rank * rows)
                got = launched_alone(name, lambda: warp_kernel.warp_frame_band_f32(
                    *args, interp=interp))
                want = warp_kernel.warp_frame_band_f32_plain(*args, interp=interp)
                diff = (got - want).abs()
                band_err = max(band_err, float(diff.max()))
                check(got.shape == want.shape and int((diff > 0).sum()) == 0,
                      f"{name} ({n} ranks, rank {rank}) disagrees with plain")
                bands.append(got)
            check(torch.equal(torch.cat(bands)[:size[0]], whole),
                  f"{name}: the {n} bands are not the whole frame")
            last = (ys[0], rots[0], oc, ic, size, n, (n - 1) * rows)
            timed[n] = (queued_ms(lambda: warp_kernel.warp_frame_band_f32(
                *last, interp=interp), 10), cuda_ms(
                lambda: warp_kernel.warp_frame_band_f32(*last, interp=interp), 10),
                cuda_ms(lambda: warp_kernel.warp_frame_band_f32_plain(*last, interp=interp), 2, 0),
                band_bound(interp, projection, ys[0], bands[-1], *last[1:]))
            ms, events_ms, plain_ms, b = timed[n]
            log(f"[K1 {name}] {projection} output, {n} ranks of {rows} tile rows: every band "
                f"equal to its plain version and the {n} together to the whole-frame launch; "
                f"the last band {tuple(bands[-1].shape)}, {b['src_rows']} of {size_in[0]} "
                f"source rows reached: kernel {ms:.4f} ms (queued; {events_ms:.4f} ms by "
                f"CUDA events with the host's time), plain {plain_ms:.3f} ms; bound "
                f"{b['bound_ms']:.4f} ms ({b['bound_by']}), {b['bound_ms'] / ms:.0%} of it")
        ms, _, plain_ms, b = timed[BAND_SHARDS[0]]
        results[name] = dict(max_abs_err=band_err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b["bound_ms"], bound_by=b["bound_by"])


def check_probe(name: str, got: torch.Tensor, want: torch.Tensor, tiles: int) -> float:
    """A probe against its plain version, bit for bit. Returns the largest
    |diff|."""
    diff = (got - want).abs()
    differ = int((diff > 0).sum())
    log(f"[roofline {name}] {tiles} tile(s), outer {ROOF_CHECK_OUTER}: max |diff| "
        f"{float(diff.max()):.3g}, {differ} of {got.numel()} values differ")
    check(got.shape == want.shape and differ == 0 and torch.equal(got, want),
          f"{name} disagrees with plain")
    return float(diff.max())


def phase_roofline(dev, results, label):
    """The measurement path (rows 11 and 12, K1's diagnostic builds). Rows
    11 and 12: every object against its plain version at outer 4 on the
    inputs ``tools/roofline.py`` gives it (one tile and 528), launched
    alone, bit for bit. K1's three diagnostic builds against their plain
    twins on the 4K batches that it launches them on (4 and 16 frames),
    0 differing values, each timed at 16. Then, with every launch count
    at 0 just before and read just after, ``tools/roofline.py``'s
    measurements at outer 100 000 and 4K (``roofline.run``) and
    ``benchtool.main`` at 1920x1440: the rates, K1's floor and its
    decomposition. Returns the launch counts. A probe's ``ms`` and bound
    are those of its 528-tile launch at outer 100 000; its ``plain_ms``
    is at outer 4 on 528 tiles, labelled so in the ``kernels`` line beside
    the kernel's own time there."""
    t0 = time.perf_counter()
    err, at_plain = {}, {}
    for n, x in roofline.fma_cases(dev).items():
        for (u, fused), k in roofline_kernel.FMA_CHAIN.items():
            def entry():
                return roofline_kernel.fma_chain(x, u, ROOF_CHECK_OUTER, fused)

            def plain():
                return roofline_kernel.fma_chain_plain(x, u, ROOF_CHECK_OUTER, fused)

            got, want = launched_alone(k.name, entry), plain()
            err[k.name] = max(err.get(k.name, 0.0), check_probe(k.name, got, want, n))
            if fused:  # the bit-for-bit check tells the fused chain from the unfused
                other = roofline_kernel.fma_chain_plain(x, u, ROOF_CHECK_OUTER, False)
                apart = int((other != want).sum())
                log(f"[roofline {k.name}] the unfused plain chain differs from it in {apart} "
                    f"of {want.numel()} values")
                check(apart > 0, f"{k.name}: the check cannot tell fused from unfused")
            if n == roofline.CARD_TILES:
                at_plain[k.name] = (cuda_ms(entry, 20), cuda_ms(plain, 2, 0))
    for n, (seg, idx) in roofline.gather_cases(dev).items():
        for u, k in roofline_kernel.GATHER_VISIT.items():
            def entry():
                return roofline_kernel.gather_visits(seg, idx, u, ROOF_CHECK_OUTER)

            def plain():
                return roofline_kernel.gather_visits_plain(seg, idx, u, ROOF_CHECK_OUTER)

            got = launched_alone(k.name, entry)
            err[k.name] = max(err.get(k.name, 0.0), check_probe(k.name, got, plain(), n))
            if n == roofline.CARD_TILES:
                at_plain[k.name] = (cuda_ms(entry, 20), cuda_ms(plain, 2, 0))

    ys, rots, oc, ic, size = roofline.k1_inputs(dev, max(roofline.BATCHES))
    for diag, k in warp_kernel.LUMA_DIAG_KERNELS.items():
        for frames in roofline.BATCHES:
            def entry():
                return warp_kernel.warp_luma_batch_diag(ys[:frames], rots[:frames], oc, ic,
                                                        size, diag)

            def plain():
                return warp_kernel.warp_luma_batch_diag_plain(ys[:frames], rots[:frames], oc,
                                                              ic, size, diag)

            got = launched_alone(k.name, entry)
            diff = (got.to(torch.int16) - plain().to(torch.int16)).abs()
            differ = int((diff > 0).sum())
            log(f"[K1 {k.name}] {tuple(ys[:frames].shape)} -> {tuple(got.shape)}: {differ} of "
                f"{got.numel()} values differ from its plain twin")
            check(differ == 0, f"{k.name} disagrees with its plain twin")
        ms, p_ms = cuda_ms(entry, 20), cuda_ms(plain, 3, 1)
        pixels = frames * size[0] * size[1]
        no_map = bool(diag & warp_kernel.DIAG_NO_MAP)
        b = bound((0 if diag & warp_kernel.DIAG_NO_TAPS else ys.numel()) + rots.numel() * 4
                  + got.numel(), pixels * ((roofline.NO_MAP_OPS if no_map else warp_map_ops(ic))
                                           + WARP_TAP_OPS))
        log(f"[K1 {k.name}] kernel {ms:.3f} ms, plain {p_ms:.3f} ms per {frames}-frame "
            f"launch; bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        results[k.name] = dict(max_abs_err=float(diff.max()), ms=ms, plain_ms=p_ms, **b)
    log(f"[roofline] the checks against plain and their timing: "
        f"{time.perf_counter() - t0:.1f} s")

    zero_launches()
    t0 = time.perf_counter()
    roof = roofline.run(dev)
    roof_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bench_rc = benchtool.main(BENCHTOOL_ARGS)
    torch.cuda.synchronize()
    bench_s = time.perf_counter() - t0
    launches = launch_counts()
    log(f"[roofline] launches {launches}")
    check(bench_rc == 0, f"benchtool {' '.join(BENCHTOOL_ARGS)} returned {bench_rc}")
    probes = ([k.name for k in roofline_kernel.FMA_CHAIN.values()]
              + [k.name for k in roofline_kernel.GATHER_VISIT.values()]
              + [k.name for k in warp_kernel.LUMA_DIAG_KERNELS.values()]
              + ["warp_luma", "warp_frame_f32", "stage", "lk_level_frame"])
    for name in probes:
        check(launches.get(name, 0) > 0, f"[roofline] kernel {name} was not launched")
    log(f"[roofline] {label}: tools/roofline.py {roof_s:.1f} s, benchtool {bench_s:.1f} s")
    for line in roofline.summary(roof):
        log(f"[roofline] {line}")

    tile_bytes = roofline.TILE * 4
    for call in roof["fma"]["calls"] + roof["gather"]["calls"]:
        if call["tiles"] != roofline.CARD_TILES:
            continue
        name, n = call["object"], call["tiles"]
        fma = name.startswith("fma")
        u = int(name.rsplit("_u", 1)[1])
        elems = n * roofline.TILE * roofline.OUTER * u
        b = (bound(2 * n * tile_bytes, elems * roofline.FMA_STEP_OPS) if fma
             else bound(3 * n * tile_bytes, elems * roofline.GATHER_VISIT_OPS))
        short_ms, plain_ms = at_plain[name]
        log(f"[roofline {name}] {n} tiles, outer {roofline.OUTER}: kernel {call['ms']:.3f} ms, "
            f"bound {b['bound_ms']:.3f} ms ({b['bound_by']}), {b['bound_ms'] / call['ms']:.1%} "
            f"of it; at outer {ROOF_CHECK_OUTER} on {n} tiles: kernel {short_ms:.4f} ms, "
            f"plain {plain_ms:.3f} ms")
        results[name] = dict(max_abs_err=err[name], ms=call["ms"], plain_ms=plain_ms,
                             plain_outer=ROOF_CHECK_OUTER, plain_tiles=n,
                             ms_at_plain_outer=short_ms, **b)
    return launches


def render_clip(dev, w: int, h: int, streams: int, frames: int):
    """((B, T, H, W) float32 luma, in_cam, out_cam): one shaken synthetic
    stream per b (the dryrun's clips), rendered on the card."""
    cams = [SyntheticCamera(width=w, height=h, num_frames=frames, shake=0.006, seed=17 * b + 1)
            for b in range(streams)]
    in_cam = cams[0].camera()
    clip = torch.stack([
        torch.stack([render_frame(in_cam, r)[0] for r in torch.from_numpy(
            cam.rotations().astype(np.float32)).to(dev)]) for cam in cams])
    return clip.to(torch.float32), in_cam, get_output_camera(in_cam, crop_borders=True)


def timed_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_parallel(dev, label):
    """The three phases of ``dryrun_multichip`` through the port's
    ``parallel/`` package, at world size 1 on the card (an NCCL group
    over a HashStore), with every launch count at 0 just before and read
    just after: the pipeline step on a (2, 60) x 1280x960 clip at radius
    30 (non-identity corrections); the stream batch at STREAMS 4K frames in
    each of PARALLEL_VARIANTS; the two 2D families' batch warps at
    STREAMS 4K frames; the spatial warp (one rank) and its bands for 2, 3
    and 4 ranks launched in turn. Then, outside the count, each result is
    held to its unsharded counterpart, and the step's kernels at its own
    shapes to their plain versions. Returns the launch counts."""
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = pmesh.make_mesh()
        clip, in_cam, out_cam = render_clip(dev, 1280, 960, 2, 60)
        ys = float_lumas(dev, STREAMS)
        g = torch.Generator().manual_seed(41)
        rots = so3.exp(torch.randn((STREAMS, 3), generator=g) * 0.02).to(dev)
        y8, u8, v8 = (torch.stack(p) for p in zip(*(
            source_frame(dev, SOURCE, t) for t in range(STREAMS))))
        sim = torch.tensor([[4.0, -3.0, 0.02, 0.01]] * STREAMS, device=dev) * \
            torch.linspace(-1.0, 1.0, STREAMS, device=dev)[:, None]
        mats = torch.from_numpy(similarity.SimilarityWarper.matrices(sim.cpu().numpy())).to(dev)
        shifts = torch.linspace(-12.5, 12.5, STREAMS * 2, device=dev).reshape(STREAMS, 2)
        sim_warper = similarity.SimilarityWarper(W, H)
        zero_launches()
        step = ppipeline.build_pipeline_step(mesh, in_cam, out_cam, smooth_radius=30,
                                             max_corners=PIPE_CORNERS)
        (warped, corrections), pipe_ms = timed_ms(lambda: step(clip, with_corrections=True))
        streams_out = {}
        for interp, projection in PARALLEL_VARIANTS:
            warper = parallel_warper(dev, projection)
            streams_out[interp, projection] = timed_ms(
                lambda: pstreams.warp_streams_kernel_sharded(
                    ys, rots, warper.out_cam, warper.in_cam, (warper.out_h, warper.out_w),
                    interp=interp))
        # The 2D families' batch warps on this rank's streams (no collectives).
        families = {
            "similarity": timed_ms(lambda: tuple(map(torch.stack, zip(
                *sim_warper.warp_yuv_batch(y8, u8, v8, mats))))),
            "deshake": timed_ms(lambda: tuple(map(torch.stack, zip(*map(
                deshake.warp_frame_deshake, *(p.to(torch.float32) for p in (y8, u8, v8)),
                shifts))))),
        }
        spatial = {}
        for interp, projection in PARALLEL_VARIANTS:
            warper = parallel_warper(dev, projection)
            oc, ic, size = warper.out_cam, warper.in_cam, (warper.out_h, warper.out_w)
            spatial[interp, projection, 1] = timed_ms(lambda: pstreams.warp_frame_spatial(
                ys[0], rots[0], oc, ic, mesh, out_size=size, interp=interp))
            for n in BAND_SHARDS:
                rows = warp_kernel.band_tile_rows(size[0], n)
                spatial[interp, projection, n] = timed_ms(lambda: torch.cat([
                    warp_kernel.warp_frame_band_f32(ys[0], rots[0], oc, ic, size, n, r * rows,
                                                    interp=interp)
                    for r in range(n)])[:size[0]])
        torch.cuda.synchronize()
        launches = launch_counts()
    finally:
        dist.destroy_process_group()
    log(f"[parallel] launches {launches}")
    for name in PARALLEL_KERNELS:
        check(launches.get(name, 0) > 0, f"[parallel] kernel {name} was not launched")

    check(warped.shape == (*clip.shape[:2], out_cam.height, out_cam.width)
          and bool(torch.isfinite(warped).all()), "[parallel] pipeline output is off")
    ident = warp_kernel.warp_frame_f32(clip[0, 30], torch.eye(3, device=dev), out_cam, in_cam,
                                       (out_cam.height, out_cam.width))
    moved = float((warped[0, 30] - ident).abs().mean())
    log(f"[parallel] {label}: pipeline step {tuple(clip.shape)} radius 30 -> "
        f"{tuple(warped.shape)} in {pipe_ms:.1f} ms wall "
        f"({pipe_ms / clip.shape[0] / clip.shape[1]:.2f} ms per frame); "
        f"mean |warp - undistort| {moved:.2f} grey")
    check(moved > 0.5, "[parallel] the corrections are the identity")
    check_pipeline_kernels(clip, corrections, warped, in_cam, out_cam)
    for (interp, projection), (out, ms) in streams_out.items():
        warper = parallel_warper(dev, projection)
        size = (warper.out_h, warper.out_w)
        same = all(torch.equal(out[b], warp_kernel.warp_frame_f32(
            ys[b], rots[b], warper.out_cam, warper.in_cam, size, interp=interp))
            for b in range(STREAMS))
        log(f"[parallel] stream batch {interp} {projection}: {STREAMS} x 4K -> "
            f"{tuple(out.shape)} in {ms:.2f} ms wall; each stream equal to its one-frame "
            f"launch: {same}")
        check(same, f"[parallel] the {interp} {projection} stream batch differs per stream")
    for name, ((wy, wu, wv), ms) in families.items():
        for b in (0, STREAMS - 1):
            if name == "similarity":
                want = sim_warper.warp_yuv(y8[b], u8[b], v8[b], mats[b])
            else:
                want = deshake.warp_frame_deshake(y8[b].float(), u8[b].float(), v8[b].float(),
                                                  shifts[b])
            check(all(torch.equal(g_[b], w_) for g_, w_ in zip((wy, wu, wv), want)),
                  f"[parallel] {name} stream {b} differs from its unsharded warp")
        log(f"[parallel] {name} streams: {STREAMS} x 4K -> {tuple(wy.shape)} in {ms:.2f} ms "
            f"wall; streams 0 and {STREAMS - 1} equal to their unsharded warps")
    for (interp, projection, n), (out, ms) in spatial.items():
        warper = parallel_warper(dev, projection)
        whole = warp_kernel.warp_frame_f32(ys[0], rots[0], warper.out_cam, warper.in_cam,
                                           (warper.out_h, warper.out_w), interp=interp)
        check(torch.equal(out, whole), f"[parallel] spatial {interp} {projection} {n} ranks")
        log(f"[parallel] spatial {interp} {projection}, {n} rank(s): {tuple(out.shape)} in "
            f"{ms:.2f} ms wall, equal to the whole-frame launch")
    return launches


def check_pipeline_kernels(clip, corrections, warped, in_cam, out_cam):
    """The pipeline step's kernels at its own shapes, each against its
    plain version: row 6 on the (B T, 960, 1280) clip by the corrections
    the step warped with (0 differing values expected); K3 and K2's pairs
    form on stream 0's sequence as the step tracks it (frame 0 first
    against itself), with the step's corners, levels and iterations."""
    size = (out_cam.height, out_cam.width)
    flat = clip.reshape(-1, *clip.shape[-2:])
    want = warp_kernel.warp_frames_f32_plain(flat, corrections.reshape(-1, 3, 3), out_cam,
                                             in_cam, size)
    diff = (warped.reshape(want.shape) - want).abs()
    differ = int((diff > 0).sum())
    log(f"[parallel] row 6 at the step's shapes, {tuple(flat.shape)} -> {tuple(want.shape)}: "
        f"max |diff| {float(diff.max()):.3g}, {differ} of {want.numel()} values differ from "
        f"the plain warp by the step's corrections")
    check(differ == 0, "[parallel] the step's warp disagrees with plain")

    seq = torch.cat([clip[0, :1], clip[0]])
    staged = lk_kernel.stage_pyramid_pairs(seq, ppipeline.LK_LEVELS)
    for level, stack in zip(build_pyramid(seq, ppipeline.LK_LEVELS), staged):
        if stack is not None:
            check(torch.equal(stack, stage.stage_u8_plain(level, slack=lk_kernel.SLACK_ROWS)),
                  f"[parallel] stage kernel is not bit-exact at {tuple(level.shape)}")
    log(f"[parallel] K3 at the step's shapes: {sum(s is not None for s in staged)} levels of "
        f"{tuple(seq.shape)} bit-exact")
    pts, valid = detect_corners(seq[:-1], max_corners=PIPE_CORNERS,
                                min_distance=ppipeline.MIN_DISTANCE, border=ppipeline.BORDER)
    p_, n_ = pts.shape[:2]
    band = torch.arange(p_, device=seq.device).repeat_interleave(n_)
    compare_lk_levels(
        "parallel K2 lk_level", [None if s is None else (s, s, band) for s in staged],
        pts.reshape(-1, 2), valid.reshape(-1),
        lambda s, _, pf, pi: lk_kernel.lk_level(s, pf, pi, ppipeline.LK_ITERS),
        lambda s, _, pf, pi: lk_kernel.lk_level_plain(s, s, pf, pi, ppipeline.LK_ITERS),
        iters=ppipeline.LK_ITERS)


def phase_native_build():
    """Whether ``make -C native`` built the libav reader and writer here
    (the binding builds them at first use); the make's last line if not."""
    from video_annotator_tpu_torch.io import native

    t0 = time.perf_counter()
    ok = native.native_available() and native.native_writer_available()
    status = native.build_status
    how = ("built by make -C native" if status else "found built") if ok else \
        f"not built: make -C native failed: {status[1] if status else 'not attempted'}"
    log(f"[native] libav reader and writer {how} ({time.perf_counter() - t0:.1f} s)")
    return ok, how


def phase_native_render(tmp, run, native_ok, why):
    """Where the native libraries built: the stock render of NATIVE_FRAMES
    4K frames to .mp4 (libx264 at QP 19, the default encoder), decoded
    back through the port's NativeVideoSource; frame count and size."""
    if not native_ok:
        log(f"[native] the .mp4 render did not run: the native libraries are {why}")
        return
    from video_annotator_tpu_torch.io.native import NativeVideoSource

    dest = os.path.join(tmp, "native.mp4")
    src = mode_source(NATIVE_FRAMES)
    _, _, times = run("native-mp4", dest, ["--stabilise", "smooth", "--preset", PRESET],
                      ("warp_luma", "warp_chroma"), source=src, frames=NATIVE_FRAMES)
    reader = NativeVideoSource(dest)
    frames = [y.shape for y, _, _ in reader]
    reader.close()
    warper = stock_cameras()
    log(f"[native] {dest}: {len(frames)} frames of {frames[0] if frames else None} decoded "
        f"back; encode {NATIVE_FRAMES / times['encode']:.2f} fps ({times['encode']:.2f} s)")
    check(len(frames) == NATIVE_FRAMES and set(frames) == {(warper.out_h, warper.out_w)},
          "[native] the .mp4 does not decode to the rendered frames")
    os.remove(dest)


def sequential_integrate(omega, sample_ts, frame_ts) -> torch.Tensor:
    """``integrate_gyro`` as a sequential scan in float64 on the host, over
    the same float32 samples: R_{k+1} = R_k exp(w_k dt_k) one step after
    another, then the same resample and rebase."""
    omega, sample_ts, frame_ts = (x.double() for x in (omega, sample_ts, frame_ts))
    steps = so3.exp(omega[:-1] * torch.diff(sample_ts)[:, None]).numpy()
    rs = np.empty((len(sample_ts), 3, 3))
    rs[0] = np.eye(3)
    for k, step in enumerate(steps):
        rs[k + 1] = rs[k] @ step
    rs = torch.from_numpy(rs)
    idx = torch.clamp(torch.searchsorted(sample_ts, frame_ts, right=True) - 1,
                      0, len(sample_ts) - 2)
    t0, t1 = sample_ts[idx], sample_ts[idx + 1]
    alpha = torch.clamp((frame_ts - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)
    r_frames = so3.slerp(rs[idx], rs[idx + 1], alpha)
    return so3.matmul(so3.transpose(r_frames[0])[None], r_frames)


def trace_steps(tracker, frames, wall_ms):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for y in frames:
            tracker.push(y)
        torch.cuda.synchronize()
    n = len(frames)
    launches = sum(e.count for e in prof.key_averages() if "LaunchKernel" in e.key)
    log(f"[tracked profile] traced: {launches / n:.1f} kernel launches per step")
    events = device_events(prof)
    report_device_time("tracked profile", events, n, "step", wall_ms)
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
    native_ok, native_why = phase_native_build()
    results = {}
    phase_warp(dev, results)
    phase_warp_float(dev, results)
    phase_warp_one_frame(dev, results)
    phase_warp_rs(dev, results)
    phase_warp_modes(dev, results)
    phase_stage_lk(dev, results)
    phase_pyramid(dev, results)
    phase_wahba(dev, results)
    phase_lk_frame(dev, results)
    phase_warp_parallel(dev, results)
    roof_launches = phase_roofline(dev, results, label)
    log(f"[kernels] times above measured on {label}")
    launches = phase_renders(dev, label, native_ok, native_why)
    for name, count in [*phase_parallel(dev, label).items(), *roof_launches.items()]:
        launches[name] = launches.get(name, 0) + count
    phase_tracked_profile(dev, label)
    phase_kalman_window(dev, label)
    phase_2d_parts(dev, label)
    phase_telemetry_parts(dev, label)
    tool_phases = (
        ("calibrate", lambda: phase_calibrate(dev, label)),
        ("quality", lambda: phase_quality(dev, label)),
        ("quality clip", lambda: phase_quality_clip(dev, label)),
        ("fidelity", lambda: phase_fidelity(dev, label)),
        ("run", lambda: phase_run_tool(dev, label, native_ok)),
        ("soak", lambda: phase_soak(dev, label, native_ok)),
        ("host_feed", lambda: phase_host_feed(label, native_ok, native_why)),
        ("bracket", lambda: phase_bracket(dev, label)),
    )
    for phase_name, phase in tool_phases:
        t_phase = time.perf_counter()
        for name, count in phase().items():
            launches[name] = launches.get(name, 0) + count
        log(f"[phase {phase_name}] {time.perf_counter() - t_phase:.1f} s")
    log(f"[plain level] lk_plain_level called {launches.get(lk_kernel.PLAIN_LEVEL.name, 0)} "
        f"times over the phases above (the plain LK level, not a kernel)")
    log(f"[smoke] all phases passed in {time.perf_counter() - t0:.1f} s")
    kernels = []
    for name, k in cuda_lib.KERNELS.items():
        check(name in results, f"kernel {name} was launched but not measured in phase 2")
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches.get(name, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"),
            **{key: r[key] for key in PLAIN_LABELS if key in r},
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
