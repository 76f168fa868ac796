"""Two-phase render: analyse (motion) then encode (warp), on one device.

Port of ``video_annotator_tpu/pipeline/render.py``. The rotation family
(``--filter dewobble``, the default): ``render in out --stabilise smooth``
two-phase (here) or single-pass (``--streaming``,
``pipeline/streaming.py``), with either analyser, Savitzky-Golay or
Kalman smoothing on SO(3) and the bilinear rectilinear warp. The 2D
families (``--filter vidstab``, ``--filter deshake``; ``models/``) share
the two-phase skeleton: their analysers write a ``similarity`` or
``translation`` trajectory and :func:`encode_2d` warps with it.

0. ``--gyro`` (:func:`analyse_gyro`) takes the trajectory from the
   source's GPMF telemetry instead of tracking: parse the GYRO stream
   (``io/gpmf.py``, ``io/mp4.py``), integrate it on SO(3) with a prefix
   product and resample at the frame times (``smoothing/gyro.py``).
1. Analyse (:func:`analyse`), ``--analysis-mode paired``
   (:class:`PairTracker`): per chunk of G frames (plus the previous
   chunk's last), box-downsample the luma to the tracking scale, detect
   Shi-Tomasi corners one level lower, stage the uint8 LK pyramids (K3),
   track every adjacent pair in one LK launch per level (K2, pairs form;
   the plain level on a level too small for K2's window),
   estimate each pair's rotation by RANSAC, carry failed pairs over with a
   last-valid scan and chain the deltas with a prefix product.
   ``--analysis-mode tracked`` (:class:`Tracker`): frame by frame, carry
   the corners and the previous frame's staged pyramid, track with K2's
   per-frame form, fall back to the previous delta below the inlier gate,
   and re-detect corners on key frames.
2. Corrections (:func:`compute_corrections`): SG-smooth the trajectory's
   matrix entries and project back onto SO(3), or Kalman-smooth its
   rotation vectors; ``--horizon-lock`` rolls the smoothed camera level
   against gravity (``smoothing/horizon.py``; up from the telemetry's
   accelerometer, else the first frame taken as level); correction =
   measured . virtual^T . attitude.
3. Encode (:func:`encode`): warp Y, U and V of batches of frames through
   the fused warp (K1) and write them. ``--rolling-shutter`` turns each
   frame's correction into one rotation per 8-row output tile row
   (``smoothing/rolling.py``: scanline poses from the gyro stream, else
   from the trajectory's frame-rate velocity), which K1 takes in its
   per-tile-row mode. ``--interp bicubic|lanczos``, a ``--projection``
   other than rectilinear and ``--prefilter auto`` run K1's 4-tap,
   ray-grid and per-tile mip modes (:class:`FrameWarper`).

Every library entry point takes ``device``. The frames leave through
:func:`open_sink`: ``--crop W:H[:X:Y]`` (an ffmpeg crop-filter
rectangle, :func:`parse_crop_rect`) slices them on the device, then the
writer thread reads them back, draws the ``--debug`` HUD
(``pipeline/debug.py``), writes the ``--preview`` PNGs, shows the
``--display`` window and writes the file.
"""

from __future__ import annotations

import dataclasses
import math
import os
import struct
import sys
from fractions import Fraction
from typing import Optional

import numpy as np
import torch

from video_annotator_tpu_torch import so3
from video_annotator_tpu_torch.camera import (
    Camera,
    CameraModel,
    CameraPreset,
    camera_from_dfov,
    get_output_camera,
    get_preset_camera,
)
from video_annotator_tpu_torch.io.gpmf import extract_accl, extract_gyro, extract_imu
from video_annotator_tpu_torch.io.mp4 import parse_tracks
from video_annotator_tpu_torch.io.prefetch import AsyncFrameWriter, DevicePrefetcher
from video_annotator_tpu_torch.io.video import (
    VideoMeta,
    open_reader,
    open_writer,
    yuv420_to_bgr,
)
from video_annotator_tpu_torch.ops.corners import detect_corners
from video_annotator_tpu_torch.ops.lk import DEF_LEVELS, WIN
from video_annotator_tpu_torch.ops.lk_kernel import LKRoute
from video_annotator_tpu_torch.ops.ransac import (
    NUM_HYPOTHESES,
    estimate_rotation,
    rotation_with_fallback,
    sample_pairs,
)
from video_annotator_tpu_torch.models import FILTER_ALIASES
from video_annotator_tpu_torch.ops import warp_kernel
from video_annotator_tpu_torch.ops.mip import tile_levels
from video_annotator_tpu_torch.ops.warp_plain import (
    INTERPS,
    box_downsample,
    mip_camera,
    num_tile_rows,
    scaled_camera,
)
from video_annotator_tpu_torch.pipeline.profiler import Progress, StageProfiler
from video_annotator_tpu_torch.pipeline.trajectory import (
    KIND_DIMS,
    Trajectory,
    trajectory_path,
)
from video_annotator_tpu_torch.smoothing.gyro import integrate_gyro
from video_annotator_tpu_torch.smoothing.horizon import (
    DEFAULT_UP,
    estimate_up_direction,
    level_horizon,
)
from video_annotator_tpu_torch.smoothing.kalman import smooth_rotations_kalman
from video_annotator_tpu_torch.smoothing.rolling import (
    rs_row_rotations,
    rs_row_rotations_gyro,
    scan_fractions,
)
from video_annotator_tpu_torch.smoothing.savgol import savgol_weights, sg_conv

KEY_FRAME_MAX_AGE = 20
KEY_FRAME_MIN_CORNERS = 150
MAX_CORNERS = 200
MIN_INLIERS_FULL = 40
RANSAC_SEED = 7  # the JAX package's PRNGKey(7)
DEFAULT_WARP_BATCH = 32
# What the telemetry parsers raise for a source without (readable)
# telemetry: no such file or a synthetic URI, no GoPro MET track or no
# such stream in it, a truncated box or KLV. Only these mean "no
# telemetry"; anything else (a device or kernel error) propagates.
NO_TELEMETRY = (OSError, ValueError, struct.error)

PROJECTION_MODELS = {
    "rect": CameraModel.RECTILINEAR,
    "flat": CameraModel.RECTILINEAR,
    "gnomonic": CameraModel.RECTILINEAR,
    "fisheye": CameraModel.FISHEYE,
    "fish": CameraModel.FISHEYE,
    "equirect": CameraModel.EQUIRECT,
    "equirectangular": CameraModel.EQUIRECT,
    "e": CameraModel.EQUIRECT,
    "stereographic": CameraModel.STEREOGRAPHIC,
    "sg": CameraModel.STEREOGRAPHIC,
    "mercator": CameraModel.MERCATOR,
    "ball": CameraModel.BALL,
    "hammer": CameraModel.HAMMER,
    "sinusoidal": CameraModel.SINUSOIDAL,
    "sinusoid": CameraModel.SINUSOIDAL,
    "cylindrical": CameraModel.CYLINDRICAL,
    "pannini": CameraModel.PANNINI,
}


@dataclasses.dataclass
class RenderOptions:
    """The CLI's render options; field for field those of the JAX package."""

    start: Optional[float] = None
    duration: Optional[float] = None
    end: Optional[float] = None
    width: Optional[int] = None
    height: Optional[int] = None
    scale: float = 1.0
    crop_borders: bool = False
    crop_rect: Optional[str] = None
    upsample: float = 0.0  # percent
    roll: float = 0.0
    pitch: float = 0.0
    yaw: float = 0.0
    filter: str = "rotation"
    stabilise: str = "none"  # none | fixed | smooth
    smoother: str = "savgol"  # savgol | kalman
    stabilise_radius: int = 90
    interpolate_radius: int = 30
    stabilise_buffer: float = 20.0  # percent extra canvas while stabilising
    input_dfov: float = 145.8
    output_dfov: Optional[float] = None
    projection: str = "rect"
    preset: Optional[CameraPreset] = None
    gyro: bool = False
    streaming: bool = False
    horizon_lock: bool = False
    rolling_shutter: float = 0.0
    analyse_only: bool = False
    encode_only: bool = False
    no_output: bool = False
    device_sink: bool = False
    encoder: str = "mp4v"
    frame_rate: Optional[float] = None
    warp_batch: Optional[int] = None  # None: 32 frames per warp launch
    prefetch_depth: int = 3
    native_io: bool = True
    analysis_scale: object = "auto"
    analysis_chunk: int = 16
    analysis_mode: str = "auto"  # auto | tracked | paired
    analysis_detect_level: int = 1
    analysis_iters: int = 8
    preview: Optional[str] = None
    preview_every: int = 30
    display: bool = False
    # The angle the --prefilter auto level map probes (with the clip's own
    # largest correction, where it is known); the warp kernel itself has
    # no static per-tile windows to size.
    max_correction_deg: float = 8.0
    prefilter: str = "off"  # off | auto
    interp: str = "bilinear"
    debug: bool = False
    cell_labels: bool = True
    verbose: bool = False


def resolve_analysis_mode(options, device) -> str:
    """``auto`` is ``paired`` on a CUDA device (the sequential tracker is
    launch-bound there) and ``tracked`` on the CPU, as in the JAX
    package; an explicit mode wins."""
    mode = getattr(options, "analysis_mode", "auto")
    if mode not in ("auto", "tracked", "paired"):
        raise ValueError(f"--analysis-mode must be auto, tracked or paired (got {mode})")
    if mode == "auto":
        return "paired" if torch.device(device).type == "cuda" else "tracked"
    return mode


def resolve_analysis_scale(o, meta=None) -> float:
    """``auto``: the largest of {1, 0.5, 0.25} whose tracked frame fits
    h <= 1536 and w <= 2048 (0.5 at 4K); explicit scales win."""
    scale = getattr(o, "analysis_scale", "auto")
    if scale in ("auto", None):
        if meta is None:
            return 1.0
        for s in (1.0, 0.5, 0.25):
            if meta.height * s <= 1536 and meta.width * s <= 2048:
                return s
        return 0.25
    try:
        scale = float(scale)
    except (TypeError, ValueError):
        scale = None
    if scale not in (1.0, 0.5, 0.25):
        raise ValueError(
            f"--analysis-scale must be auto, 1, 0.5 or 0.25 "
            f"(got {getattr(o, 'analysis_scale', None)!r})")
    return scale


def analysis_level(o, meta=None) -> int:
    return {1.0: 0, 0.5: 1, 0.25: 2}[resolve_analysis_scale(o, meta)]


def tracking_gates(track_w: int) -> tuple:
    """(min_distance, min_inliers, min_refresh) for a tracking width."""
    res_scale = max(track_w / 1920.0, 0.15)
    min_distance = max(6, int(round(30 * res_scale)))
    min_inliers = max(10, min(MIN_INLIERS_FULL, int(round(40 * res_scale))))
    min_refresh = max(20, int(round(KEY_FRAME_MIN_CORNERS * res_scale)))
    return min_distance, min_inliers, min_refresh


def tracking_border(track_w: int, track_h: int) -> int:
    """Corner-seeding border: the deepest pyramid level's window margin at
    tracking resolution, capped by the frame size."""
    margin = 2 ** (DEF_LEVELS - 1) * (WIN // 2 + 1)
    return max(8, min(margin, min(track_w, track_h) // 6))


def _frame_range(meta: VideoMeta, o: RenderOptions):
    fps = float(meta.fps)
    first = int(round((o.start or 0.0) * fps))
    last = meta.num_frames if meta.num_frames else 1 << 30
    if o.end is not None:
        last = min(last, int(round(o.end * fps)))
    if o.duration is not None:
        last = min(last, first + int(round(o.duration * fps)))
    return first, last


def open_trimmed(source: str, o, device):
    """(reader, meta, first, last) with the reader seeked to the trim start
    where the source can seek."""
    reader = open_reader(source, device=device, prefer_native=o.native_io)
    meta = reader.meta
    first, last = _frame_range(meta, o)
    if first > 0 and not source.startswith("synthetic://"):
        reader.close()
        reader = open_reader(source, start_frame=first, device=device,
                             prefer_native=o.native_io)
    return reader, meta, first, last


class TrimmedFrames:
    """The (y, u, v) device frames ``[first, last)`` of ``reader``, a trim
    window of :func:`open_trimmed`, decoded and uploaded ahead on a
    :class:`DevicePrefetcher` (stages ``decode``, ``upload`` and
    ``feed-wait`` of ``profiler``), which starts on construction. Frames
    before ``first`` are skipped where the reader could not seek. Leaving
    the ``with`` block stops the prefetcher and closes the reader, at the
    loop's end, on a ``break`` and on an exception."""

    def __init__(self, reader, first: int, last: int, options, device,
                 profiler: StageProfiler):
        self.reader, self.first, self.last = reader, first, last
        self.pre = DevicePrefetcher(profiler.wrap_iter("decode", iter(reader)),
                                    depth=options.prefetch_depth, device=device,
                                    profiler=profiler)

    def __iter__(self):
        idx = self.reader.start_frame - 1
        for planes in self.pre:
            idx += 1
            if idx < self.first:
                continue
            if idx >= self.last:
                return
            yield planes

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.pre.close()
        self.reader.close()


def _passthrough_kwargs(source: str, o: RenderOptions) -> dict:
    """``open_writer``'s stream-copy window and route: a container source
    has its audio and GPMF tracks copied into the output over the trim
    window (source-time seconds), as JAX's ``_passthrough_kwargs``
    (``pipeline/render.py:314-335``) does."""
    if source.startswith("synthetic://") or source.endswith(".y4m"):
        return {"allow_native": o.native_io}
    start = o.start or 0.0
    if o.end is not None:
        end = float(o.end)
    elif o.duration is not None:
        end = start + float(o.duration)
    else:
        end = -1.0
    return {"copy_streams_from": source, "trim_start": start, "trim_end": end,
            "allow_native": o.native_io}


def upsample_factor(upsample) -> float:
    """--upsample as a scale factor (absolute percent: 150 -> 1.5x)."""
    if upsample and upsample < 0:
        raise ValueError(
            f"--upsample is an absolute percent of the input size "
            f"(150 = 1.5x, 50 = 0.5x); got {upsample}")
    return (upsample / 100.0) if upsample else 1.0


def output_fps(options, meta) -> Fraction:
    return (Fraction(options.frame_rate).limit_denominator(1001)
            if options.frame_rate else meta.fps)


# --- the output crop rectangle (--crop W:H[:X:Y]) --------------------------


def eval_ffmpeg_expr(expr: str, env: dict) -> float:
    """Evaluate an ffmpeg filter expression: the ``av_expr`` subset that the
    crop filter documents. Numbers (scientific notation too), names from
    ``env``, ``+ - * / ^``, unary minus, parentheses, and the functions
    ``min max abs floor ceil trunc round mod pow if gt gte lt lte eq``. The
    reference forwards ``--crop`` verbatim into ``crop=${crop}``, where
    ffmpeg evaluates this language, so ``in_w-200`` or ``min(iw,ih)`` work
    here too. A recursive descent parser; no Python ``eval``.

    Syntax errors (unknown names, unbalanced parentheses, trailing text)
    raise ``ValueError``. Arithmetic follows C doubles as ``av_expr`` does:
    division by zero and overflow give +-inf or NaN instead of raising, so
    a caller can tell a bad expression from a bad value at given
    dimensions."""

    def _div(a, b):
        try:
            return a / b
        except ZeroDivisionError:
            return math.nan if a == 0 else math.copysign(math.inf, a) * (
                math.copysign(1.0, b))

    def _pow(a, b):
        try:
            return float(a) ** float(b)
        except OverflowError:
            return math.inf
        except (ValueError, ZeroDivisionError):  # (-x) ** frac, 0 ** -1
            return math.nan

    def _cdouble(f):
        # C's floor/ceil/trunc/round pass +-inf and NaN through; Python's
        # math.floor raises OverflowError on inf.
        def g(d):
            return d if (math.isinf(d) or math.isnan(d)) else float(f(d))
        return g

    def _round(d):
        # av_expr rounds half away from zero (eval.c e_round), not to even:
        # round(2.5) = 3, round(-2.5) = -3.
        return math.floor(d + 0.5) if d >= 0 else math.ceil(d - 0.5)

    def _mod(a, b):
        # av_expr's mod is floored (eval.c e_mod: d - floor(d / d2) * d2),
        # not C's fmod: mod(-5, 3) = 1, the result's sign that of b.
        if not b:
            return math.nan
        try:
            return a - math.floor(a / b) * b
        except (OverflowError, ValueError):
            return math.nan

    funcs = {
        "min": min, "max": max, "abs": abs, "floor": _cdouble(math.floor),
        "ceil": _cdouble(math.ceil), "trunc": _cdouble(math.trunc),
        "round": _cdouble(_round),
        "mod": _mod, "pow": _pow,
        "if": lambda c, a, b=0.0: a if c != 0 else b,
        "gt": lambda a, b: 1.0 if a > b else 0.0,
        "gte": lambda a, b: 1.0 if a >= b else 0.0,
        "lt": lambda a, b: 1.0 if a < b else 0.0,
        "lte": lambda a, b: 1.0 if a <= b else 0.0,
        "eq": lambda a, b: 1.0 if a == b else 0.0,
    }
    s = str(expr)
    pos = [0]

    def peek():
        while pos[0] < len(s) and s[pos[0]].isspace():
            pos[0] += 1
        return s[pos[0]] if pos[0] < len(s) else ""

    def parse_sum():
        v = parse_prod()
        while peek() in ("+", "-"):
            op = s[pos[0]]
            pos[0] += 1
            r = parse_prod()
            v = v + r if op == "+" else v - r
        return v

    def parse_prod():
        v = parse_pow()
        while peek() in ("*", "/"):
            op = s[pos[0]]
            pos[0] += 1
            r = parse_pow()
            v = v * r if op == "*" else _div(v, r)
        return v

    def parse_sign():
        # eval.c's parse_dB takes at most one leading sign; av_strtod takes
        # a second into a numeric literal (parse_atom), a third is an error.
        c = peek()
        if c in ("+", "-"):
            pos[0] += 1
            return -1.0 if c == "-" else 1.0
        return 1.0

    def parse_pow():
        # '^' (eval.c parse_factor) binds tighter than * and /, and is left
        # associative (2^3^2 = 64); a leading sign multiplies the whole
        # chain (-3^2 = -9, --3^2 = -(pow(-3, 2)) = -9); an exponent's own
        # sign negates the exponent (2^-3 = 0.125).
        sign = parse_sign()
        v = parse_atom()
        while peek() == "^":
            pos[0] += 1
            v = _pow(v, parse_sign() * parse_atom())
        return sign * v

    def parse_number(start):
        while pos[0] < len(s) and (s[pos[0]].isdigit() or s[pos[0]] == "."):
            pos[0] += 1
        # Scientific notation (1e3, 2.5E-2), only where the 'e' is followed
        # by a digit or a signed digit; otherwise it starts a name.
        if pos[0] < len(s) and s[pos[0]] in "eE":
            j = pos[0] + 1
            if j < len(s) and s[j] in "+-":
                j += 1
            if j < len(s) and s[j].isdigit():
                pos[0] = j
                while pos[0] < len(s) and s[pos[0]].isdigit():
                    pos[0] += 1
        return float(s[start:pos[0]])

    def parse_atom():
        c = peek()
        if c in ("-", "+"):
            # parse_sign took the sign before this one; av_strtod takes
            # exactly one more into a numeric literal ('--3' = -(-3)), and
            # anything else ('--x', '---3') is an error in ffmpeg too.
            pos[0] += 1
            nxt = peek()
            if nxt.isdigit() or nxt == ".":
                v = parse_number(pos[0])
                return -v if c == "-" else v
            raise ValueError(f"cannot parse expression {expr!r} at {s[pos[0]:]!r}")
        if c == "(":
            pos[0] += 1
            v = parse_sum()
            if peek() != ")":
                raise ValueError(f"unbalanced parens in expression {expr!r}")
            pos[0] += 1
            return v
        start = pos[0]
        if c.isdigit() or c == ".":
            return parse_number(start)
        if c.isalpha() or c == "_":
            while pos[0] < len(s) and (s[pos[0]].isalnum() or s[pos[0]] == "_"):
                pos[0] += 1
            name = s[start:pos[0]]
            if peek() == "(":
                if name not in funcs:
                    raise ValueError(f"unknown function {name!r} in {expr!r}")
                pos[0] += 1
                a = [parse_sum()]
                while peek() == ",":
                    pos[0] += 1
                    a.append(parse_sum())
                if peek() != ")":
                    raise ValueError(f"unbalanced parens in expression {expr!r}")
                pos[0] += 1
                return float(funcs[name](*a))
            if name not in env:
                raise ValueError(f"unknown variable {name!r} in {expr!r}")
            return float(env[name])
        raise ValueError(f"cannot parse expression {expr!r} at {s[pos[0]:]!r}")

    v = parse_sum()
    if peek() != "":
        raise ValueError(f"trailing garbage in expression {expr!r}: {s[pos[0]:]!r}")
    return v


def _crop_fields(spec: str) -> list:
    parts = str(spec).split(":")
    if parts and parts[-1] == "":  # one trailing ':' is tolerated
        parts.pop()
    if not parts or any(p == "" for p in parts):
        # ffmpeg's av_expr refuses an empty field; shifting the remaining
        # fields left would crop the wrong region.
        raise ValueError(f"empty field in --crop value {spec!r}")
    if len(parts) > 6:
        raise ValueError(f"--crop takes at most w:h:x:y:keep_aspect:exact "
                         f"(got {spec!r})")
    return parts


def validate_crop_spec(spec: str) -> None:
    """Check a ``--crop`` value's syntax: its fields and that each
    expression parses. Values are not judged: whether an expression is
    finite and inside the frame depends on the video's dimensions, which
    :func:`parse_crop_rect` checks at render time. Raises ``ValueError``
    on a malformed spec."""
    parts = _crop_fields(spec)
    env = {
        "in_w": 1920.0, "iw": 1920.0, "in_h": 1080.0, "ih": 1080.0,
        "out_w": 1920.0, "ow": 1920.0, "out_h": 1080.0, "oh": 1080.0,
        "a": 16 / 9, "sar": 1.0, "dar": 16 / 9, "hsub": 2, "vsub": 2,
        "n": 0, "t": 0.0, "x": 0.0, "y": 0.0,
    }
    for i, p in enumerate(parts):
        # keep_aspect and exact (fields 5 and 6) are option booleans that
        # ffmpeg evaluates without the frame variables (parse_crop_rect).
        eval_ffmpeg_expr(p, env if i < 4 else {})


def parse_crop_rect(spec: str, width: int, height: int):
    """``(ch, cw, cy, cx)`` of a ``--crop`` value in the ffmpeg crop
    filter's syntax ``w:h[:x:y]`` on a ``width`` x ``height`` frame. Each
    field is an ffmpeg expression over ``in_w``/``iw``/``in_h``/``ih`` and
    ``out_w``/``ow``/``out_h``/``oh``, cross references resolved by the
    crop filter's two rounds of evaluation (``x`` is visible to ``y`` and
    back). x and y default to centred; the values clamp inside the frame
    and round down to even for 4:2:0."""
    parts = _crop_fields(spec)
    # Fields 5 and 6 are vf_crop's keep_aspect and exact. exact=0 (round
    # to the subsampling grid) is what this parser does; keep_aspect only
    # rewrites the output's SAR, which the writers here do not carry. Both
    # are option booleans that ffmpeg evaluates without the frame
    # variables (libavutil/opt.c), so 'crop=...:gt(iw,0)' fails there too.
    if len(parts) >= 5 and eval_ffmpeg_expr(parts[4], {}) != 0:
        print("note: --crop keep_aspect adjusts SAR metadata only; "
              "this pipeline writes square pixels — ignored", file=sys.stderr)
    base = {
        "in_w": width, "iw": width, "in_h": height, "ih": height,
        "a": width / height, "sar": 1.0, "dar": width / height,
        "hsub": 2, "vsub": 2, "n": 0, "t": 0.0,
        # x and y are NaN while sizing, as in vf_crop's config_input: a w
        # or h expression that uses them fails the finite check below.
        "x": math.nan, "y": math.nan,
    }
    # ffmpeg evaluates w and h twice so that each may reference the other
    # (libavfilter/vf_crop.c config_input): out_* start as in_*.
    env = dict(base, out_w=width, ow=width, out_h=height, oh=height)
    for _ in range(2):
        cw = eval_ffmpeg_expr(parts[0], env) if len(parts) > 0 else width
        env.update(out_w=cw, ow=cw)
        ch = eval_ffmpeg_expr(parts[1], env) if len(parts) > 1 else height
        env.update(out_h=ch, oh=ch)
    if not (math.isfinite(cw) and math.isfinite(ch)):
        raise ValueError(f"--crop {spec!r} evaluates to a non-finite size "
                         f"({cw}x{ch}) at {width}x{height}")
    cw, ch = int(cw), int(ch)
    cw = max(2, min(cw, width))
    ch = max(2, min(ch, height))
    cw -= cw % 2
    ch -= ch % 2
    # vf_crop evaluates x, then y, then x again, so that each may reference
    # the other; both start at the centred defaults.
    env.update(out_w=cw, ow=cw, out_h=ch, oh=ch,
               x=(width - cw) / 2, y=(height - ch) / 2)
    for _ in range(2):
        cx = eval_ffmpeg_expr(parts[2], env) if len(parts) > 2 else (width - cw) / 2
        env["x"] = cx
        cy = eval_ffmpeg_expr(parts[3], env) if len(parts) > 3 else (height - ch) / 2
        env["y"] = cy
    if not (math.isfinite(cx) and math.isfinite(cy)):
        raise ValueError(f"--crop {spec!r} evaluates to a non-finite offset at "
                         f"{width}x{height}")
    cx, cy = int(cx), int(cy)
    cx = max(0, min(cx, width - cw))
    cy = max(0, min(cy, height - ch))
    cx -= cx % 2
    cy -= cy % 2
    return ch, cw, cy, cx


def apply_crop_rect(out_meta: VideoMeta, options):
    """(cropped VideoMeta, rect or None) for ``--crop W:H[:X:Y]``."""
    spec = getattr(options, "crop_rect", None)
    if not spec:
        return out_meta, None
    rect = parse_crop_rect(spec, out_meta.width, out_meta.height)
    ch, cw, _, _ = rect
    return VideoMeta(cw, ch, out_meta.fps, out_meta.num_frames), rect


# --- frame sinks around the writer -----------------------------------------


class CropSink:
    """The output rectangle of ``--crop W:H[:X:Y]`` (the reference's
    ``crop=`` output filter): slices every written YUV triple, numpy
    planes or tensors alike. In front of the readback (the renders put it
    outside :class:`AsyncFrameWriter`) it slices the device's planes, so
    only the rectangle crosses to the host; the bytes written are those
    of cropping after the readback."""

    def __init__(self, sink, rect):
        self._sink = sink
        self._ch, self._cw, self._cy, self._cx = rect

    def write(self, planes):
        y, u, v = planes
        ch, cw, cy, cx = self._ch, self._cw, self._cy, self._cx
        self._sink.write((
            y[cy:cy + ch, cx:cx + cw],
            u[cy // 2:(cy + ch) // 2, cx // 2:(cx + cw) // 2],
            v[cy // 2:(cy + ch) // 2, cx // 2:(cx + cw) // 2],
        ))

    def close(self):
        self._sink.close()


class PreviewSink:
    """Headless analogue of the reference demo's live view (it imshows
    every warped frame, ``opencv/DisplayImage.cpp:60-72``): every Nth final
    output frame written as a PNG into a directory, to look at while the
    render runs (``--preview DIR [--preview-every N]``). Runs on the
    writer thread, on host planes."""

    def __init__(self, sink, directory: str, every: int = 30):
        os.makedirs(directory, exist_ok=True)
        self._sink = sink
        self._dir = directory
        self._every = max(1, int(every))
        self._i = 0

    def write(self, planes):
        if self._i % self._every == 0:
            import cv2

            y, u, v = (np.asarray(p) for p in planes)
            cv2.imwrite(os.path.join(self._dir, f"preview_{self._i:06d}.png"),
                        yuv420_to_bgr(y.astype(np.uint8), u.astype(np.uint8),
                                      v.astype(np.uint8)))
        self._i += 1
        self._sink.write(planes)

    def close(self):
        self._sink.close()


class DisplaySink:
    """The reference demo's live view: ``imshow`` of each final output
    frame in a window as the render runs (``opencv/DisplayImage.cpp:60-72``).
    Made by :func:`make_display_sink`, which first probes for a GUI that
    works. ESC closes the window; the render goes on."""

    _WINDOW = "video_annotator_tpu"

    def __init__(self, sink):
        self._sink = sink
        self._open = True

    def write(self, planes):
        self._sink.write(planes)
        if not self._open:
            return
        import cv2

        y, u, v = (np.asarray(p).astype(np.uint8) for p in planes)
        try:
            cv2.imshow(self._WINDOW, yuv420_to_bgr(y, u, v))
            # The reference loop's 1 ms waitKey pump (DisplayImage.cpp:70).
            if cv2.waitKey(1) & 0xFF == 27:
                cv2.destroyWindow(self._WINDOW)
                self._open = False
        except cv2.error:
            # The display went away during the render: stop showing frames,
            # keep rendering.
            self._open = False

    def close(self):
        if self._open:
            import cv2

            try:
                cv2.destroyWindow(self._WINDOW)
            except cv2.error:
                pass
        self._sink.close()


def gui_available() -> bool:
    """True when OpenCV's highgui can open a window on this host. Probed in
    a child process: a headless build aborts inside ``namedWindow``, which
    no handler catches, and a GUI build without a display fails on the
    first event pump. A child that dies in any way means no GUI."""
    import subprocess

    try:
        probe = subprocess.run(
            [sys.executable, "-c",
             "import cv2; cv2.namedWindow('__vat_probe__'); "
             "cv2.waitKey(1); cv2.destroyWindow('__vat_probe__')"],
            capture_output=True, timeout=20)
        return probe.returncode == 0
    except Exception:
        return False


def make_display_sink(sink):
    """``sink`` in a :class:`DisplaySink` where a GUI works here (the child
    probe of :func:`gui_available` exits 0 and the window opens);
    otherwise a one-line warning and ``sink`` unchanged, as the JAX
    package does."""
    if not gui_available():
        print("[render] --display: no usable GUI on this host; "
              "use --preview DIR for the headless live view", file=sys.stderr)
        return sink
    try:
        import cv2

        cv2.namedWindow(DisplaySink._WINDOW, cv2.WINDOW_AUTOSIZE)
        cv2.waitKey(1)
    except Exception as e:  # the display went away after the probe
        print(f"[render] --display: GUI probe passed but the window "
              f"failed to open ({e!s:.120}); continuing headless", file=sys.stderr)
        return sink
    return DisplaySink(sink)


def wrap_preview(sink, options):
    """``--preview`` and ``--display`` around the file sink (innermost):
    frames reach them through the crop and the HUD, so they show exactly
    the frame the container receives."""
    if getattr(options, "preview", None):
        sink = PreviewSink(sink, options.preview, getattr(options, "preview_every", 30))
    if getattr(options, "display", False):
        sink = make_display_sink(sink)
    return sink


def open_sink(source: str, dest: Optional[str], out_meta: VideoMeta,
              options: RenderOptions, overlay=None,
              profiler: Optional[StageProfiler] = None):
    """The encode paths' frame sink for ``out_meta``-sized frames on the
    device: the file (cropped size), ``--preview``/``--display`` around
    it, then ``overlay`` (a function that wraps a sink in the ``--debug``
    HUD), all on the :class:`AsyncFrameWriter` thread (its ``readback``
    and ``sink`` stages in ``profiler``), and outermost the
    ``--crop W:H[:X:Y]`` rectangle, sliced before the readback so that
    the HUD draws on the cropped frame (the JAX package's nesting)."""
    write_meta, crop_r = apply_crop_rect(out_meta, options)
    sink = wrap_preview(
        open_writer(None if options.no_output else dest, write_meta,
                    encoder=options.encoder, **_passthrough_kwargs(source, options)),
        options)
    if overlay is not None:
        sink = overlay(sink)
    writer = AsyncFrameWriter(sink, profiler=profiler)
    return CropSink(writer, crop_r) if crop_r else writer


def _input_camera(meta: VideoMeta, o: RenderOptions) -> Camera:
    size = (meta.width, meta.height)
    if o.preset is not None:
        return get_preset_camera(o.preset, size)
    return camera_from_dfov(o.input_dfov, size, CameraModel.FISHEYE)


def build_cameras(meta: VideoMeta, o: RenderOptions):
    """Input camera from preset/dfov; output camera auto-fit or explicit,
    with the stabilise buffer widening the canvas while stabilising."""
    in_cam = _input_camera(meta, o)
    out_scale = o.scale * upsample_factor(o.upsample)
    zoom = 1.0
    if o.stabilise != "none" and o.stabilise_buffer:
        zoom = 1.0 / (1.0 + o.stabilise_buffer / 100.0)
    out_model = PROJECTION_MODELS.get(o.projection, CameraModel.RECTILINEAR)
    if o.width and o.height and o.output_dfov:
        out_cam = camera_from_dfov(o.output_dfov, (o.width, o.height), out_model)
    elif out_model != CameraModel.RECTILINEAR or o.output_dfov:
        base = get_output_camera(in_cam, scale=out_scale,
                                 crop_borders=o.crop_borders, zoom=zoom)
        size = (o.width or base.width, o.height or base.height)
        dfov = o.output_dfov or o.input_dfov
        out_cam = camera_from_dfov(dfov, size, out_model)
    else:
        out_cam = get_output_camera(in_cam, scale=out_scale,
                                    crop_borders=o.crop_borders, zoom=zoom)
        if o.width or o.height:
            up = upsample_factor(o.upsample)
            tw = o.width or round(meta.width * up)
            th = o.height or round(meta.height * up)
            sx = tw / out_cam.width
            out_cam = Camera.make(
                out_cam.fx * sx, out_cam.fy * sx, out_cam.cx * sx,
                out_cam.cy * sx - (out_cam.height * sx - th) / 2.0,
                tw, th, out_cam.model,
            )
    return in_cam, out_cam


# --- phase 1: analyse ------------------------------------------------------


def pair_generator(seed: int, frame_index: int) -> torch.Generator:
    """The RANSAC generator of the pair ending at global ``frame_index``:
    a function of the index alone, so trajectories do not depend on the
    chunk size (or on the device: it draws on the CPU)."""
    return torch.Generator().manual_seed((seed << 32) + int(frame_index))


class _Tracking:
    """What both analysers share: the tracking-scale input camera, the
    RANSAC threshold, the gates of :func:`tracking_gates` and the seeding
    border at tracking resolution, the RANSAC samples, the LK (``lk``, the
    device's :class:`~video_annotator_tpu_torch.ops.lk_kernel.LKRoute` at
    ``--analysis-iters``), the ``profiler`` that times their parts (the
    caller's, or one of their own) and their interface: :meth:`push` a
    frame, then :meth:`finish`, each returning the (k, 3, 3) accumulated
    rotations that became known."""

    def __init__(self, meta: VideoMeta, options: RenderOptions, device,
                 profiler: Optional[StageProfiler] = None):
        self.device = torch.device(device)
        self.profiler = profiler or StageProfiler()
        self.lk = LKRoute(self.device, iters=options.analysis_iters)
        in_cam_native = _input_camera(meta, options)
        self.level = analysis_level(options, meta)
        self.in_cam = mip_camera(in_cam_native, self.level)
        track_w = self.in_cam.width
        self.threshold = 8.0 / float(in_cam_native.fx)
        self.min_distance, self.min_inliers, self.min_refresh = tracking_gates(track_w)
        self.border = tracking_border(track_w, self.in_cam.height)
        self._eye = torch.eye(3, dtype=torch.float32, device=self.device)
        self._none = self._eye[None][:0]  # (0, 3, 3): no rotation known yet

    @staticmethod
    def hypothesis_pairs(status: torch.Tensor, first_index: int) -> torch.Tensor:
        """(P, H, 2) RANSAC samples among the tracked points of (P, N)
        ``status``, row p drawn from the generator of pair ``first_index +
        p``; the uniforms are drawn on the host and uploaded without a
        sync."""
        u = torch.stack([
            torch.rand((NUM_HYPOTHESES, 2),
                       generator=pair_generator(RANSAC_SEED, first_index + i))
            for i in range(status.shape[0])
        ])
        if status.is_cuda:
            u = u.pin_memory().to(status.device, non_blocking=True)
        return sample_pairs(status, u)


class PairTracker(_Tracking):
    """Paired analyse (``--analysis-mode paired``), a chunk of
    ``--analysis-chunk`` frame pairs at a time.

    :meth:`push` buffers each frame and returns nothing until a chunk is
    full; then the chunk (with the previous chunk's last frame in front)
    is tracked in one call (:meth:`__call__`) and its rotations returned.
    :meth:`finish` tracks the rest, padded to a chunk with its last frame,
    and drops the padded rotations. The tracker carries the previous
    chunk's last frame and rotations and the global index of the next
    pair, which keys its RANSAC generator, so the trajectory does not
    depend on the chunk size.

    A chunk: detect fresh corners on every frame, LK-track all adjacent
    pairs (in one K2 launch per pyramid level, or the plain LK over the
    pair axis), RANSAC every pair, carry failed pairs (fewer than the
    inlier gate) over with the last good delta, and chain the deltas into
    accumulated rotations.

    ``profiler`` times the parts of each chunk on the host clock, which
    together cover it: ``detect`` (the box downsample and the corners),
    ``stage`` (K3's staging, for K2), ``lk``, ``ransac`` (``hypotheses``
    inside it: the host draws and their upload) and ``chain`` (the
    last-valid scan and the products). Nothing in a call waits for the
    device, so on a card each span is the host's enqueue."""

    def __init__(self, meta: VideoMeta, options: RenderOptions, device,
                 profiler: Optional[StageProfiler] = None):
        super().__init__(meta, options, device, profiler)
        self.detect_level = max(0, int(options.analysis_detect_level))
        self.det_md = max(1, self.min_distance >> self.detect_level)
        self.det_border = max(4, -(-self.border // (1 << self.detect_level)))
        self.det_scale = float(1 << self.detect_level)
        self.chunk = max(1, int(options.analysis_chunk))
        self._prev = None  # the last frame tracked, the next chunk's first
        self._pending: list = []
        self._r_base = self._prev_delta = self._eye
        self._offset = 0  # global index of the next pair

    def push(self, frame: torch.Tensor) -> torch.Tensor:
        """Feed the next (H, W) uint8 frame; returns the (k, 3, 3)
        accumulated rotations now known: the identity for the first frame,
        none while a chunk fills, then the chunk's."""
        if self._prev is None:
            self._prev = frame
            return self._eye[None]
        self._pending.append(frame)
        if len(self._pending) < self.chunk:
            return self._none
        return self.finish()

    def finish(self) -> torch.Tensor:
        """Track the frames pushed since the last chunk (the tail pads with
        its last frame; padded rotations are dropped) and return their
        rotations."""
        k = len(self._pending)
        if not k:
            return self._none
        frames = [self._prev] + self._pending + self._pending[-1:] * (self.chunk - k)
        self._prev = self._pending[-1]
        self._pending = []
        self._r_base, self._prev_delta, rs = self(self._r_base, self._prev_delta,
                                                  self._offset, torch.stack(frames))
        self._offset += k
        return rs[:k]

    def detect(self, grays: torch.Tensor):
        """Corners of (P, h, w) float frames at tracking resolution,
        detected ``--analysis-detect-level`` levels lower and scaled back:
        ``(pts (P, N, 2), valid (P, N))``."""
        pts, valid = detect_corners(box_downsample(grays, self.detect_level),
                                    max_corners=MAX_CORNERS, min_distance=self.det_md,
                                    border=self.det_border)
        if self.detect_level:
            pts = pts * self.det_scale + (self.det_scale - 1.0) * 0.5
        return pts, valid

    def __call__(self, r_base: torch.Tensor, prev_delta: torch.Tensor,
                 offset: int, frames: torch.Tensor):
        """One chunk: (G+1, H, W) uint8 frames (element 0 = the previous
        chunk's last), its first pair's global index ``offset`` -> (r_base',
        prev_delta', (G, 3, 3) accumulated rotations)."""
        span = self.profiler.stage
        g = frames.shape[0] - 1
        with span("detect"):
            grays = box_downsample(frames.to(torch.float32), self.level)
            pts, valid = self.detect(grays[:-1])
        staged = self.lk.stage_pairs(grays, self.profiler)
        with span("lk"):
            new_pts, status = self.lk.track_pairs(staged, pts, valid)
        with span("ransac"):
            with span("hypotheses"):
                pairs = self.hypothesis_pairs(status, offset)
            est = estimate_rotation(
                self.in_cam.unproject_unit(pts), self.in_cam.unproject_unit(new_pts),
                status, threshold_rad=self.threshold, pairs=pairs)

        with span("chain"):
            # Last-valid scan: a failed pair inherits the nearest preceding
            # good delta (the carry for the chunk's first pairs).
            ok = torch.cat([torch.ones(1, dtype=torch.bool, device=self.device),
                            est.num_inliers >= self.min_inliers])
            rots = torch.cat([prev_delta[None], est.rotation])
            steps = torch.arange(g + 1, device=self.device)
            last_ok = torch.cummax(torch.where(ok, steps, 0), dim=0).values
            deltas = rots[last_ok][1:]
            # R_t = delta_t ... delta_1 . r_base
            prods = [deltas[0]]
            for i in range(1, g):
                prods.append(so3.matmul(deltas[i], prods[-1]))
            rs = so3.orthonormalize(so3.matmul(torch.stack(prods), r_base))
        return rs[-1], deltas[-1], rs


class Tracker(_Tracking):
    """Sequential tracked analyse (``--analysis-mode tracked``), the
    counterpart of the JAX package's ``_make_tracker``: corners carry over
    from frame to frame and are re-detected on key frames, as in the
    reference's per-frame loop.

    Each frame is box-downsampled to the tracking scale and, for K2, its
    pyramid staged once (K3; a level too small for K2's window stays
    float); the frame and its pyramid are carried as the next step's
    previous frame. Per step: K2's per-frame form over the two staged
    pyramids and the plain level on the float levels (or the plain LK over
    the two frames), RANSAC on the
    unit rays, the inlier-gated fallback to the previous
    delta, and ``R_t = orthonormalize(delta . R_{t-1})``.

    The key-frame rule of the JAX package's ``lax.cond`` (re-detect when
    the key frame is ``KEY_FRAME_MAX_AGE`` frames old or fewer than
    ``min_refresh`` points survived) runs on the host here: the step reads
    ``status.sum()`` once, one device sync per frame except on age-refresh
    frames (counted in ``host_syncs``). The alternative, detecting on
    every frame and selecting on the device, costs a full-frame detection
    per frame instead.

    RANSAC draws from :func:`pair_generator` of the pair's index, the
    paired path's convention, so the trajectory depends neither on
    ``--analysis-chunk`` nor on the device.

    ``profiler`` times the parts of each step on the host clock (stages
    ``stage``, ``lk``, ``ransac``, ``chain`` and ``key frame``, nested in
    the caller's ``track`` where the caller passes its profiler, as
    :func:`analyse` and the streaming render do); on a card they measure
    the host's enqueue, except ``key frame``, whose status read waits for
    the device."""

    def __init__(self, meta: VideoMeta, options: RenderOptions, device,
                 profiler: Optional[StageProfiler] = None):
        super().__init__(meta, options, device, profiler)
        self.host_syncs = 0
        self._carry = None

    def _gray(self, frame: torch.Tensor) -> torch.Tensor:
        return box_downsample(frame.to(torch.float32), self.level)

    def _detect(self, gray: torch.Tensor):
        return detect_corners(gray, max_corners=MAX_CORNERS,
                              min_distance=self.min_distance, border=self.border)

    def detect(self, frame: torch.Tensor):
        """(H, W) frame -> ``(pts, valid, state)``: corners at tracking
        resolution and the carry, the LK route's pyramid ``(gray, staged
        levels)`` (no levels for the plain LK, which takes the frames)."""
        gray = self._gray(frame)
        pts, valid = self._detect(gray)
        return pts, valid, self.lk.stage(gray)

    def step(self, state, frame: torch.Tensor, pts: torch.Tensor,
             valid: torch.Tensor, prev_delta: torch.Tensor, r_acc: torch.Tensor,
             frame_index: int, age: int):
        """Track ``pts`` from the frame of ``state`` into ``frame``.

        ``frame_index`` counts the pair (0 for the first frame pair),
        ``age`` the frames since the last key frame. Returns ``(pts,
        valid, delta, r, state)`` for the next step."""
        span = self.profiler.stage
        with span("stage"):
            staged = self.lk.stage(self._gray(frame))
        with span("lk"):
            new_pts, status = self.lk.track(state, staged, pts, valid)
        with span("ransac"):
            est = estimate_rotation(
                self.in_cam.unproject_unit(pts)[None],
                self.in_cam.unproject_unit(new_pts)[None], status[None],
                threshold_rad=self.threshold,
                pairs=self.hypothesis_pairs(status[None], frame_index))
        with span("chain"):
            delta = rotation_with_fallback(est, prev_delta[None], self.min_inliers)[0]
            r = so3.orthonormalize(so3.matmul(delta, r_acc))
        with span("key frame"):
            refresh = age >= KEY_FRAME_MAX_AGE
            if not refresh:
                self.host_syncs += 1
                refresh = int(status.sum()) < self.min_refresh
            if refresh:
                new_pts, status = self._detect(staged[0])
        return new_pts, status, delta, r, staged

    def push(self, frame: torch.Tensor) -> torch.Tensor:
        """Feed the next frame; returns its (1, 3, 3) accumulated rotation
        (the identity for the first frame)."""
        if self._carry is None:
            pts, valid, state = self.detect(frame)
            self._carry = (state, pts, valid, self._eye, self._eye, 0, 0)
            return self._eye[None]
        state, pts, valid, delta, r, age, n = self._carry
        pts, valid, delta, r, state = self.step(state, frame, pts, valid,
                                                delta, r, n, age)
        age = 0 if age >= KEY_FRAME_MAX_AGE else age + 1
        self._carry = (state, pts, valid, delta, r, age, n + 1)
        return r[None]

    def finish(self) -> torch.Tensor:
        """Nothing waits: every frame's rotation came from its push."""
        return self._none


def analyse(source: str, options: RenderOptions,
            profiler: Optional[StageProfiler] = None, device="cuda") -> Trajectory:
    """Per-frame accumulated camera rotations of ``source``.

    Paired mode tracks chunks of ``--analysis-chunk`` frames; tracked mode
    runs frame by frame whatever the chunk (the JAX package's chunked scan
    and per-frame steps give the same trajectory). With ``--horizon-lock``
    the trajectory also carries ``up0`` where the source has telemetry."""
    prof = profiler or StageProfiler()
    mode = resolve_analysis_mode(options, device)
    dev = torch.device(device)
    with prof.stage("open"):
        reader, meta, first, last = open_trimmed(source, options, dev)
        tracker = (Tracker if mode == "tracked" else PairTracker)(meta, options, dev, prof)
        frames = TrimmedFrames(reader, first, last, options, dev, prof)
    r_list = []
    prog = Progress("analyse", total=(last - first) if meta.num_frames else None)
    with frames:
        for y, _, _ in frames:
            with prof.stage("track"):
                r_list.append(tracker.push(y))
            prog.tick()
        with prof.stage("track"):
            r_list.append(tracker.finish())
    prog.close()

    with prof.stage("collect"):
        rotvecs = so3.log(torch.cat(r_list)).cpu().numpy().astype(np.float64)
    # Telemetry extraction and gravity integration are pure cost unless
    # the horizon lock consumes the result.
    up0 = (_estimate_up0(source, float(first) / float(meta.fps), dev)
           if options.horizon_lock else None)
    return Trajectory(params=rotvecs, kind="so3", fps=meta.fps,
                      width=meta.width, height=meta.height, source=source,
                      up0=up0)


def _f32(x, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


def _estimate_up0(source: str, t0: float, device) -> Optional[np.ndarray]:
    """World-up in frame-0 camera coordinates from the source's GPMF GYRO
    and ACCL streams, or None for a source without them: ``--horizon-lock``
    then takes the first frame as level."""
    try:
        imu = extract_imu(source)
    except NO_TELEMETRY:
        return None
    if imu[b"GYRO"] is None or imu[b"ACCL"] is None:
        return None
    omega, ts = imu[b"GYRO"]
    accl, accl_ts = imu[b"ACCL"]
    return estimate_up_direction(omega, ts, accl, accl_ts, t0=t0, device=device)


def _gyro_frame_times(source: str, gyro_ts, native: bool = True):
    """(frame_ts, fps, width, height): video frame timestamps, from the
    container's video track when it has one, else a grid at the reader's
    frame rate. Only a telemetry-only file, a container whose tracks
    parse and hold no video, gets a 30 fps grid over the gyro span: a
    video the readers cannot open (a missing decoder included) raises."""
    frame_ts = None
    meta_w = meta_h = 0
    fps = Fraction(30, 1)
    try:
        tracks = parse_tracks(source)
    except NO_TELEMETRY:
        tracks = []
    for track in tracks:
        if track.handler_type == b"vide" and track.sample_times:
            frame_ts = np.asarray(track.sample_times)
            if len(frame_ts) > 1:
                fps = Fraction(
                    1.0 / float(np.median(np.diff(frame_ts)))).limit_denominator(1001)
            break
    if frame_ts is None:
        if tracks and all(track.handler_type != b"vide" for track in tracks):
            n = int((gyro_ts[-1] - gyro_ts[0]) * 30.0) + 1
        else:
            reader = open_reader(source, device="cpu", prefer_native=native)
            meta = reader.meta
            reader.close()
            fps = meta.fps
            meta_w, meta_h = meta.width, meta.height
            n = meta.num_frames or int((gyro_ts[-1] - gyro_ts[0]) * float(fps)) + 1
        frame_ts = gyro_ts[0] + np.arange(n) / float(fps)
    return frame_ts, fps, meta_w, meta_h


def _trimmed_frame_times(source: str, gyro_ts, options: RenderOptions,
                         meta: Optional[VideoMeta] = None):
    """:func:`_gyro_frame_times` cut to the trim window, as the visual
    analyser honours it. A window given in seconds is counted at the frame
    rate of ``meta``, the encode's reader, where there is one, else at the
    rate of the frame times."""
    frame_ts, fps, meta_w, meta_h = _gyro_frame_times(source, gyro_ts, options.native_io)
    if meta is None:
        meta = VideoMeta(meta_w, meta_h, fps, len(frame_ts))
    first, last = _frame_range(
        VideoMeta(meta.width, meta.height, meta.fps, len(frame_ts)), options)
    return frame_ts[first:min(last, len(frame_ts))], fps, meta_w, meta_h


def analyse_gyro(source: str, options: RenderOptions,
                 profiler: Optional[StageProfiler] = None,
                 device="cuda") -> Trajectory:
    """Trajectory from the GPMF gyro track instead of visual tracking:
    integrate the angular-rate samples on SO(3) and resample at the frame
    timestamps. No frame is decoded, and texture-poor footage is no
    obstacle. A source without a gyro stream raises what the parsers
    raise (:data:`NO_TELEMETRY`)."""
    prof = profiler or StageProfiler()
    dev = torch.device(device)
    with prof.stage("gyro-parse"):
        omega, ts = extract_gyro(source)
    # encode() indexes corrections from the trimmed range's first frame,
    # and the trajectory rebases there (integrate_gyro's first resample
    # time is the identity).
    frame_ts, fps, meta_w, meta_h = _trimmed_frame_times(source, ts, options)
    if len(frame_ts) == 0:
        raise ValueError("trim window selects no frames")

    with prof.stage("gyro-integrate"):
        r = integrate_gyro(_f32(omega, dev), _f32(ts, dev), _f32(frame_ts, dev))
        # integrate_gyro returns the attitude R_t (world-from-camera
        # increments); the measured trajectory is C_t C_0^-1 = R_t^-1.
        rotvecs = -so3.log(r).cpu().numpy().astype(np.float64)

    up0 = None
    if options.horizon_lock:
        try:
            accl, accl_ts = extract_accl(source)
        except NO_TELEMETRY:
            pass  # no ACCL stream: the lock takes the first frame as level
        else:
            up0 = estimate_up_direction(omega, ts, accl, accl_ts,
                                        t0=float(frame_ts[0]), device=dev)
    return Trajectory(params=rotvecs, kind="so3", fps=fps, width=meta_w,
                      height=meta_h, source=source, up0=up0)


# --- phase 2: encode -------------------------------------------------------


def _lock_and_attitude(measured: torch.Tensor, virtual: torch.Tensor,
                       options: RenderOptions, up) -> torch.Tensor:
    """corr = measured . virtual^T (identity when neither stabilising nor
    levelling), with the virtual camera rolled level against ``up`` under
    ``--horizon-lock``, then the --roll/--pitch/--yaw attitude."""
    if options.horizon_lock:
        virtual = level_horizon(virtual, up)
        corr = so3.matmul(measured, so3.transpose(virtual))
    elif options.stabilise == "none":
        corr = torch.eye(3, dtype=measured.dtype,
                         device=measured.device).expand(measured.shape)
    else:
        corr = so3.matmul(measured, so3.transpose(virtual))
    attitude = so3.from_euler(np.radians(options.roll), np.radians(options.pitch),
                              np.radians(options.yaw), device=measured.device)
    return so3.matmul(corr, attitude[None])


def _kalman_virtual(measured: torch.Tensor) -> torch.Tensor:
    """Kalman-smoothed rotations of a (T, 3, 3) stack. The filter is a
    chain of 2x2 products per frame, so it runs on the host and only the
    T x 3 x 3 result goes back to the stack's device."""
    return smooth_rotations_kalman(measured.cpu()).to(measured.device)


def _up_vector(up0) -> np.ndarray:
    """``up0`` as float32, the first frame taken as level where it is None."""
    return np.asarray(DEFAULT_UP if up0 is None else up0, np.float32)


def make_window_corrections(radius: int, options: RenderOptions,
                            up0: Optional[np.ndarray]):
    """(B + 2 radius, 3, 3) measured window -> (B, 3, 3) corrections;
    radius 0 for none and fixed. ``up0`` is world-up in frame-0 camera
    coordinates for ``--horizon-lock`` (None: ``[0, -1, 0]``).

    The two-phase path calls it with the whole replicate-padded
    trajectory, the streaming path per emitted batch with clamp-replicated
    neighbours, so the two cannot diverge: the window is computed on the
    host (T x 9 floats), where the filter, the projection and the products
    give each frame the same bits in a window of any length. On the card
    the batched SVD and reductions need not, and a correction that moves
    in its last bit flips the odd pixel where a warp's validity test
    is discontinuous (the per-tile mip's border at the source edge). ``--smoother kalman`` is the
    fixed-lag form here: the filter runs forward over the whole window
    (the ``radius`` past frames are its burn-in) and RTS backward from the
    window's end, so each frame is smoothed with ``radius`` frames of
    future."""
    if options.stabilise not in ("none", "fixed", "smooth"):
        raise ValueError(f"unknown stabilise mode {options.stabilise!r}")
    if options.smoother not in ("savgol", "kalman"):
        raise ValueError(f"unknown smoother {options.smoother!r}")
    w = torch.from_numpy(savgol_weights(radius, order=2))
    up = torch.from_numpy(_up_vector(up0))

    def window_corr(window: torch.Tensor) -> torch.Tensor:
        return host_corr(window.cpu()).to(window.device)

    def host_corr(window: torch.Tensor) -> torch.Tensor:
        measured = window[radius: window.shape[0] - radius]
        if options.stabilise == "none":
            virtual = measured
        elif options.stabilise == "fixed":
            virtual = torch.eye(3, dtype=window.dtype,
                                device=window.device).expand(measured.shape)
        elif options.smoother == "kalman":
            virtual = _kalman_virtual(window)[radius: window.shape[0] - radius]
        else:
            sm = sg_conv(window.reshape(-1, 9), w)
            virtual = so3.project(sm.reshape(-1, 3, 3))
        return _lock_and_attitude(measured, virtual, options, up)

    return window_corr


def compute_corrections(traj: Trajectory, options: RenderOptions,
                        device="cuda") -> np.ndarray:
    """(T, 3, 3) float32 per-frame warp rotations."""
    measured = torch.from_numpy(traj.rotations()).to(device)
    t = measured.shape[0]
    if t == 0:
        return np.zeros((0, 3, 3), np.float32)
    if options.stabilise == "smooth" and options.smoother == "kalman":
        # The global smoother: forward filter and RTS over the whole clip.
        virtual = _kalman_virtual(measured)
        up = torch.from_numpy(_up_vector(traj.up0))
        return _lock_and_attitude(measured, virtual, options, up).cpu().numpy()
    radius = (min(options.stabilise_radius, max(t - 1, 1))
              if options.stabilise == "smooth" else 0)
    fn = make_window_corrections(radius, options, traj.up0)
    window = measured
    if radius:
        window = torch.cat([measured[:1].expand(radius, 3, 3), measured,
                            measured[-1:].expand(radius, 3, 3)])
    return fn(window).cpu().numpy()


def max_rotation_deg(rotations: np.ndarray) -> float:
    """Largest rotation angle (degrees) in a stack of rotation matrices."""
    if rotations.shape[0] == 0:
        return 0.0
    tr = np.einsum("tii->t", np.asarray(rotations, np.float64))
    cos = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(cos).max()))


class FrameWarper:
    """YUV 4:2:0 warp between a fisheye input and the output camera
    (kernel K1 on CUDA tensors): a frame batch to uint8
    (:meth:`warp_yuv_batch`, the encode path), one frame to uint8
    (:meth:`warp_yuv`) or one frame's float planes to float32
    (:meth:`__call__`, the compare grid's rotation cells).

    Each entry also takes the rolling-shutter form of its rotations, one
    per 8-row luma tile row: (T, ny, 3, 3) for the batch, (ny, 3, 3) for
    one frame. Chroma tile row j then takes luma tile row 2j's rotation.

    ``interp`` picks the resampler (bilinear, or K1's 4-tap mode); an
    output camera that is not rectilinear runs the ray-grid mode;
    ``prefilter`` computes the per-tile mip level maps of luma and chroma
    (``ops/mip.py``) on ``device``, the frames' device, which probe
    ``max_correction_deg``, and runs the mip mode where a tile's level is
    above 0. On the CPU as on the card: the JAX package's CPU fallback uses
    one global level instead."""

    def __init__(self, in_cam: Camera, out_cam: Camera, max_correction_deg: float = 8.0,
                 prefilter: bool = False, interp: str = "bilinear", device="cuda"):
        if interp not in INTERPS:
            raise ValueError(
                f"--interp must be bilinear, bicubic or lanczos, got {interp!r}")
        self.in_cam = in_cam
        self.out_cam = out_cam
        self.out_w = out_cam.width - out_cam.width % 2
        self.out_h = out_cam.height - out_cam.height % 2
        self.in_half = scaled_camera(in_cam, 0.5)
        self.out_half = scaled_camera(out_cam, 0.5)
        self.interp = interp
        sizes = ((self.out_h, self.out_w), (self.out_h // 2, self.out_w // 2))
        cams = ((out_cam, in_cam), (self.out_half, self.in_half))
        self.levels = (None, None)
        if prefilter:
            self.levels = tuple(tile_levels(o, i, max_correction_deg, size, interp,
                                            device=torch.device(device))
                                for (o, i), size in zip(cams, sizes))
        self._modes = dict(interp=interp, levels=self.levels)

    def warp_yuv_batch(self, ys, us, vs, rotations: torch.Tensor):
        """Per-frame plane sequences + (T, 3, 3) or (T, ny, 3, 3)
        rotations -> list of T uint8 (y, u, v) triples."""
        wy, wu, wv = warp_kernel.warp_yuv_batch(
            torch.stack(list(ys)), torch.stack(list(us)), torch.stack(list(vs)),
            rotations, self.out_cam, self.in_cam, self.out_half, self.in_half,
            (self.out_h, self.out_w), **self._modes)
        return list(zip(wy, wu, wv))

    def __call__(self, y, u, v, rotation: torch.Tensor):
        """One frame's float32 planes + one (3, 3) rotation or a
        (ny, 3, 3) stack -> float32 ``(wy, wu, wv)``, neither rounded nor
        clamped: luma in one launch, U and V sharing one map in another.
        Chroma samples centred on 128 so regions outside the image come
        out neutral, not green."""
        size = (self.out_h, self.out_w)
        wy = warp_kernel.warp_frame_f32(y, rotation, self.out_cam, self.in_cam, size,
                                        interp=self.interp, levels=self.levels[0])
        wc = warp_kernel.warp_planes_f32(
            torch.stack([u, v]),
            warp_kernel.chroma_rotations(rotation, (), self.out_h // 2),
            self.out_half, self.in_half,
            (self.out_h // 2, self.out_w // 2), border=128.0, interp=self.interp,
            levels=self.levels[1])
        return wy, wc[0], wc[1]

    def warp_yuv(self, y, u, v, rotation: torch.Tensor):
        """One frame's uint8 planes + one (3, 3) rotation or a (ny, 3, 3)
        stack -> uint8 ``(wy, wu, wv)``."""
        return warp_kernel.warp_yuv(
            y, u, v, rotation, self.out_cam, self.in_cam, self.out_half,
            self.in_half, (self.out_h, self.out_w), **self._modes)


def encode(source: str, dest: Optional[str], traj: Trajectory,
           options: RenderOptions, profiler: Optional[StageProfiler] = None,
           device="cuda") -> VideoMeta:
    """Smooth + warp + write. Returns the output metadata."""
    prof = profiler or StageProfiler()
    dev = torch.device(device)
    with prof.stage("open"):
        reader, meta, first, last = open_trimmed(source, options, dev)
        in_cam, out_cam = build_cameras(meta, options)
        corrections = compute_corrections(traj, options, dev)
        if options.rolling_shutter:
            with prof.stage("scanline"):
                corrections = _scanline_corrections(
                    source, traj, corrections, options, meta, in_cam, out_cam,
                    num_tile_rows(out_cam.height - out_cam.height % 2), dev)
        # The prefilter's level map probes the clip's largest correction.
        need_deg = max_rotation_deg(corrections.reshape(-1, 3, 3))
        budget_deg = max(options.max_correction_deg, need_deg + 0.5)
        warper = FrameWarper(in_cam, out_cam, budget_deg, options.prefilter == "auto",
                             options.interp, dev)
        out_meta = VideoMeta(width=warper.out_w, height=warper.out_h,
                             fps=output_fps(options, meta),
                             num_frames=traj.num_frames)
        overlay = _rotation_overlay(traj, corrections) if options.debug else None
        writer = open_sink(source, dest, out_meta, options, overlay, prof)
        feed = _encode_feed(reader, first, last, corrections, options, prof, dev)
    _batched_encode_loop(writer, feed, warper.warp_yuv_batch, prof, traj.num_frames)
    return out_meta


def _rotation_overlay(traj: Trajectory, corrections: np.ndarray):
    """``--debug``'s HUD for the rotation family: each frame's correction
    angle as text, the measured and correction angles over the clip as
    curves (a rolling-shutter stack shows its centre tile row)."""
    from video_annotator_tpu_torch.pipeline.debug import (
        DebugOverlayWriter,
        rotation_angles_deg,
    )

    corr = np.asarray(corrections, np.float32)
    corr_deg = rotation_angles_deg(corr if corr.ndim == 3 else corr[:, corr.shape[1] // 2])
    meas_deg = rotation_angles_deg(np.asarray(traj.rotations(), np.float32)[:len(corr_deg)])

    def overlay(sink):
        hud = DebugOverlayWriter(sink, total=traj.num_frames,
                                 curves={"measured deg": meas_deg, "correction deg": corr_deg})
        hud.text = {t: f"frame {t}  correction {corr_deg[t]:.2f} deg"
                    for t in range(len(corr_deg))}
        return hud
    return overlay


def _scanline_corrections(source: str, traj: Trajectory, corrections: np.ndarray,
                          options: RenderOptions, meta: VideoMeta,
                          in_cam: Camera, out_cam: Camera, ny: int,
                          device) -> np.ndarray:
    """``--rolling-shutter``: (T, 3, 3) per-frame corrections -> (T, ny,
    3, 3) per-tile-row rotations (scanline-time poses).

    With ``--gyro`` the poses come from the telemetry at every scanline
    time (acceleration within a frame included); for a source without a
    gyro stream, or whose frame times do not cover the trajectory, and
    without ``--gyro``, from the trajectory's frame-rate velocity."""
    fractions = scan_fractions(out_cam, in_cam, ny).to(device)
    corr = _f32(corrections, device)
    telemetry = None
    if options.gyro:
        try:
            telemetry = extract_gyro(source)
        except NO_TELEMETRY:
            pass  # the velocity model below
    if telemetry is not None:
        omega, gts = telemetry
        f_ts = _trimmed_frame_times(source, gts, options, meta)[0][: traj.num_frames]
        if len(f_ts) == traj.num_frames:
            return rs_row_rotations_gyro(
                corr, _f32(omega, device), _f32(gts, device), _f32(f_ts, device),
                options.rolling_shutter / float(meta.fps), fractions).cpu().numpy()
    measured = torch.from_numpy(traj.rotations()).to(device)
    return rs_row_rotations(corr, measured, options.rolling_shutter,
                            fractions).cpu().numpy()


def _encode_feed(reader, first, last, corrections, options, prof, device):
    """What the batched encode needs before its loop, made in its phase's
    ``open`` stage: the per-batch rotation stacks ((T, 3, 3), or (T, ny,
    3, 3) with ``--rolling-shutter``) uploaded up front, the last padded
    with its last rotation, and the trim window's frames. Returns
    ``(frames, rots_dev, batch, corrections)``."""
    corr = np.asarray(corrections, np.float32)
    batch = max(1, int(options.warp_batch or DEFAULT_WARP_BATCH))
    rots_dev = [
        torch.from_numpy(np.concatenate(
            [corr[i:i + batch]] + [corr[-1:]] * max(0, i + batch - len(corr))
        )).to(device)
        for i in range(0, len(corr), batch)
    ]
    frames = TrimmedFrames(reader, first, last, options, device, prof)
    return frames, rots_dev, batch, len(corr)


def _batched_encode_loop(writer, feed, warp_batch_fn, prof, total):
    """Device-batched encode of :func:`_encode_feed`'s ``feed``: prefetched
    frames warped a batch at a time, the tail padded with its last frame
    (padded outputs dropped), outputs given to ``writer``
    (:func:`open_sink`: read back and written on a worker thread)."""
    frames, rots_dev, batch, n_corr = feed
    t = 0
    pending = []
    prog = Progress("encode", total=total)

    def flush():
        n = len(pending)
        if not n:
            return
        ys, us, vs = zip(*(pending + [pending[-1]] * (batch - n)))
        rots = rots_dev[(t - n) // batch]
        with prof.stage("warp"):
            outs = warp_batch_fn(ys, us, vs, rots)
        with prof.stage("encode"):
            for triple in outs[:n]:
                writer.write(triple)
        pending.clear()
        prog.tick(n)

    try:
        with frames:
            for planes in frames:
                if t >= n_corr:
                    break
                pending.append(planes)
                t += 1
                if len(pending) == batch:
                    flush()
            flush()
    except BaseException:
        try:
            writer.close()
        except Exception:
            pass
        raise
    prog.close()
    with prof.stage("encode"):
        writer.close()


def _refuse_translation_upsample(up: float, translation_only: bool) -> None:
    if up != 1.0 and translation_only:
        raise ValueError(
            "--upsample with --filter deshake is not supported (a "
            "translation-only warp cannot scale); use the similarity or "
            "rotation family")


def encode_2d(source: str, dest: Optional[str], traj: Trajectory,
              options: RenderOptions, profiler: Optional[StageProfiler] = None,
              device="cuda") -> VideoMeta:
    """Encode phase of the 2D families (similarity / deshake).

    ``--upsample``: a similarity absorbs the scale exactly (``M @
    diag(1/s, 1/s, 1)`` is still a similarity: same dx, dy and angle,
    log-scale minus log s), so the canvas grows and the content upscales
    in the same single resample. A translation cannot express scale, so
    deshake refuses it.

    On a card the similarity family warps through kernel K1
    (``SimilarityWarper.warp_yuv_batch``) in the rotation family's
    batched loop; deshake, and both families on the CPU, warp frame by
    frame with their plain torch warps."""
    from video_annotator_tpu_torch.models.deshake import (
        deshake_corrections,
        warp_frame_deshake,
    )
    from video_annotator_tpu_torch.models.similarity import (
        SimilarityWarper,
        similarity_corrections,
        warp_frame_similarity,
    )
    from video_annotator_tpu_torch.ops.affine import compose_similarity

    prof = profiler or StageProfiler()
    dev = torch.device(device)
    up = upsample_factor(options.upsample)
    _refuse_translation_upsample(up, traj.kind != "similarity")
    if traj.kind not in ("similarity", "translation"):
        raise ValueError(f"encode_2d cannot handle kind {traj.kind!r}")
    with prof.stage("open"):
        reader, meta, first, last = open_trimmed(source, options, dev)
        out_w = int(meta.width * up) // 2 * 2
        out_h = int(meta.height * up) // 2 * 2
        if traj.kind == "similarity":
            corrections = similarity_corrections(traj, options)
            if up != 1.0:
                # Compose with the pixel-centre-correct upscale sampler
                # x_src = (x + 0.5) / s - 0.5: a pure similarity (translation
                # c, log-scale -log s).
                c = 0.5 * (1.0 / up - 1.0)
                t_up = torch.tensor([c, c, 0.0, -np.log(up)], dtype=torch.float32)
                corrections = compose_similarity(
                    torch.from_numpy(corrections), t_up).numpy()

            def warp(y, u, v, p):
                return warp_frame_similarity(y, u, v, p, interp=options.interp,
                                             out_size=(out_h, out_w))
        else:
            corrections = deshake_corrections(traj, options)
            warp = warp_frame_deshake

        out_meta = VideoMeta(width=out_w, height=out_h, fps=output_fps(options, meta),
                             num_frames=traj.num_frames)
        overlay = _2d_overlay(traj, corrections) if options.debug else None
        writer = open_sink(source, dest, out_meta, options, overlay, prof)
        kernel = traj.kind == "similarity" and dev.type == "cuda"
        if kernel:
            pwarper = SimilarityWarper(meta.width, meta.height, interp=options.interp,
                                       out_size=(out_h, out_w))
            feed = _encode_feed(reader, first, last, SimilarityWarper.matrices(corrections),
                                options, prof, dev)
        else:
            # One frame per batch: the loop pads a short batch with repeated
            # frames, which a frame-by-frame warp would compute for nothing.
            feed = _encode_feed(reader, first, last, corrections,
                                dataclasses.replace(options, warp_batch=1), prof, dev)
    if kernel:
        _batched_encode_loop(writer, feed, pwarper.warp_yuv_batch, prof, traj.num_frames)
        return out_meta

    in_h2 = meta.height - meta.height % 2
    in_w2 = meta.width - meta.width % 2

    def warp_frames(ys, us, vs, corr):
        """The encode loop's batch interface over a one-frame warp."""
        out = []
        for y, u, v, c in zip(ys, us, vs, corr):
            planes = warp(y[:in_h2, :in_w2].to(torch.float32),
                          u[: in_h2 // 2, : in_w2 // 2].to(torch.float32),
                          v[: in_h2 // 2, : in_w2 // 2].to(torch.float32), c)
            out.append(tuple(warp_kernel.to_u8(p) for p in planes))
        return out

    _batched_encode_loop(writer, feed, warp_frames, prof, traj.num_frames)
    return out_meta


def _2d_overlay(traj: Trajectory, corrections: np.ndarray):
    """``--debug``'s HUD for the 2D families: each frame's correction
    shift as text, the measured and correction shifts over the clip as
    curves, and a similarity's correction angle."""
    from video_annotator_tpu_torch.pipeline.debug import DebugOverlayWriter

    corr = np.asarray(corrections, np.float32)
    meas = np.asarray(traj.params, np.float32)[:len(corr)]
    curves = {"measured px": np.linalg.norm(meas[:, :2], axis=1),
              "correction px": np.linalg.norm(corr[:, :2], axis=1)}
    if corr.shape[1] >= 3:  # similarity: (dx, dy, angle, log_scale)
        curves["correction deg"] = np.degrees(np.abs(corr[:, 2]))

    def overlay(sink):
        hud = DebugOverlayWriter(sink, total=traj.num_frames, curves=curves)
        hud.text = {k: f"frame {k}  correction {np.linalg.norm(corr[k, :2]):.1f} px"
                    for k in range(len(corr))}
        return hud
    return overlay


def _analyse_family(family: str, source: str, options: RenderOptions, prof,
                    device) -> Trajectory:
    if family == "similarity":
        from video_annotator_tpu_torch.models.similarity import analyse_similarity

        return analyse_similarity(source, options, prof, device=device)
    if family == "deshake":
        from video_annotator_tpu_torch.models.deshake import analyse_deshake

        return analyse_deshake(source, options, prof, device=device)
    if options.gyro:
        return analyse_gyro(source, options, prof, device=device)
    return analyse(source, options, prof, device=device)


def check_family(options: RenderOptions) -> str:
    """The family ``--filter`` names; raises for the options a 2D family
    refuses (it has no camera attitude to level, no per-scanline poses,
    no single-pass mode; a translation cannot scale)."""
    family = FILTER_ALIASES.get(options.filter)
    if family is None:
        raise ValueError(f"unknown --filter {options.filter!r}; choose from "
                         f"{sorted(FILTER_ALIASES)}")
    # Checked again in encode_2d; refusing here spares the analyse phase.
    _refuse_translation_upsample(upsample_factor(options.upsample),
                                 family == "deshake")
    if family != "rotation":
        if options.horizon_lock:
            raise ValueError(
                "--horizon-lock needs the rotation family (--filter "
                "rotation/dewobble); 2D families have no camera attitude to level")
        if options.rolling_shutter:
            raise ValueError("--rolling-shutter needs the rotation family "
                             "(per-scanline camera poses)")
        if options.streaming and not options.gyro:
            raise ValueError("--streaming is the rotation family's single-pass "
                             "mode; 2D families use the two-phase path")
    if options.rolling_shutter and options.streaming:
        raise ValueError("--rolling-shutter uses the two-phase path (scanline "
                         "velocities need the frame after each frame)")
    return family


def render(source: str, dest: Optional[str],
           options: Optional[RenderOptions] = None,
           profiler: Optional[StageProfiler] = None, device="cuda") -> None:
    """Two-phase render with trajectory checkpoint/resume (``<dest>.traj.npz``),
    or the single-pass ``--streaming`` render. ``--gyro`` takes the
    two-phase path even with ``--streaming``: its analyse decodes nothing.

    On the caller's thread the two-phase path opens ``phase-analyse``
    (the analyse and the trajectory's save) and ``phase-encode`` (the
    encode), each once per call, around the stages of that phase; the
    streaming path opens neither."""
    options = options or RenderOptions()
    prof = profiler or StageProfiler()
    family = check_family(options)
    if options.streaming and not options.gyro:
        from video_annotator_tpu_torch.pipeline.streaming import render_streaming

        render_streaming(source, dest, options, prof, device=device)
        if options.verbose:
            print(prof.report())
        return
    # The horizon lock needs the measured attitude even when not stabilising.
    needs_motion = options.stabilise != "none" or options.horizon_lock
    tpath = trajectory_path(dest) if dest else None
    if needs_motion and not options.encode_only:
        with prof.stage("phase-analyse"):
            traj = _analyse_family(family, source, options, prof, device)
            if tpath:
                with prof.stage("save"):
                    traj.save(tpath)
    elif needs_motion:
        if not (tpath and os.path.exists(tpath)):
            raise FileNotFoundError(
                f"--encode-only but no trajectory at {tpath}; run analyse first")
        traj = Trajectory.load(tpath)
    else:
        # No stabilisation: the family's identity trajectory sized to the clip.
        reader = open_reader(source, device="cpu", prefer_native=options.native_io)
        meta = reader.meta
        reader.close()
        first, last = _frame_range(meta, options)
        n = (last - first) if meta.num_frames else 0
        kind = {"rotation": "so3", "similarity": "similarity",
                "deshake": "translation"}[family]
        traj = Trajectory(params=np.zeros((max(n, 0), KIND_DIMS[kind])),
                          kind=kind, fps=meta.fps, width=meta.width,
                          height=meta.height, source=source)
    if not options.analyse_only:
        with prof.stage("phase-encode"):
            if traj.kind == "so3":
                encode(source, dest, traj, options, prof, device=device)
            else:
                encode_2d(source, dest, traj, options, prof, device=device)
    if options.verbose:
        print(prof.report())
