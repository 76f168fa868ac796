"""Command-line interface of the PyTorch/CUDA port.

The JAX package's subcommands with the same option strings, defaults and
choices (the frozen v1.0 surface), plus ``--device {cuda,cpu}`` on
``render``, ``compare``, ``workflow`` (its ``stabilise``) and
``calibrate``: the card by default, the CPU (the kernels' plain
versions) only when asked for, the port's form of the JAX package's
``JAX_PLATFORMS=cpu``. Without a card, ``--device cuda`` exits 1.

- ``render`` runs every ported path: the rotation family
  (two-phase or ``--streaming``), ``--filter vidstab`` and ``--filter
  deshake``, and the ``--compare`` grid, with ``--interp``,
  ``--projection``, ``--prefilter``, ``--crop`` (bare, or ``W:H[:X:Y]`` in
  ffmpeg crop-filter syntax, validated when the options are built),
  ``--debug``, ``--preview``, ``--display`` and ``--trace DIR`` (a
  torch.profiler trace of the CPU and CUDA activity, which Perfetto and
  TensorBoard open);
- ``compare`` is ``render --compare`` with ``--stabilise none``;
- ``workflow stabilise`` analyses every chapter on the chosen device and
  ``workflow split`` renders each set in a child process of this CLI
  (``--render-args`` passed on unchanged, ``--device`` among them);
- ``calibrate`` fits camera intrinsics from chessboard or circles-grid
  footage, an image list, a ``.npz`` of detections or a settings file;
- ``join``, ``probe``, ``workflow join``, ``workflow tag`` and ``workflow
  encode`` are host IO and need no card.

Usage::

    python -m video_annotator_tpu_torch render in.y4m out.y4m --stabilise smooth
    python -m video_annotator_tpu_torch render in.y4m out.y4m --crop 'iw/2:ih/2'
    python -m video_annotator_tpu_torch render in.y4m grid.y4m --compare none,smooth,vidstab,deshake
    python -m video_annotator_tpu_torch render in.y4m out.y4m --stabilise smooth --device cpu
    python -m video_annotator_tpu_torch calibrate board.y4m -o camera.xml --show-undistorted views
    python -m video_annotator_tpu_torch join 0001 -o match_0001.mp4
    python -m video_annotator_tpu_torch workflow split 0001 --render-args "--stabilise smooth"
"""

from __future__ import annotations

import argparse
import sys

DEVICES = ("cuda", "cpu")


def _parse_time(value):
    """Accept seconds ('12.5' or 12.5) or 'hh:mm:ss(.ms)' timecodes."""
    if value is None:
        return None
    if isinstance(value, (int, float)):
        return float(value)
    if ":" in value:
        secs = 0.0
        for p in value.split(":"):
            secs = secs * 60.0 + float(p)
        return secs
    return float(value)


def _analysis_scale(value):
    """'auto' or one of the supported scales (1, 0.5, 0.25)."""
    if value == "auto":
        return "auto"
    try:
        return float(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected auto, 1, 0.5 or 0.25 (got {value!r})")


class _CompatAction(argparse.Action):
    """Accept a reference-CLI flag that has no meaning here, note the
    equivalent once on stderr, and otherwise do nothing."""

    def __init__(self, *args, hint="", **kwargs):
        self._hint = hint
        super().__init__(*args, **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        hint = f"; {self._hint}" if self._hint else ""
        print(f"note: {option_string} is accepted for reference "
              f"compatibility and has no effect here{hint}", file=sys.stderr)


def _add_device(parser):
    parser.add_argument("--device", default="cuda", choices=DEVICES,
                        help="where the work runs: cuda (default; the CUDA "
                             "kernels, exits 1 without a card) or cpu (their "
                             "plain PyTorch versions)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="video-annotator-tpu-torch",
        description="Action-camera stabilization & reprojection on a CUDA GPU",
    )
    sub = p.add_subparsers(dest="command", required=True)

    j = sub.add_parser("join", help="Join GoPro chaptered segments into one file")
    j.add_argument("code", help="4-digit GoPro file code (GOPRxxxx.MP4)")
    j.add_argument("-o", "--output", required=True, help="Path of resulting video")
    j.add_argument("--directory", default=".", help="Where to look for segments")

    # add_help=False frees ``-h`` to mean height, as in the reference
    # (``render -h <pixels>``, src/cli.ts:45); ``--help`` still works.
    r = sub.add_parser("render", add_help=False,
                       help="Stabilize/reproject part of a source video")
    r.add_argument("--help", action="help",
                   help="show this help message and exit")
    r.add_argument("source")
    r.add_argument("dest", nargs="?", default=None)
    r.add_argument("-s", "--start", type=str, default=None,
                   help="Starting point in the source (seconds or hh:mm:ss)")
    r.add_argument("-d", "--duration", type=str, default=None)
    r.add_argument("-e", "--end", type=str, default=None)
    r.add_argument("-w", "--width", type=int, default=None)
    r.add_argument("-h", "-h2", "--height", type=int, default=None,
                   help="Output height (pixels)")
    r.add_argument("-r", "--roll", type=float, default=0.0,
                   help="Turn camera clockwise by degrees")
    r.add_argument("-p", "--pitch", type=float, default=0.0,
                   help="Turn camera up by degrees")
    r.add_argument("-y", "--yaw", type=float, default=0.0,
                   help="Turn camera left by degrees")
    r.add_argument("-u", "--upsample", type=float, default=0.0,
                   help="Scale video before processing (absolute percent "
                        "as in the reference's scale w=iw*u/100: 150 = "
                        "1.5x, 0 = off)")
    r.add_argument("--scale", type=float, default=1.0,
                   help="Output camera scale relative to auto-fit")
    r.add_argument("--interp", default="bilinear",
                   choices=["bilinear", "bicubic", "lanczos"],
                   help="Warp resampler: bilinear (the native engine's "
                        "INTER_LINEAR), bicubic (the reference's vidstab "
                        "interpol=bicubic), or lanczos (v360's "
                        "interp=lanczos, 4x4 windowed sinc), the last "
                        "two through the warp kernel's 4-tap mode")
    r.add_argument("--prefilter", default="off", choices=["off", "auto"],
                   help="Mip-prefilter minifying inputs before the warp: "
                        "each 8x128 output tile samples the deepest box-"
                        "downsampled level that cannot blur it (antialias; "
                        "off = exact sampling like the reference)")
    # Bare --crop: auto-crop borders to the fully-covered region (the
    # native engine's crop_borders). --crop W:H[:X:Y]: output crop
    # rectangle in ffmpeg crop-filter syntax, X/Y defaulting to centered
    # — the reference forwards the value to `crop=` (src/cli.ts:71-75,
    # src/render.ts:288-292).
    r.add_argument("--crop", dest="crop", nargs="?", const=True,
                   default=None, metavar="W:H[:X:Y]",
                   help="Bare flag: crop borders to the fully-covered "
                        "region; with a value: output crop rectangle "
                        "(ffmpeg crop-filter syntax)")
    r.add_argument("--filter", default="rotation",
                   choices=["rotation", "similarity", "deshake", "dewobble",
                            "vidstab", "deshake_opencl"],
                   help="Stabilizer family (dewobble->rotation, "
                        "vidstab->similarity, deshake_opencl->deshake)")
    r.add_argument("--stabilise", "--stabilize", dest="stabilise",
                   default="none", choices=["none", "fixed", "smooth"])
    r.add_argument("--smoother", default="savgol", choices=["savgol", "kalman"])
    r.add_argument("--stabilise-radius", type=int, default=90,
                   help="Frames of look-ahead/behind for smoothing")
    r.add_argument("--interpolate-radius", type=int, default=30,
                   help="Accepted for reference compatibility; the "
                        "reference only sizes its VAAPI frame pool with "
                        "it (src/render.ts:223) — device buffering here "
                        "is --prefetch-depth/--warp-batch")
    r.add_argument("--stabilise-buffer", type=float, default=20.0,
                   help="Percent extra canvas to avoid cropping")
    r.add_argument("--input-dfov", type=float, default=145.8)
    r.add_argument("--output-dfov", type=float, default=None)
    # Kept in sync with pipeline.render.PROJECTION_MODELS (tested).
    r.add_argument(
        "--projection", default="rect",
        choices=[
            "rect", "flat", "gnomonic", "fisheye", "fish",
            "equirect", "equirectangular", "e",
            "stereographic", "sg", "mercator", "ball", "hammer",
            "sinusoidal", "sinusoid", "cylindrical", "pannini",
        ],
        help="Output lens projection — the v360 single-image family "
        "(the reference forwards this option to v360, src/cli.ts:117-121); "
        "any but rect runs the warp kernel on a precomputed ray grid",
    )
    r.add_argument("--preset", default=None,
                   help="GoPro camera preset name (e.g. gopro_h4b_wide43_measured)")
    r.add_argument("--gyro", action="store_true",
                   help="Use the GPMF gyro track for motion analysis")
    r.add_argument("--max-correction", type=float, default=8.0,
                   help="Correction angle in degrees that --prefilter auto "
                        "probes when it sizes its per-tile levels (a two-phase "
                        "render also probes the clip's largest correction); "
                        "the CUDA warp reads the whole source plane, so there "
                        "is no per-tile window to size")
    r.add_argument("--streaming", action="store_true",
                   help="Single-pass render: decode once, smooth through a "
                        "bounded lookahead window (identical output to the "
                        "two-phase analyse/encode; rotation family)")
    r.add_argument("--rolling-shutter", type=float, default=0.0,
                   help="Sensor readout time as a fraction of the frame "
                        "period (GoPro ~0.75; 0 disables): corrects "
                        "rolling-shutter jello with per-scanline rotations")
    r.add_argument("--horizon-lock", action="store_true",
                   help="Pin the horizon using the GPMF accelerometer's "
                        "gravity direction (assumes a level first frame "
                        "when the source has no telemetry)")
    r.add_argument("-c", "--encode-only", action="store_true",
                   help="Skip analyse; use existing trajectory")
    r.add_argument("-a", "--analyse-only", action="store_true",
                   help="Generate trajectory only")
    r.add_argument("--no-output", action="store_true",
                   help="Run the pipeline but discard output")
    r.add_argument("--encoder", default=None,
                   help="libav encoder name (libx264 QP19 when the native "
                        "writer is built — the reference's default, "
                        "src/cli.ts:120) or 4-char cv2 fourcc; default auto")
    r.add_argument("--frame-rate", type=float, default=None)
    # Hardware-configurator analogues (the reference plans VAAPI/OpenCL
    # wiring + frame pools, src/render.ts:95-252; here the knobs are the
    # device dispatch batch, prefetch depth, and native-IO fallback —
    # the counterpart of --no-map-open-cl-from-vaapi/--copy-vaapi-frames
    # selecting slower interop paths).
    r.add_argument("--warp-batch", type=int, default=None,
                   help="frames per warp dispatch (default 32)")
    r.add_argument("--prefetch-depth", type=int, default=3,
                   help="host->device frames in flight")
    r.add_argument("--no-native-io", dest="native_io", action="store_false",
                   help="use cv2/pure-python IO instead of the C++ "
                        "libav decoder/encoder")
    r.add_argument("--analysis-scale", type=_analysis_scale, default="auto",
                   choices=["auto", 1.0, 0.5, 0.25],
                   help="track motion on a downsampled pyramid level; "
                        "auto (default) = full resolution through "
                        "~1440p inputs, 0.5 for 4K-class (the reference "
                        "demo's own tracking scale), 0.25 for 8K")
    r.add_argument("--analysis-chunk", type=int, default=16,
                   help="paired mode: frames per batched analyse pass; "
                        "tracked mode runs frame by frame whatever the "
                        "chunk (identical trajectory either way)")
    r.add_argument("--analysis-mode", default="auto",
                   choices=["auto", "tracked", "paired"],
                   help="tracked = sequential point-carryover tracker "
                        "(reference-faithful); paired = fresh corners "
                        "every frame, all adjacent pairs batched into "
                        "one kernel launch per pyramid level (same "
                        "estimator and gates); auto (default) = paired "
                        "on a GPU, tracked on the CPU")
    r.add_argument("--analysis-detect-level", type=int, default=1,
                   help="paired mode: detect corners this many pyramid "
                        "levels below the tracking resolution (LK "
                        "re-validates every patch at track resolution; "
                        "0 = detect at track resolution — measured: "
                        "slower with no trajectory-RMS recovery, "
                        "benchmarks/quality.json; for trajectory "
                        "accuracy use --analysis-mode tracked)")
    r.add_argument("--analysis-iters", type=int, default=8,
                   help="LK Newton iterations per pyramid level "
                        "(cv2's eps criteria typically terminate in "
                        "fewer; ground-truth accuracy identical 8 vs 10)")
    r.add_argument("--preview", default=None, metavar="DIR",
                   help="dump every Nth final output frame as PNG into "
                        "DIR while rendering (the reference demo's live "
                        "imshow view, headless — DisplayImage.cpp:60-72)")
    r.add_argument("--preview-every", type=int, default=30)
    r.add_argument("--display", action="store_true",
                   help="show final output frames in a live GUI window "
                        "while rendering (the reference demo's imshow "
                        "loop, DisplayImage.cpp:60-72); falls back to a "
                        "warning + the --preview hint when no usable "
                        "GUI/display is present (ESC closes the window "
                        "without stopping the render)")
    # Inert reference-compatibility shims: existing video-annotator
    # scripts pass these (src/cli.ts:125-160); accept them with a note
    # instead of an argparse error so migration is drop-in.
    r.add_argument("--hw-accel", action=_CompatAction, nargs=1,
                   hint="decode runs on the host CPU feeding the GPU "
                        "(see --no-native-io / --prefetch-depth)",
                   help=argparse.SUPPRESS)
    r.add_argument("--vaapi-vendor", action=_CompatAction, nargs=1,
                   hint="no VAAPI device here", help=argparse.SUPPRESS)
    r.add_argument("--open-cl-platform", action=_CompatAction, nargs=1,
                   hint="kernels run on the GPU via CUDA",
                   help=argparse.SUPPRESS)
    r.add_argument("--no-map-open-cl-from-vaapi", action=_CompatAction,
                   nargs=0, hint="no OpenCL/VAAPI interop here",
                   help=argparse.SUPPRESS)
    r.add_argument("--copy-vaapi-frames", action=_CompatAction, nargs=0,
                   hint="frame-pool pressure is --prefetch-depth",
                   help=argparse.SUPPRESS)
    r.add_argument("--verbosity", action="store", default=None,
                   metavar="LEVEL",
                   help="ffmpeg-style log level (quiet..trace); levels "
                        "at info or chattier also print the per-stage "
                        "profiler report (the reference forwards this "
                        "to ffmpeg, src/cli.ts:177)")
    r.add_argument("--compare", type=str, default=None,
                   help="Comma-separated stabilise modes to tile side-by-side")
    r.add_argument("--no-cell-labels", dest="cell_labels",
                   action="store_false",
                   help="Don't burn each --compare cell's mode name into "
                        "its corner (the reference's grids are unlabeled)")
    r.add_argument("--debug", action="store_true",
                   help="Draw stabilization diagnostics into the output "
                        "(correction HUD + trajectory curves; the "
                        "reference's filter debug overlays) and raise "
                        "full tracebacks")
    r.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the CPU and CUDA "
                        "activity (view with Perfetto/TensorBoard) "
                        "alongside the per-stage wall-clock report")
    r.add_argument("-v", "--verbose", action="store_true",
                   help="Print the per-stage profiler report")
    _add_device(r)

    c = sub.add_parser("compare", help="Render a comparison grid of stabilizers")
    c.add_argument("source")
    c.add_argument("dest")
    c.add_argument("--compare", type=str, default="none,smooth",
                   help="Comma-separated stabilise modes")
    c.add_argument("--preset", default=None)
    c.add_argument("--stabilise-radius", type=int, default=90)
    c.add_argument("--no-cell-labels", dest="cell_labels", action="store_false",
                   help="Don't burn each cell's mode name into its corner")
    c.add_argument("-v", "--verbose", action="store_true")
    _add_device(c)

    wf = sub.add_parser("workflow",
                        help="Match workflow: stabilise/join/tag/split/encode (concat.sh)")
    wf.add_argument("action", choices=["stabilise", "join", "tag", "split", "encode"])
    wf.add_argument("code")
    wf.add_argument("--directory", default=".")
    wf.add_argument("--concurrency", type=int, default=1)
    wf.add_argument("--sets-json", default=None,
                    help="Non-interactive set list for 'tag'")
    wf.add_argument("--encoder", default=None)
    wf.add_argument("--render-args", default=None,
                    help="Extra args passed to each split render (space-separated)")
    _add_device(wf)

    pr = sub.add_parser("probe",
                        help="Inspect a source: stream metadata + GPMF telemetry "
                             "summary (the reference shells out to ffprobe, "
                             "src/utils.ts:3-11)")
    pr.add_argument("source")

    k = sub.add_parser(
        "calibrate",
        help="Fit fisheye intrinsics from calibration-target footage (the "
             "reference tool's workflow) or pre-extracted points",
    )
    k.add_argument("points", nargs="?", default=None,
                   help="video/image-list to detect a target in, or .npz "
                        "with object_points/image_points arrays (omit when "
                        "--settings provides Input)")
    k.add_argument("--settings", default=None,
                   help="reference-format XML/YAML settings file "
                        "(in_VID5.xml schema); runs the whole workflow and "
                        "writes Write_outputFileName")
    k.add_argument("--model", default="fisheye", choices=["fisheye", "rectilinear"])
    k.add_argument("--pattern", default="chessboard",
                   choices=["chessboard", "circles", "acircles"],
                   help="target type (camera_calibration.cpp:356-363)")
    k.add_argument("--size", default=None, help="WxH image size override")
    k.add_argument("--board", default="9x6",
                   help="inner-corner grid COLSxROWS (in_VID5.xml: 9x6)")
    k.add_argument("--square-size", type=float, default=1.0,
                   help="board square edge length (output units)")
    k.add_argument("--frames", type=int, default=25,
                   help="max board views to collect (in_VID5.xml: 25)")
    k.add_argument("--interval", type=float, default=0.25,
                   help="seconds between detection attempts")
    k.add_argument("--flip-vertical", action="store_true",
                   help="flip input frames around the horizontal axis "
                        "(Input_FlipAroundHorizontalAxis)")
    k.add_argument("-o", "--output", default=None,
                   help="intrinsics output: .json, or FileStorage "
                        ".xml/.yml/.yaml (saveCameraParams schema)")
    k.add_argument("--show-undistorted", metavar="DIR", default=None,
                   help="after fitting, undistort sampled input frames "
                        "through the fitted camera (this framework's own "
                        "warp, identity rotation) into DIR as PNGs — the "
                        "reference's Show_UndistortedImage view "
                        "(camera_calibration.cpp:707-720); also shown in "
                        "a window when a GUI is available")
    _add_device(k)
    return p


def _validated_crop(value):
    """``--crop``'s value, validated when the options are built. With
    ``nargs="?"`` a following positional can be taken as the value
    (``render --crop in.mp4 out.y4m``): failing here with the expected
    syntax beats decoding the wrong file or failing after a whole analyse.
    The fields are ffmpeg expressions (``in_w-200``, ``min(iw,ih)``), so
    each is parsed, not matched against a numeric pattern; their values
    are checked at render time against the frame's size."""
    if value is None or value is True:
        return None
    from video_annotator_tpu_torch.pipeline.render import validate_crop_spec

    try:
        validate_crop_spec(value)
    except ValueError as e:
        raise SystemExit(
            f"--crop value {value!r} is not W:H[:X:Y] (ffmpeg crop-filter "
            f"syntax, expressions allowed): {e}; for the bare border-crop "
            "flag, put --crop after the source/dest paths")
    return value


def _verbosity_implies_report(args) -> bool:
    """-v, or an ffmpeg-style --verbosity at info (32) or chattier, named
    or numeric (the two forms ffmpeg's -loglevel takes)."""
    if getattr(args, "verbose", False):
        return True
    level = str(getattr(args, "verbosity", None) or "").lower()
    return level in ("info", "verbose", "debug", "trace") or (
        level.isdigit() and int(level) >= 32)


def _render_options(args):
    """The ``RenderOptions`` of a ``render`` or ``compare`` command line;
    ``compare`` lacks most of the options and takes their defaults."""
    from video_annotator_tpu_torch.camera import CameraPreset
    from video_annotator_tpu_torch.io.video import default_encoder
    from video_annotator_tpu_torch.pipeline.render import RenderOptions

    def arg(name, default=None):
        return getattr(args, name, default)

    crop = arg("crop")
    return RenderOptions(
        filter=arg("filter", "rotation"),
        start=_parse_time(arg("start")),
        duration=_parse_time(arg("duration")),
        end=_parse_time(arg("end")),
        width=arg("width"),
        height=arg("height"),
        scale=arg("scale", 1.0),
        crop_borders=crop is True,
        crop_rect=_validated_crop(crop),
        upsample=arg("upsample", 0.0),
        roll=arg("roll", 0.0),
        pitch=arg("pitch", 0.0),
        yaw=arg("yaw", 0.0),
        stabilise=args.stabilise,
        smoother=arg("smoother", "savgol"),
        stabilise_radius=args.stabilise_radius,
        interpolate_radius=arg("interpolate_radius", 30),
        stabilise_buffer=arg("stabilise_buffer", 20.0),
        input_dfov=arg("input_dfov", 145.8),
        output_dfov=arg("output_dfov"),
        projection=arg("projection", "rect"),
        preset=CameraPreset(args.preset.lower()) if args.preset else None,
        gyro=arg("gyro", False),
        horizon_lock=arg("horizon_lock", False),
        rolling_shutter=arg("rolling_shutter", 0.0),
        streaming=arg("streaming", False),
        analyse_only=arg("analyse_only", False),
        encode_only=arg("encode_only", False),
        no_output=arg("no_output", False),
        encoder=arg("encoder") or default_encoder(),
        frame_rate=arg("frame_rate"),
        warp_batch=arg("warp_batch"),
        prefetch_depth=arg("prefetch_depth", 3),
        native_io=arg("native_io", True),
        analysis_scale=arg("analysis_scale", "auto"),
        analysis_chunk=arg("analysis_chunk", 16),
        analysis_mode=arg("analysis_mode", "auto"),
        analysis_detect_level=arg("analysis_detect_level", 1),
        analysis_iters=arg("analysis_iters", 8),
        preview=arg("preview"),
        preview_every=arg("preview_every", 30),
        display=arg("display", False),
        max_correction_deg=arg("max_correction", 8.0),
        prefilter=arg("prefilter", "off"),
        interp=arg("interp", "bilinear"),
        debug=arg("debug", False),
        cell_labels=arg("cell_labels", True),
        verbose=_verbosity_implies_report(args),
    )


def probe(source: str) -> dict:
    """Source metadata as a JSON-friendly dict: the video stream's size,
    rate and frame count, the container's tracks and a summary of its
    GPMF telemetry (the reference shells out to ffprobe,
    ``src/utils.ts:3-11``). Raises ``ValueError`` when none of the three
    can be read. Host IO only."""
    from video_annotator_tpu_torch.io.video import open_reader

    out = {"source": source, "video": None}
    reader = None
    try:
        reader = open_reader(source)
        meta = reader.meta
        out["video"] = {
            "width": meta.width,
            "height": meta.height,
            "fps": float(meta.fps),
            "num_frames": meta.num_frames,
            "duration_s": (round(meta.num_frames / float(meta.fps), 3)
                           if meta.num_frames and meta.fps else None),
        }
    except Exception:
        pass  # a telemetry-only or unreadable container: the tracks may parse
    finally:
        if reader is not None:
            reader.close()
    try:
        from video_annotator_tpu_torch.io.mp4 import parse_tracks

        out["tracks"] = [
            {"handler": t.handler_type.decode("ascii", "replace"),
             "name": (t.handler_name or "").strip("\x00\t "),
             "samples": len(t.sample_sizes)}
            for t in parse_tracks(source)
        ]
    except Exception:
        out["tracks"] = None  # not ISO-BMFF (y4m, synthetic, raw)
    telemetry = {}
    try:
        from video_annotator_tpu_torch.io.gpmf import extract_imu

        for name, stream in extract_imu(source).items():
            if stream is None:
                continue
            vals, ts = stream
            span = float(ts[-1] - ts[0]) if len(ts) > 1 else 0.0
            telemetry[name.decode().lower()] = {
                "samples": int(vals.shape[0]),
                "rate_hz": round((len(ts) - 1) / span, 1) if span else None,
            }
    except Exception:
        pass
    out["gpmf"] = telemetry or None
    if out["video"] is None and out["tracks"] is None and out["gpmf"] is None:
        raise ValueError(f"unreadable source: {source}")
    return out


def _device(args) -> str:
    """The ``--device`` asked for; ``cuda`` without a card is an error,
    never a quiet move to the CPU."""
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the torch package's CLI runs on a GPU unless "
            "asked for the CPU with --device cpu")
    return args.device


def _trace(trace_dir):
    """``--trace DIR``: a torch.profiler session over the render, with the
    CPU and CUDA activity this build of torch can record on every thread
    (the feed's and the writer's too, where torch has
    ``profile_all_threads``), that writes a Chrome trace
    (``*.pt.trace.json``) into ``DIR`` when it closes."""
    import torch

    try:
        config = {"experimental_config": torch.profiler._ExperimentalConfig(
            profile_all_threads=True)}
    except TypeError:  # an older torch records the calling thread alone
        config = {}
    return torch.profiler.profile(
        activities=sorted(torch.profiler.supported_activities(), key=str),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(trace_dir), **config)


def _render(args):
    import contextlib

    options = _render_options(args)  # a malformed --crop stops before the card is asked
    device = _device(args)
    # Under --trace the render's stages are ranges of the trace, on their threads.
    kw = {}
    if args.trace:
        from video_annotator_tpu_torch.pipeline.profiler import RecordFunctionProfiler

        kw["profiler"] = RecordFunctionProfiler()
    with _trace(args.trace) if args.trace else contextlib.nullcontext():
        if args.compare:
            from video_annotator_tpu_torch.pipeline.compare import render_compare

            modes = [m.strip() for m in args.compare.split(",") if m.strip()]
            render_compare(args.source, args.dest, modes, options, device=device, **kw)
        else:
            from video_annotator_tpu_torch.pipeline.render import render

            render(args.source, args.dest, options, device=device, **kw)
    if args.trace:
        print(f"device trace written to {args.trace}")


def _workflow(args):
    from video_annotator_tpu_torch import workflow

    if args.action == "join":
        from video_annotator_tpu_torch.io.gopro import join

        join(args.code, f"{args.directory}/match_{args.code}.mp4", directory=args.directory)
    elif args.action == "tag":
        workflow.tag(args.code, args.directory, args.sets_json)
    elif args.action == "stabilise":
        workflow.stabilise(args.code, args.directory, args.concurrency,
                           device=_device(args))
    elif args.action == "split":
        # Each set renders in a child process of this CLI, which checks
        # for the card itself (--device, if any, is in --render-args).
        workflow.split(args.code, args.directory, args.concurrency,
                       args.render_args.split() if args.render_args else None)
    else:
        from video_annotator_tpu_torch.io.video import default_encoder

        workflow.encode(args.code, args.directory, args.encoder or default_encoder())


def _calibrate(args):
    from video_annotator_tpu_torch.calibrate import calibrate_cli

    if args.points is None and not args.settings:
        raise ValueError("calibrate needs a points/video path or --settings")
    calibrate_cli(args.points, args.model, args.size, args.output,
                  board=args.board, square_size=args.square_size,
                  max_views=args.frames, interval_s=args.interval,
                  pattern=args.pattern, settings=args.settings,
                  flip_vertical=args.flip_vertical,
                  show_undistorted_dir=args.show_undistorted,
                  device=_device(args))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.command == "join":
            from video_annotator_tpu_torch.io.gopro import join

            join(args.code, args.output, directory=args.directory)
        elif args.command == "render":
            _render(args)
        elif args.command == "compare":
            from video_annotator_tpu_torch.pipeline.compare import render_compare

            args.stabilise = "none"
            options = _render_options(args)
            device = _device(args)
            modes = [m.strip() for m in args.compare.split(",") if m.strip()]
            render_compare(args.source, args.dest, modes, options, device=device)
        elif args.command == "workflow":
            _workflow(args)
        elif args.command == "calibrate":
            _calibrate(args)
        else:
            import json

            print(json.dumps(probe(args.source), indent=2))
        return 0
    except Exception as e:  # the CLI exits 1 on pipeline errors
        if getattr(args, "debug", False):
            raise
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
