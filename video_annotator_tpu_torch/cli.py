"""Command-line interface of the PyTorch/CUDA port.

The ``render`` subcommand has the JAX package's full option set (the
frozen v1.0 surface: same option strings, defaults and choices) and runs
the ported paths on a CUDA device: the rotation family (two-phase or
``--streaming``), ``--filter vidstab`` and ``--filter deshake``, and the
``--compare`` grid, each with ``--interp``, and the rotation family with
``--projection`` and ``--prefilter``. Options outside the ported slices stop with
``NotImplementedError`` naming their ROADMAP item. The other subcommands
of the JAX CLI (join, compare, workflow, probe, calibrate) exist and exit
non-zero as not yet ported.

Usage::

    python -m video_annotator_tpu_torch render in.y4m out.y4m --stabilise smooth
    python -m video_annotator_tpu_torch render in.y4m out.y4m --filter vidstab --stabilise smooth
    python -m video_annotator_tpu_torch render in.y4m grid.y4m --compare none,smooth,vidstab,deshake
"""

from __future__ import annotations

import argparse
import sys

_NOT_PORTED = ("join", "compare", "workflow", "probe", "calibrate")


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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="video-annotator-tpu-torch",
        description="Action-camera stabilization & reprojection on a CUDA GPU",
    )
    sub = p.add_subparsers(dest="command", required=True)
    for name in _NOT_PORTED:
        s = sub.add_parser(name, help="not yet ported (ROADMAP.md)")
        s.add_argument("args", nargs=argparse.REMAINDER)

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
                   help="not ported yet (device traces: ROADMAP.md)")
    r.add_argument("-v", "--verbose", action="store_true",
                   help="Print the per-stage profiler report")
    return p


def _render_options(args):
    from video_annotator_tpu_torch.camera import CameraPreset
    from video_annotator_tpu_torch.io.video import default_encoder
    from video_annotator_tpu_torch.pipeline.render import RenderOptions

    verbosity = str(args.verbosity or "").lower()
    verbose = args.verbose or verbosity in ("info", "verbose", "debug", "trace") \
        or (verbosity.isdigit() and int(verbosity) >= 32)
    return RenderOptions(
        filter=args.filter,
        start=_parse_time(args.start),
        duration=_parse_time(args.duration),
        end=_parse_time(args.end),
        width=args.width,
        height=args.height,
        scale=args.scale,
        crop_borders=args.crop is True,
        crop_rect=args.crop if isinstance(args.crop, str) else None,
        upsample=args.upsample,
        roll=args.roll,
        pitch=args.pitch,
        yaw=args.yaw,
        stabilise=args.stabilise,
        smoother=args.smoother,
        stabilise_radius=args.stabilise_radius,
        interpolate_radius=args.interpolate_radius,
        stabilise_buffer=args.stabilise_buffer,
        input_dfov=args.input_dfov,
        output_dfov=args.output_dfov,
        projection=args.projection,
        preset=CameraPreset(args.preset.lower()) if args.preset else None,
        gyro=args.gyro,
        horizon_lock=args.horizon_lock,
        rolling_shutter=args.rolling_shutter,
        streaming=args.streaming,
        analyse_only=args.analyse_only,
        encode_only=args.encode_only,
        no_output=args.no_output,
        encoder=args.encoder or default_encoder(),
        frame_rate=args.frame_rate,
        warp_batch=args.warp_batch,
        prefetch_depth=args.prefetch_depth,
        native_io=args.native_io,
        analysis_scale=args.analysis_scale,
        analysis_chunk=args.analysis_chunk,
        analysis_mode=args.analysis_mode,
        analysis_detect_level=args.analysis_detect_level,
        analysis_iters=args.analysis_iters,
        preview=args.preview,
        preview_every=args.preview_every,
        display=args.display,
        max_correction_deg=args.max_correction,
        prefilter=args.prefilter,
        interp=args.interp,
        debug=args.debug,
        cell_labels=args.cell_labels,
        verbose=verbose,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command != "render":
        print(f"error: {args.command} is not yet ported to the torch package "
              "(ROADMAP.md)", file=sys.stderr)
        return 2
    try:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the torch package's CLI renders on a GPU "
                "(library calls take device='cpu' for testing)")
        if args.trace:
            raise NotImplementedError(
                "--trace is not ported to the torch package yet (ROADMAP.md)")
        if args.compare:
            from video_annotator_tpu_torch.pipeline.compare import render_compare

            modes = [m.strip() for m in args.compare.split(",") if m.strip()]
            render_compare(args.source, args.dest, modes, _render_options(args),
                           device="cuda")
            return 0
        from video_annotator_tpu_torch.pipeline.render import render

        render(args.source, args.dest, _render_options(args), device="cuda")
        return 0
    except Exception as e:  # the CLI exits 1 on pipeline errors
        if args.debug:
            raise
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
