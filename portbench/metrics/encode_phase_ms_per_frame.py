"""encode_phase_ms_per_frame: the program's ``phase-encode`` stage seconds
(the two-phase render's encode: its open, the second decode, the warp and
the handoff to the writer, and the writer's close, on the render thread)
over the frames the collector received, in the window. None where the
program has no such stage."""


def read(ctx):
    frames = sum(s["frames"] for s in ctx.summaries)
    sec, _ = ctx.stages.get("phase-encode", (0.0, 0))
    return 1e3 * sec / frames if frames and sec else None
