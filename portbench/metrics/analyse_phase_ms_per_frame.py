"""analyse_phase_ms_per_frame: the program's ``phase-analyse`` stage
seconds (the two-phase render's analyse and the trajectory's save, on the
render thread) over the frames the collector received, in the window.
None where the program has no such stage."""


def read(ctx):
    frames = sum(s["frames"] for s in ctx.summaries)
    sec, _ = ctx.stages.get("phase-analyse", (0.0, 0))
    return 1e3 * sec / frames if frames and sec else None
