"""readback_ms_per_frame: the program's ``readback`` stage seconds (on
``AsyncFrameWriter``'s thread, each output frame's copy to host memory,
which first waits for the warp that made it) over the frames the
collector received, in the window. None where the program has no such
stage."""


def read(ctx):
    frames = sum(s["frames"] for s in ctx.summaries)
    sec, _ = ctx.stages.get("readback", (0.0, 0))
    return 1e3 * sec / frames if frames and sec else None
