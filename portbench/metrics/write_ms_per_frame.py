"""write_ms_per_frame: the program's ``encode`` stage seconds (handing each
warped frame to ``AsyncFrameWriter``, which waits while the writer thread
reads frames back and writes them to the y4m sink, and the writer's close)
over the frames the collector received, in the window."""


def read(ctx):
    frames = sum(s["frames"] for s in ctx.summaries)
    sec, _ = ctx.stages.get("encode", (0.0, 0))
    return 1e3 * sec / frames if frames and sec else None
