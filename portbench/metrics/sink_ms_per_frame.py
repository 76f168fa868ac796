"""sink_ms_per_frame: the program's ``sink`` stage seconds (on
``AsyncFrameWriter``'s thread, each output frame handed to the y4m sink
and written into the collector's FIFO) over the frames the collector
received, in the window. None where the program has no such stage."""


def read(ctx):
    frames = sum(s["frames"] for s in ctx.summaries)
    sec, _ = ctx.stages.get("sink", (0.0, 0))
    return 1e3 * sec / frames if frames and sec else None
