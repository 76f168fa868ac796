"""render_fps (per layer as ``render_fps.window``): output frames the collector received from the window's
jobs, over the window (the first job's start to the end of the first job
that ends after ``--seconds``). Whole jobs over the whole time, so a stall
counts."""


def read(ctx):
    frames = sum(s["frames"] for s in ctx.summaries)
    return frames / ctx.window_s if frames else None
