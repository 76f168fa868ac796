"""analyse_fps: frames in the trajectories the window's jobs wrote, over
the window."""


def read(ctx):
    return ctx.frames_analysed / ctx.window_s if ctx.frames_analysed else None
