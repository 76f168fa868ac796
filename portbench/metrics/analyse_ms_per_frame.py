"""analyse_ms_per_frame: the program's ``track`` and ``collect`` stage
seconds over the frames the window's trajectories hold: the paired
analyse (corners, K3, K2, RANSAC, the chaining), ``collect`` ending in the
host copy that waits for the device."""


def read(ctx):
    sec = sum(ctx.stages.get(s, (0.0, 0))[0] for s in ("track", "collect"))
    return 1e3 * sec / ctx.frames_analysed if ctx.frames_analysed and sec else None
