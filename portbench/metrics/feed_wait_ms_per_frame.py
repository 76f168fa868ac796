"""feed_wait_ms_per_frame: the program's ``feed-wait`` stage seconds (the
render's thread blocked on ``DevicePrefetcher``'s queue for its next
frame, one call a frame and one a job for the end of the stream) over its
calls, in the window. None where the program has no such stage."""


def read(ctx):
    sec, calls = ctx.stages.get("feed-wait", (0.0, 0))
    return 1e3 * sec / calls if calls else None
