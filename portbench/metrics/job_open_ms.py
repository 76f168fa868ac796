"""job_open_ms: the program's ``open`` stage seconds (a phase's set-up, from
opening the source to the first pull of its loop: the trackers, the
cameras, the warper, the sink's open, which waits for the collector to
open the FIFO, and the feed's start) over its calls, in the window. None
where the program has no such stage."""


def read(ctx):
    sec, calls = ctx.stages.get("open", (0.0, 0))
    return 1e3 * sec / calls if calls else None
