"""upload_ms_per_frame: the program's ``upload`` stage seconds (on
``DevicePrefetcher``'s thread, each decoded frame's copy into a pinned
slot, the wait for that slot's last copy and the copy's enqueue) over its
calls, in the window. None where the program has no such stage."""


def read(ctx):
    sec, calls = ctx.stages.get("upload", (0.0, 0))
    return 1e3 * sec / calls if calls else None
