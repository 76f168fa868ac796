"""decode_ms_per_frame: the program's ``decode`` stage seconds (each pull
from the y4m reader, on the prefetcher's thread) over the pulls, in the
window. The layer of ``io/video.py``, ``io/y4m.py`` and
``io/prefetch.py::DevicePrefetcher``."""


def read(ctx):
    sec, calls = ctx.stages.get("decode", (0.0, 0))
    return 1e3 * sec / calls if calls else None
