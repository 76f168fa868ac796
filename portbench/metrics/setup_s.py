"""setup_s: process start to the window's start: imports, the kernels'
load (their build in a fresh checkout), the clip rendered and written,
the collector started and one warm-up job."""


def read(ctx):
    return ctx.setup_s
