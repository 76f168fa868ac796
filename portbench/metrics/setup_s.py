"""setup_s: the program's set-up, from the harness's first line to the
window's start: the imports, the CUDA context, the kernels' load (their
build in a fresh checkout), the render's options and one warm-up job over
the whole clip. The benchmark's own work, the collector's start, the clip
rendered on the card and written and the truth file, is done inside that
time and left out of it, and the profiler starts after it
(``harness.run_cell``)."""


def read(ctx):
    return ctx.setup_s
