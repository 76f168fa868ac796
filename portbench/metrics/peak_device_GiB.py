"""peak_device_GiB: ``torch.cuda.max_memory_allocated()`` over the traced
window, after ``reset_peak_memory_stats()`` at its start."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.trace is not None and ctx.peak_bytes else None
