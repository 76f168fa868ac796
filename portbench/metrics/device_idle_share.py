"""device_idle_share: the share of the traced window in which no kernel,
copy or set ran on the card (100 minus the union of the device's activity
intervals over the window)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.events:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
