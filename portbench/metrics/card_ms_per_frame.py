"""card_ms_per_frame: the card's busy time per output frame: the union of
the device's activity intervals in the traced window (kernels, copies,
sets; ``portbench/trace.py``) over the frames the collector received from
the window's jobs. The card time a frame costs, whatever the host's speed:
what a card shared by several renders can serve."""


def read(ctx):
    t = ctx.trace
    frames = sum(s["frames"] for s in ctx.summaries)
    if t is None or not t.events or not frames:
        return None
    return 1000.0 * t.busy_s / frames
