"""encode_phase_card_ms_per_frame: the card's busy time inside the
program's ``phase-encode`` spans (the two-phase render's second decode,
the corrections, K1 and the write, on the render thread): the union of
the device's activity intervals that lies inside those spans, over the
frames the collector received from the window's jobs. With
``analyse_phase_card_ms_per_frame`` it splits ``card_ms_per_frame``. None
where the program opens no such span."""

from portbench.trace import _union


def busy_ms_per_frame_in(ctx, stage: str):
    """The trace's busy intervals intersected with the union of ``stage``'s
    spans, in ms, over the frames received."""
    t = ctx.trace
    frames = sum(s["frames"] for s in ctx.summaries)
    if t is None or not t.events or not frames:
        return None
    spans = _union(sorted((s, e) for name, s, e in t.spans if name == stage))
    if not spans:
        return None
    ns, i = 0, 0
    for s, e in t.busy:  # both sorted and disjoint: one sweep
        while i < len(spans) and spans[i][1] <= s:
            i += 1
        j = i
        while j < len(spans) and spans[j][0] < e:
            ns += min(e, spans[j][1]) - max(s, spans[j][0])
            j += 1
    return 1e-6 * ns / frames


def read(ctx):
    return busy_ms_per_frame_in(ctx, "phase-encode")
