"""analyse_phase_card_ms_per_frame: the card's busy time inside the
program's ``phase-analyse`` spans (the two-phase render's first decode,
the paired analyse and the trajectory's save, on the render thread): the
union of the device's activity intervals that lies inside those spans,
over the frames the collector received from the window's jobs. With
``encode_phase_card_ms_per_frame`` it splits ``card_ms_per_frame``. None
where the program opens no such span."""

from portbench.metrics.encode_phase_card_ms_per_frame import busy_ms_per_frame_in


def read(ctx):
    return busy_ms_per_frame_in(ctx, "phase-analyse")
