"""The readers of the two-phase render's phase spans (``phase-analyse``,
``phase-encode``) on a hand-built device trace: the card's busy time inside
each phase, counted once, and the phases' stage seconds; nothing where the
program opens no phase span, as a parent without them does not."""

from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.trace import DeviceTrace

CARD = ("analyse_phase_card_ms_per_frame", "encode_phase_card_ms_per_frame")
HOST = ("analyse_phase_ms_per_frame", "encode_phase_ms_per_frame")
MS = 1_000_000  # ns


def ctx(events, spans, stages=None, frames=(100, 100), w1=100 * MS):
    return SimpleNamespace(trace=DeviceTrace(events, 0, w1, spans), stages=stages or {},
                           summaries=[{"frames": n} for n in frames])


def read(name, c):
    return harness.reader(name)(c)


# Two jobs, each an analyse then an encode, tiling the window; an ``open``
# inside each phase, as the program's are.
TILED = [("phase-analyse", 0, 20 * MS), ("open", 1 * MS, 2 * MS),
         ("phase-encode", 20 * MS, 50 * MS), ("open", 21 * MS, 22 * MS),
         ("phase-analyse", 50 * MS, 70 * MS), ("phase-encode", 70 * MS, 100 * MS)]


def test_busy_time_inside_a_phase_is_counted_once():
    # Overlapping kernel and copy in the analyse, one event across an
    # ``open`` nested in the phase: the union, once.
    events = [("k", 2 * MS, 6 * MS), ("Memcpy HtoD", 4 * MS, 8 * MS),
              ("warp_kernel<1,", 30 * MS, 32 * MS), ("Memcpy DtoH", 31 * MS, 34 * MS)]
    c = ctx(events, TILED)
    assert read("analyse_phase_card_ms_per_frame", c) == pytest.approx(6.0 / 200)
    assert read("encode_phase_card_ms_per_frame", c) == pytest.approx(4.0 / 200)


def test_an_event_across_a_phase_edge_is_split_between_the_phases():
    c = ctx([("k", 18 * MS, 23 * MS)], TILED)
    assert read("analyse_phase_card_ms_per_frame", c) == pytest.approx(2.0 / 200)
    assert read("encode_phase_card_ms_per_frame", c) == pytest.approx(3.0 / 200)


def test_activity_outside_both_phases_counts_in_neither():
    spans = [("phase-analyse", 10 * MS, 20 * MS), ("phase-encode", 30 * MS, 40 * MS),
             ("decode", 0, 100 * MS)]
    events = [("k", 0, 10 * MS), ("k", 20 * MS, 30 * MS), ("k", 40 * MS, 100 * MS),
              ("k", 15 * MS, 16 * MS), ("k", 35 * MS, 37 * MS)]
    c = ctx(events, spans)
    assert read("analyse_phase_card_ms_per_frame", c) == pytest.approx(1.0 / 200)
    assert read("encode_phase_card_ms_per_frame", c) == pytest.approx(2.0 / 200)


def test_tiled_phases_add_up_to_card_ms_per_frame():
    import random

    rng = random.Random(20)
    events = []
    for _ in range(400):
        s = rng.randrange(0, 100 * MS)
        events.append(("k", s, s + rng.randrange(1, MS)))
    c = ctx(events, TILED)
    total = read("card_ms_per_frame", c)
    assert total > 0
    assert sum(read(n, c) for n in CARD) == pytest.approx(total, rel=1e-12)


@pytest.mark.parametrize("name", CARD)
def test_card_readers_find_nothing_without_phase_spans(name):
    events = [("k", 0, 10 * MS)]
    assert read(name, ctx(events, [])) is None
    # A program without the phase spans (the parent's): other stages only.
    assert read(name, ctx(events, [("open", 0, 5 * MS), ("encode", 5 * MS, 9 * MS)])) is None
    # No trace (``--trace 0``), no frames, no device activity.
    assert read(name, SimpleNamespace(trace=None, summaries=[{"frames": 10}])) is None
    assert read(name, ctx(events, TILED, frames=())) is None
    assert read(name, ctx([], TILED)) is None


@pytest.mark.parametrize("name", HOST)
def test_host_readers_find_nothing_without_phase_stages(name):
    old = {"open": (0.2, 4), "track": (3.0, 40), "encode": (2.5, 32)}
    assert read(name, ctx([], [], stages=old)) is None
    assert read(name, ctx([], [], stages={})) is None


@pytest.mark.parametrize("name,stage", zip(HOST, ("phase-analyse", "phase-encode")))
def test_host_readers_are_stage_seconds_per_frame_received(name, stage):
    stages = {stage: (1.6, 2), "open": (0.2, 4)}
    assert read(name, ctx([], [], stages=stages)) == pytest.approx(1e3 * 1.6 / 200)
    assert read(name, ctx([], [], stages=stages, frames=())) is None


def test_phase_readers_are_listed_for_the_render_cell_only():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in CARD + HOST:
        m = entries[name]
        assert (m["better"], m["unit"], m["moves"], m["workloads"]) == (
            "lower", "ms", "card_ms_per_frame", ["h4b_4k30.render"])
        assert m["source"] == ("device_trace" if name in CARD else "program_span")
    render = {m["name"] for m in harness.cell_plan(bench, "h4b_4k30.render").per_layer}
    streaming = {m["name"] for m in harness.cell_plan(bench, "h4b_1440p60.streaming").per_layer}
    assert set(CARD + HOST) <= render and not set(CARD + HOST) & streaming
