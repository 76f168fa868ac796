"""The readers of the program's thread-level stages (``readback``, ``sink``,
``upload``, ``feed-wait``, ``open``) on a made-up window: nothing where
the program has no such stage, as a parent without them has not, and the
arithmetic where it has."""

from types import SimpleNamespace

import pytest

from portbench import harness

READERS = ("readback_ms_per_frame", "sink_ms_per_frame", "upload_ms_per_frame",
           "feed_wait_ms_per_frame", "job_open_ms")


def ctx(stages, frames=(240, 240)):
    return SimpleNamespace(stages=stages, summaries=[{"frames": n} for n in frames])


OLD_STAGES = {"decode": (1.2, 482), "track": (3.0, 120), "smooth": (0.5, 15),
              "warp": (0.1, 15), "encode": (2.5, 32)}


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_in_a_program_without_the_stage(name):
    assert harness.reader(name)(ctx(dict(OLD_STAGES))) is None
    assert harness.reader(name)(ctx({})) is None


@pytest.mark.parametrize("name,stages,want", [
    # Per frame the collector received (two jobs of 240), not per call.
    ("readback_ms_per_frame", {"readback": (1.44, 500)}, 3.0),
    ("sink_ms_per_frame", {"sink": (0.96, 480)}, 2.0),
    # Per call.
    ("upload_ms_per_frame", {"upload": (0.48, 480)}, 1.0),
    ("feed_wait_ms_per_frame", {"feed-wait": (0.241, 482)}, 0.5),
    ("job_open_ms", {"open": (0.3, 2)}, 150.0),
])
def test_reader_arithmetic(name, stages, want):
    assert harness.reader(name)(ctx(dict(OLD_STAGES, **stages))) == pytest.approx(want)


@pytest.mark.parametrize("name", ["readback_ms_per_frame", "sink_ms_per_frame"])
def test_per_frame_readers_need_frames(name):
    stage = name.split("_")[0]
    assert harness.reader(name)(ctx({stage: (1.0, 10)}, frames=())) is None


def test_each_reader_is_listed_for_the_streaming_cell():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert (m["source"], m["better"], m["moves"], m["workloads"]) == (
            "program_span", "lower", "card_ms_per_frame", ["h4b_1440p60.streaming"])
    plan = harness.cell_plan(bench, "h4b_1440p60.streaming")
    assert set(READERS) <= {m["name"] for m in plan.per_layer}
