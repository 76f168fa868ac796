"""BENCHMARK.json, the configurations, the mixes and the metric readers."""

import json
import re

import pytest

from portbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_parses_and_agrees_with_its_command_line(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    cfg = harness.load_json(harness.ROOT / config["file"])
    assert cfg["name"] == config["name"]
    opts = harness.render_options(["clip.y4m", "out.y4m", *cfg["render_args"]])
    assert opts.preset.value == cfg["preset"]
    assert opts.stabilise == "smooth"
    assert opts.stabilise_radius == cfg["stabilise_radius"]
    assert opts.stabilise_buffer == cfg["stabilise_buffer_percent"]
    assert opts.warp_batch == cfg["warp_batch"]
    assert set(cfg["limits"]) >= {"jobs_failed", "frames_missing", "traj_frames_missing",
                                  "frame_max_diff", "traj_rms_deg", "traj_max_deg"}
    for key in config["reduced"]:
        assert key in cfg["reduced_from_source"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_finds_its_files_and_metrics(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and cell["chips"] == 1 and len(cell["why"]) <= 200
    plan = harness.cell_plan(BENCH, cell["name"])
    mix = plan.mix
    assert set(mix) >= {"render_args", "frames_out", "analyses", "trajectory_input",
                        "sample_frames_per_job"}
    harness.render_options(["clip.y4m", "out.y4m", *plan.cfg["render_args"], *mix["render_args"]])
    names = [m["name"] for m in plan.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert plan.per_layer
    for m in plan.end_to_end + plan.per_layer:
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        for cell in metric["workloads"]:
            plan = harness.cell_plan(BENCH, cell)
            assert metric["moves"] in [m["name"] for m in plan.end_to_end]
    harness.reader(metric["name"])


@pytest.mark.parametrize("path", sorted((harness.HERE / "mixes").glob("*.json"))
                         + sorted((harness.HERE / "configs").glob("*.json")), ids=lambda p: p.name)
def test_every_data_file_parses(path):
    data = json.loads(path.read_text())
    if path.parent.name == "mixes":
        harness.render_options(["clip.y4m", "out.y4m", *data["render_args"]])
    else:
        assert data["name"] == path.stem and data["preset"] in data["render_args"]


def test_reader_missing_raises():
    with pytest.raises(FileNotFoundError):
        harness.reader("no_such_metric.render")
