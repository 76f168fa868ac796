"""The HERO4 Black 4K30 Wide deployment (``portbench/configs/h4b_4k30.json``)
through the stock two-phase render, held to the benchmark's plain reference
on the CPU.

A small 16:9 copy of the configuration (768x432, 24 frames; every other
setting as the cell runs it) goes through ``portbench.harness.run_cell``
with the ``render`` mix: one analyse-then-encode job of the program, then
the comparison that decides the cell's ``correct``. The analysis runs at
``--analysis-scale 0.5``, pyramid level 1, as ``auto`` resolves for a 4K
source (at this size ``auto`` would track at full resolution), and paired,
as on the card: it tracks at 384x216. (At 512x288 it tracks at 256x144,
where one seed of four read 0.033 deg RMS against the 0.016 that the
limits set for tracking at 1920x1080.) The bfloat16 control
(``portbench/readings.py``) has to fail the same limits."""

import copy
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, readings  # noqa: E402
from video_annotator_tpu_torch.pipeline import render as trender  # noqa: E402

SEED = 2**31 + 2020


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_plan():
    plan = harness.cell_plan(harness.load_json(ROOT / "BENCHMARK.json"), "h4b_4k30.render")
    plan.cfg = copy.deepcopy(plan.cfg)
    args = plan.cfg["render_args"]
    args[args.index("--analysis-scale") + 1] = "0.5"
    args += ["--analysis-mode", "paired"]
    plan.cfg.update(width=768, height=432, frames=24)
    return plan


def test_the_cell_is_the_two_phase_render_of_the_4k_configuration():
    plan = harness.cell_plan(harness.load_json(ROOT / "BENCHMARK.json"), "h4b_4k30.render")
    assert plan.chips == 1 and plan.mix["render_args"] == []
    assert (plan.cfg["width"], plan.cfg["height"], plan.cfg["frames"]) == (3840, 2160, 192)
    opts = harness.render_options(["clip.y4m", "out.y4m", *plan.cfg["render_args"]])
    meta = trender.VideoMeta(width=3840, height=2160, fps=plan.cfg["fps_num"] / plan.cfg["fps_den"],
                             num_frames=192)
    assert not opts.streaming and trender.analysis_level(opts, meta) == 1
    assert [m["name"] for m in plan.end_to_end] == ["card_ms_per_frame", "setup_s"]


def test_level_one_render_holds_the_limits_and_the_bfloat16_control_fails(monkeypatch):
    plan = small_plan()
    levels = []
    mip_camera = trender.mip_camera
    monkeypatch.setattr(trender, "mip_camera",
                        lambda cam, level: levels.append(level) or mip_camera(cam, level))
    out = harness.run_cell(plan, SEED, 0.0, False, "cpu", time.monotonic(), warmup=False)
    limits = plan.cfg["limits"]
    assert out["attempted"] == 1 and out["failed"] == 0
    assert set(out["checks"]) == set(limits)
    for name, (value, limit) in out["checks"].items():
        assert value <= limit, (name, value, limit)
    assert levels == [1]  # the paired analyse's camera, at pyramid level 1
    control = readings.control_readings(plan, SEED, "cpu")
    assert any(v > limits[k] for k, v in control.items()), control
