"""Set-up: ``setup_s`` holds the program's set-up and not the benchmark's own
inputs, and the warm-up job is a whole job, on the CPU at a small size."""

import time

import pytest
from conftest import CELLS, small_plan

from portbench import generator, harness, trajfile

SLEEP = 3.0


def setup_s(plan, seed: int, warmup: bool = True) -> float:
    out = harness.run_cell(plan, seed, 0.0, False, "cpu", time.monotonic(), warmup=warmup)
    assert out["failed"] == 0
    return out["metrics"]["setup_s"]["value"]


@pytest.mark.parametrize("owner, name", [(generator.Clip, "write_y4m"),
                                         (harness.Collector, "__init__")])
def test_slow_benchmark_inputs_leave_setup_s_unchanged(owner, name, monkeypatch, few_threads):
    """The clip's render and write, and the collector's start, are the
    benchmark's own work: slowed by seconds, they leave ``setup_s`` as it
    was."""
    plan = small_plan("h4b_1440p60.streaming")
    setup_s(plan, 2**31 + 41, warmup=False)  # the process's first job, off the record
    real = getattr(owner, name)

    def slow(*args, **kwargs):
        time.sleep(SLEEP)
        return real(*args, **kwargs)

    monkeypatch.setattr(owner, name, slow)
    t = time.monotonic()
    slowed = setup_s(plan, 2**31 + 42)
    assert time.monotonic() - t > SLEEP
    monkeypatch.setattr(owner, name, real)
    fast = setup_s(plan, 2**31 + 42)
    assert abs(slowed - fast) < SLEEP / 2, (slowed, fast)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_warm_up_job_covers_every_frame_of_the_clip(cell, monkeypatch, few_threads):
    from video_annotator_tpu_torch.pipeline import render as r

    plan = small_plan(cell)
    frames = plan.cfg["frames"]
    calls = []

    def render(src, dest, options, profiler=None, device="cuda"):
        r_real(src, dest, options, profiler, device=device)
        rows = (len(trajfile.read_params(trajfile.path_for(dest))) if plan.mix["analyses"]
                else None)
        calls.append((options, rows))

    r_real = r.render
    monkeypatch.setattr(r, "render", render)
    summaries = []
    finish = harness.Collector.finish

    def keep(self):
        jobs, kept = finish(self)
        summaries.extend(jobs)
        return jobs, kept

    monkeypatch.setattr(harness.Collector, "finish", keep)
    harness.run_cell(plan, 2**31 + 43, 0.0, False, "cpu", time.monotonic())
    (warm, warm_rows), (window, _) = calls
    assert warm is window  # the same options: no --end, the whole clip
    if plan.mix["analyses"]:
        assert warm_rows == frames
    if plan.mix["frames_out"]:
        assert summaries[0]["kept"] == [] and summaries[0]["frames"] == frames
