"""A run with its timed path broken underneath comes out not correct.

Each cell's faults, planted in the program on the CPU at a small size (the
harness's look for a card skipped): a step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced. The cells run on one card, so no exchange between cards can be
left out."""

import sys
import time

import numpy as np
import pytest
import torch
from conftest import CELLS, small_plan

from portbench import harness

sys.path.insert(0, str(harness.HERE))
import run  # noqa: E402


def identity_analyse(real):
    def analyse(source, options, profiler=None, device="cuda"):
        traj = real(source, options, profiler, device)
        traj.params = np.zeros_like(traj.params)
        return traj
    return analyse


def half_analyse(real):
    def analyse(source, options, profiler=None, device="cuda"):
        traj = real(source, options, profiler, device)
        traj.params = traj.params[::2].copy()
        return traj
    return analyse


def altered_analyse(real):
    def analyse(source, options, profiler=None, device="cuda"):
        traj = real(source, options, profiler, device)
        traj.params = traj.params.copy()
        traj.params[len(traj.params) // 2, 2] += np.radians(1.0)
        return traj
    return analyse


def half_warp(real):
    def warp(self, ys, us, vs, rotations):
        outs = real(self, ys, us, vs, rotations)
        return outs[: len(outs) // 2]
    return warp


def altered_warp(real):
    def warp(self, ys, us, vs, rotations):
        outs = real(self, ys, us, vs, rotations)
        for y, _, _ in outs:
            y[0, 0] = 255 - y[0, 0]
            y[-1, -1] = 255 - y[-1, -1]
        return outs
    return warp


def identity_corrections(real):
    def corrections(traj, options, device="cuda"):
        out = real(traj, options, device)
        return np.broadcast_to(np.eye(3, dtype=np.float32), out.shape).copy()
    return corrections


def still_tracker(real):
    def push(self, frame):
        real(self, frame)
        return torch.eye(3, dtype=torch.float32, device=frame.device)
    return push


FAULTS = {
    # (cell, fault): (where it is planted, the number it must fail)
    ("h4b_4k30.render", "state unchanged"): ("analyse", identity_analyse, "traj_rms_deg"),
    ("h4b_4k30.render", "half the batch"): ("warp", half_warp, "frames_missing"),
    ("h4b_4k30.render", "answer altered"): ("warp", altered_warp, "frame_max_diff"),
    ("h4b_1440p60.analyse", "state unchanged"): ("analyse", identity_analyse, "traj_rms_deg"),
    ("h4b_1440p60.analyse", "half the batch"): ("analyse", half_analyse,
                                                "traj_frames_missing"),
    ("h4b_1440p60.analyse", "answer altered"): ("analyse", altered_analyse, "traj_max_deg"),
    ("h4b_4k30.encode_only", "state unchanged"): ("corrections", identity_corrections,
                                                  "frame_max_diff"),
    ("h4b_4k30.encode_only", "half the batch"): ("warp", half_warp, "frames_missing"),
    ("h4b_4k30.encode_only", "answer altered"): ("warp", altered_warp, "frame_max_diff"),
    ("h4b_1440p60.streaming", "state unchanged"): ("tracker", still_tracker, "traj_rms_deg"),
    ("h4b_1440p60.streaming", "half the batch"): ("warp", half_warp, "frames_missing"),
    ("h4b_1440p60.streaming", "answer altered"): ("warp", altered_warp, "frame_max_diff"),
}


def plant(monkeypatch, where, fault):
    from video_annotator_tpu_torch.pipeline import render as r

    if where == "analyse":
        monkeypatch.setattr(r, "analyse", fault(r.analyse))
    elif where == "warp":
        monkeypatch.setattr(r.FrameWarper, "warp_yuv_batch", fault(r.FrameWarper.warp_yuv_batch))
    elif where == "corrections":
        monkeypatch.setattr(r, "compute_corrections", fault(r.compute_corrections))
    elif where == "tracker":
        monkeypatch.setattr(r.Tracker, "push", fault(r.Tracker.push))


def run_small(cell: str, seed: int) -> dict:
    out = harness.run_cell(small_plan(cell), seed, 0.0, False, "cpu", time.monotonic())
    assert not out["forbidden"]
    return run.result_line(None, out, {})


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(cell, few_threads):
    line = run_small(cell, 2**31 + 11)
    assert line["correct"], line["checks"]
    assert line["attempted"] == 1 and line["failed"] == 0


@pytest.mark.parametrize("cell,fault", sorted(FAULTS), ids=lambda x: x.replace(" ", "_"))
def test_a_broken_run_is_not_correct(cell, fault, monkeypatch, few_threads):
    where, make, number = FAULTS[(cell, fault)]
    plant(monkeypatch, where, make)
    line = run_small(cell, 2**31 + 11)
    assert not line["correct"]
    check = line["checks"][number]
    assert check["value"] > check["limit"], line["checks"]
