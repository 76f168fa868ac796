"""The control: the reference put in the program's place and computed in
bfloat16, the precision below the configuration's float32, fails the
comparison that decides ``correct``: at a small size here, at the cells'
own size on a card (``-m cuda``)."""

import copy

import numpy as np
import pytest
import torch
from conftest import CELLS, all_cells_bench

from portbench import generator, harness, readings, reference

BENCH = all_cells_bench()


def failed_numbers(plan, seed, device):
    got = readings.control_readings(plan, seed, device)
    limits = plan.cfg["limits"]
    return {k for k, v in got.items() if v > limits[k]}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_at_a_small_size(cell, few_threads):
    plan = harness.cell_plan(BENCH, cell)
    plan.cfg = copy.deepcopy(plan.cfg)
    plan.cfg.update(width=256, height=192, frames=240)
    assert failed_numbers(plan, 2**31 + 21, "cpu")


def test_float32_reference_reads_equal_to_itself(few_threads):
    cfg = dict(harness.cell_plan(BENCH, "h4b_4k30.render").cfg, width=256, height=192, frames=20)
    clip = generator.Clip(cfg, 5)
    warp = reference.Warp(clip.camera, cfg["stabilise_buffer_percent"])
    corr = reference.corrections(reference.truth_params(clip.rotvecs), cfg["stabilise_radius"])
    _, y, u, v = next(clip.render("cpu", first=7, count=1))
    a = warp.frame(y, u, v, corr[7])
    b = warp.frame(y.clone(), u.clone(), v.clone(), corr[7].clone())
    assert all(torch.equal(x, z) for x, z in zip(a, b))
    assert np.isfinite(corr.numpy()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_at_the_cells_size(cell, card):
    plan = harness.cell_plan(BENCH, cell)
    for seed in (2**31 + 31, 2**31 + 32, 2**31 + 33):
        assert failed_numbers(plan, seed, card)
