"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from the
root of the repository (on the CPU; the tests marked ``cuda`` run on a
card)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def few_threads():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


# Every cell the data files describe, those BENCHMARK.json runs and those it
# leaves for later (PERF.md, open questions): the tests hold them all.
CELLS = {"h4b_4k30.render": ("h4b_4k30", "render"),
         "h4b_1440p60.analyse": ("h4b_1440p60", "analyse"),
         "h4b_4k30.encode_only": ("h4b_4k30", "encode_only"),
         "h4b_1440p60.streaming": ("h4b_1440p60", "streaming")}


def all_cells_bench() -> dict:
    """BENCHMARK.json with every cell of :data:`CELLS` and every metric
    applying to all of them."""
    import json

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    metrics = lambda ms: [{k: v for k, v in m.items() if k != "workloads"} for m in ms]  # noqa: E731
    return dict(bench,
                configs=[{"name": c, "file": f"portbench/configs/{c}.json"}
                         for c in sorted({c for c, _ in CELLS.values()})],
                workloads=[{"name": n, "config": c, "traffic": t, "chips": 1}
                           for n, (c, t) in CELLS.items()],
                end_to_end=metrics(bench["end_to_end"]), per_layer=[])


def small_plan(cell: str):
    """``cell``'s plan from :func:`all_cells_bench` at 192x144 and 40 frames,
    for a whole run on the CPU."""
    import copy

    from portbench import harness

    plan = harness.cell_plan(all_cells_bench(), cell)
    plan.cfg = copy.deepcopy(plan.cfg)
    plan.cfg.update(width=192, height=144, frames=40)
    return plan
