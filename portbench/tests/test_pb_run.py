"""The command: its result line, and its refusal without a card."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness

sys.path.insert(0, str(harness.HERE))
import run  # noqa: E402


def fake_out(trace=None):
    return {"attempted": 3, "failed": 0, "trace": trace,
            "metrics": {"render_fps": {"value": 20.5, "unit": "frames/s"}},
            "checks": {"frames_missing": (0, 0), "frame_max_diff": (0, 1)}}


def test_result_line_has_the_contracts_keys():
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
              "memory_peak_bytes": 123}
    line = run.result_line(None, fake_out(), dict(device))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["device"] == device
    assert line["checks"]["frame_max_diff"] == {"value": 0, "limit": 1}
    json.dumps(line)


def test_traced_line_adds_busy_window_and_breakdown():
    from portbench.trace import DeviceTrace

    t = DeviceTrace([("void warp_kernel<1, false, 0>(unsigned char const*)", 100, 400),
                     ("Memcpy HtoD", 300, 600), ("k2", 900, 950)], 0, 1000,
                    spans=[("encode", 0, 700), ("decode", 650, 1000)])
    line = run.result_line(None, fake_out(t), {"platform": "gpu"})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    assert line["device"]["busy_s"] == pytest.approx(550e-9)
    assert line["device"]["window_s"] == pytest.approx(1000e-9)
    ops = dict(line["breakdown"]["device_ops"])
    assert ops["warp_kernel<1, false, 0>"] == pytest.approx(300e-9)
    gaps = dict(line["breakdown"]["idle_gaps"])
    assert gaps == {"decode": pytest.approx(350e-9), "encode": pytest.approx(100e-9)}


def test_a_number_over_its_limit_is_not_correct():
    out = fake_out()
    out["checks"]["frame_max_diff"] = (2, 1)
    assert run.result_line(None, out, {})["correct"] is False
    out = fake_out()
    out["failed"] = 1
    assert run.result_line(None, out, {})["correct"] is False


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cell = harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"][0]["name"]
    proc = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload",
                           cell, "--seed", str(2**31 + 9), "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True,
                          cwd=harness.ROOT, env=dict(os.environ), timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_plan_lists_each_cells_metrics():
    plan = harness.cell_plan(harness.load_json(harness.ROOT / "BENCHMARK.json"),
                             "h4b_1440p60.streaming")
    assert [m["name"] for m in plan.end_to_end] == ["card_ms_per_frame", "setup_s"]
    assert [m["name"] for m in plan.per_layer] == [
        "decode_ms_per_frame.render", "analyse_ms_per_frame.render", "write_ms_per_frame",
        "k1_warp_roofline", "device_idle_share.render", "peak_device_GiB.render",
        "readback_ms_per_frame", "sink_ms_per_frame", "upload_ms_per_frame",
        "feed_wait_ms_per_frame", "job_open_ms", "render_fps.window"]
    assert all(m["moves"] == "card_ms_per_frame" for m in plan.per_layer)


def test_idle_gaps_sweep_agrees_with_a_scan():
    import random

    from portbench.trace import DeviceTrace

    rng = random.Random(5)
    events = []
    for _ in range(300):
        s = rng.randrange(0, 100_000)
        events.append(("k", s, s + rng.randrange(1, 400)))
    spans = []
    for name in ("decode", "track", "encode"):
        for _ in range(60):
            s = rng.randrange(0, 100_000)
            spans.append((name, s, s + rng.randrange(1, 3000)))
    t = DeviceTrace(events, 0, 100_000, spans)
    totals = {}
    edge = 0
    for s, e in t.busy + [(100_000, 100_000)]:
        if s > edge:
            mid = (edge + s) // 2
            names = sorted({n for n, a, b in spans if a <= mid < b})
            label = "+".join(names) if names else "no stage"
            totals[label] = totals.get(label, 0) + (s - edge)
        edge = max(edge, e)
    want = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    assert [[n, pytest.approx(v * 1e-9)] for n, v in want] == t.idle_gaps()
    assert t.busy_s + sum(v for _, v in totals.items()) * 1e-9 == pytest.approx(t.window_s)


def test_the_window_is_traced_where_a_metric_reads_the_trace():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    plan = harness.cell_plan(bench, "h4b_1440p60.streaming")
    assert harness.wants_device_trace(plan, False) and harness.wants_device_trace(plan, True)
    host_only = dict(bench, end_to_end=[m for m in bench["end_to_end"]
                                        if m["source"] == "host_clock"])
    plan = harness.cell_plan(host_only, "h4b_1440p60.streaming")
    assert not harness.wants_device_trace(plan, False) and harness.wants_device_trace(plan, True)


def test_card_ms_per_frame_is_busy_time_over_the_frames_received():
    from types import SimpleNamespace

    from portbench.trace import DeviceTrace

    read = harness.reader("card_ms_per_frame")
    t = DeviceTrace([("", 0, 3_000_000), ("", 2_000_000, 5_000_000), ("", 9_000_000, 10_000_000)],
                    1_000_000, 20_000_000)
    summaries = [{"frames": 2}, {"frames": 3}]
    assert read(SimpleNamespace(trace=t, summaries=summaries)) == pytest.approx(5.0 / 5)
    assert read(SimpleNamespace(trace=None, summaries=summaries)) is None
    assert read(SimpleNamespace(trace=t, summaries=[])) is None
    assert read(SimpleNamespace(trace=DeviceTrace([], 0, 10), summaries=summaries)) is None
