"""The stages a render opens in its ``StageProfiler``, on every thread.

A recording subclass keeps each stage's ``(name, thread, start, end)`` on
``time.time_ns()``, as the benchmark's does, and each render runs on the
CPU at a small synthetic size. Checked: the writer thread's ``readback``
and ``sink`` for each frame written, the feed's ``upload`` and the
consumer's ``feed-wait`` for each frame pulled, one ``open`` a phase and
one ``save`` a saved trajectory, the trackers' parts nested in the
caller's ``track``, the two-phase render's ``phase-analyse`` and
``phase-encode`` around their phases' stages, the report's grouping by
thread and parent, and the
``--trace DIR`` Chrome trace holding the stages."""

import contextlib
import json
import os
import sys
import threading
import time

import pytest
import torch

from video_annotator_tpu_torch import cli as tcli
from video_annotator_tpu_torch.camera import CameraPreset
from video_annotator_tpu_torch.ops import lk_kernel
from video_annotator_tpu_torch.pipeline import render as trender
from video_annotator_tpu_torch.pipeline.profiler import StageProfiler

FRAMES = 24
SRC = f"synthetic://shaky?w=256&h=192&n={FRAMES}&seed=5&shake=0.004&pan=0.0"
PAIRED_PARTS = ("detect", "lk", "ransac", "chain")
TRACKED_PARTS = ("stage", "lk", "ransac", "chain", "key frame")


class Recorder(StageProfiler):
    """Each stage's (name, thread name, start ns, end ns)."""

    def __init__(self):
        super().__init__()
        self.spans = []

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.time_ns()
        try:
            with super().stage(name):
                yield
        finally:
            self.spans.append((name, threading.current_thread().name, t0, time.time_ns()))

    def of(self, name):
        return [s for s in self.spans if s[0] == name]

    def threads(self, name):
        return {t for _, t, _, _ in self.of(name)}


@pytest.fixture(autouse=True)
def few_threads():
    """A render runs torch on three threads (feed, main, writer): one
    intra-op thread each keeps parallel test workers off each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def options(**kw):
    return trender.RenderOptions(stabilise="smooth", stabilise_radius=8, warp_batch=5,
                                 preset=CameraPreset.GOPRO_H4B_WIDE43_MEASURED, **kw)


def rendered(tmp_path, **kw):
    """A render of SRC into a y4m with a Recorder; returns the recorder
    and the time_ns() read before and after it."""
    prof = Recorder()
    t0 = time.time_ns()
    trender.render(SRC, str(tmp_path / "out.y4m"), options(**kw), profiler=prof,
                   device="cpu")
    return prof, t0, time.time_ns()


def nested_in(prof, name, parent):
    """Every ``name`` span lies inside a ``parent`` span of its own thread."""
    outer = prof.of(parent)
    return all(any(t == pt and ps <= s and e <= pe for _, pt, ps, pe in outer)
               for _, t, s, e in prof.of(name))


def check_write_and_feed(prof, t0, t1, phases):
    main = threading.current_thread().name
    assert len(prof.of("readback")) == len(prof.of("sink")) == FRAMES
    assert prof.threads("readback") == prof.threads("sink") == {"frame-writer"} != {main}
    # Each phase decodes the clip once: an upload a frame on the feed thread
    # (and a decode a frame and one that finds the end of the stream), a
    # feed-wait a frame and one for the end of the stream on this one.
    assert len(prof.of("upload")) == phases * FRAMES
    assert len(prof.of("decode")) == phases * (FRAMES + 1)
    assert prof.threads("upload") == {"frame-feed"}
    assert len(prof.of("feed-wait")) == phases * (FRAMES + 1)
    assert prof.threads("feed-wait") == {main}
    assert len(prof.of("open")) == phases and len(prof.of("save")) == 1
    assert prof.threads("open") == prof.threads("save") == {main}
    assert all(t0 <= s <= e <= t1 for _, _, s, e in prof.spans)
    secs, calls = prof.all_totals()
    assert calls["readback"] == FRAMES and calls["feed-wait"] == phases * (FRAMES + 1)
    assert all(secs[n] > 0 for n in ("readback", "sink", "upload", "feed-wait", "open"))


@pytest.mark.parametrize("lk", ["plain", "kernel"])
def test_streaming_paired_records_every_thread(tmp_path, monkeypatch, lk):
    """``kernel``: K2's branch through its plain twin, with K3's staging."""
    monkeypatch.setattr(lk_kernel, "resolve_lk", lambda device: lk)
    prof, t0, t1 = rendered(tmp_path, streaming=True, analysis_mode="paired",
                            analysis_chunk=5)
    check_write_and_feed(prof, t0, t1, phases=1)
    parts = PAIRED_PARTS + ("hypotheses",) + (("stage",) if lk == "kernel" else ())
    # 23 pairs in chunks of 5: four full chunks and the tail at the end.
    for name in parts:
        assert len(prof.of(name)) == 5, name
        assert nested_in(prof, name, "track"), name
    assert nested_in(prof, "hypotheses", "ransac")
    assert ("stage" in prof.all_totals()[0]) == (lk == "kernel")


def test_two_phase_records_every_thread(tmp_path):
    prof, t0, t1 = rendered(tmp_path, analysis_mode="paired", analysis_chunk=8)
    check_write_and_feed(prof, t0, t1, phases=2)
    for name in PAIRED_PARTS:
        assert len(prof.of(name)) == 3 and nested_in(prof, name, "track"), name
    # The save comes between the phases' set-ups.
    (_, _, s0, _), (_, _, s1, _) = prof.of("open")
    (_, _, save, _), = prof.of("save")
    assert s0 < save < s1


PHASE_SRC = "synthetic://shaky?w=128&h=96&n=10&seed=5&shake=0.004&pan=0.0"
PHASES = {"phase-analyse": ("open", "track", "collect", "save"),
          "phase-encode": ("open", "warp", "encode")}


def inside(span, parent, prof):
    """``span`` lies inside one of ``parent``'s spans, on its thread."""
    _, t, s, e = span
    return any(pt == t and ps <= s and e <= pe for _, pt, ps, pe in prof.of(parent))


@pytest.mark.parametrize("job,opened", [
    ({}, ("phase-analyse", "phase-encode")),
    ({"analyse_only": True}, ("phase-analyse",)),
    ({"encode_only": True}, ("phase-encode",)),
    ({"streaming": True}, ()),
], ids=["two-phase", "analyse-only", "encode-only", "streaming"])
def test_phase_spans_open_once_a_job(tmp_path, job, opened):
    """Two jobs into one profiler: each phase the job runs opens once a
    job, on the caller's thread, around that phase's stages."""
    prof = Recorder()
    for k in range(2):
        dest = str(tmp_path / f"job{k}.y4m")
        if job.get("encode_only"):
            trender.render(PHASE_SRC, dest, options(analyse_only=True), device="cpu")
        trender.render(PHASE_SRC, dest, options(analysis_mode="paired", analysis_chunk=4, **job),
                       profiler=prof, device="cpu")
    main = threading.current_thread().name
    assert {n for n, _, _, _ in prof.spans if n.startswith("phase-")} == set(opened)
    for phase in opened:
        assert len(prof.of(phase)) == 2 and prof.threads(phase) == {main}
        for name in PHASES[phase]:
            assert any(inside(sp, phase, prof) for sp in prof.of(name)), (phase, name)
    # Every stage of the render thread but the phases lies inside a phase.
    for sp in prof.spans:
        if opened and sp[1] == main and not sp[0].startswith("phase-"):
            assert any(inside(sp, phase, prof) for phase in opened), sp[0]
    if len(opened) == 2:  # the analyse ends before the encode starts
        assert prof.of("phase-analyse")[0][3] <= prof.of("phase-encode")[0][2]


def test_report_shares_skip_phases_run_once():
    """A single render's phases have only warm-up samples: the shares of
    the pipeline are those of the stages inside them; with more runs than
    the warm-up, those of the phases."""
    prof = StageProfiler(warmup=3)

    def job():
        with prof.stage("phase-analyse"):
            for _ in range(5):
                with prof.stage("track"):
                    time.sleep(0.001)
        with prof.stage("phase-encode"):
            for _ in range(5):
                with prof.stage("warp"):
                    time.sleep(0.002)

    def shares():
        lines = {line.split(":")[0].strip(): line for line in prof.report().splitlines()}
        return {n: float(line.rsplit(",", 1)[1].split("%")[0])
                for n, line in lines.items() if "% of pipeline" in line}

    job()
    assert "phase-analyse: (warmup only)" in prof.report()
    got = shares()
    assert set(got) == {"track", "warp"} and abs(sum(got.values()) - 100.0) < 0.2
    for _ in range(3):
        job()
    got = shares()
    assert set(got) == {"phase-analyse", "phase-encode"}
    assert abs(sum(got.values()) - 100.0) < 0.2


@pytest.mark.parametrize("streaming", [False, True])
def test_tracker_parts_reach_the_callers_profiler(tmp_path, streaming):
    prof, _, _ = rendered(tmp_path, streaming=streaming, analysis_mode="tracked")
    for name in TRACKED_PARTS:
        assert len(prof.of(name)) == FRAMES - 1, name
        assert nested_in(prof, name, "track"), name


def test_report_groups_by_thread_and_parent():
    prof = StageProfiler(warmup=0)

    def step():
        with prof.stage("track"):
            with prof.stage("ransac"):
                with prof.stage("hypotheses"):
                    time.sleep(0.002)
                time.sleep(0.002)
        with prof.stage("warp"):
            time.sleep(0.002)

    def writer():
        with prof.stage("readback"):
            time.sleep(0.01)

    worker = threading.Thread(target=writer, name="frame-writer")
    worker.start()
    step()
    worker.join(timeout=10)
    assert not worker.is_alive()
    lines = prof.report().splitlines()
    me = threading.current_thread().name
    assert [line.split(":")[0] for line in lines] == [
        f"[{me}]", "  track", "    ransac", "      hypotheses", "  warp",
        "[frame-writer]", "  readback"]
    share = {line.split(":")[0].strip(): line for line in lines}
    # Shares of the pipeline: this thread's outermost stages only.
    assert "% of pipeline" in share["track"] and "% of pipeline" in share["warp"]
    assert not any("% of pipeline" in share[n] for n in ("ransac", "hypotheses", "readback"))
    pct = [float(share[n].rsplit(",", 1)[1].split("%")[0]) for n in ("track", "warp")]
    assert abs(sum(pct) - 100.0) < 0.2
    # Self time: ransac less its hypotheses.
    secs, _ = prof.totals()
    self_ms = float(share["ransac"].split("self")[1].split("ms")[0])
    assert self_ms < secs["ransac"] * 1e3 - 1.0


def test_totals_keep_their_shape_and_warmup():
    prof = StageProfiler(warmup=2)
    for _ in range(5):
        with prof.stage("track"):
            with prof.stage("lk"):
                pass
    secs, calls = prof.totals()
    all_secs, all_calls = prof.all_totals()
    assert list(secs) == list(all_secs) == ["lk", "track"]
    assert calls == {"lk": 3, "track": 3} and all_calls == {"lk": 5, "track": 5}
    assert all(all_secs[n] >= secs[n] >= 0 for n in secs)


def test_concurrent_stages_lose_no_call():
    """More threads than cores opening the same stages, with a short switch
    interval: every call is counted."""
    prof = StageProfiler(warmup=1)
    n_threads, n_calls = 2 * (os.cpu_count() or 2) + 2, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_calls):
                with prof.stage("sink"):
                    with prof.stage("inner"):
                        pass

        workers = [threading.Thread(target=work, name="frame-writer") for _ in range(n_threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    _, calls = prof.all_totals()
    assert calls == {"inner": n_threads * n_calls, "sink": n_threads * n_calls}


def test_cli_trace_holds_the_stages(tmp_path, capsys):
    """``--trace DIR``: each stage is a range of the Chrome trace, the
    feed's and the writer's on their own threads."""
    trace_dir = str(tmp_path / "trace")
    src = "synthetic://shaky?w=96&h=64&n=4&seed=3"
    assert tcli.main(["render", src, str(tmp_path / "out.y4m"), "--device", "cpu",
                      "--stabilise", "smooth", "--trace", trace_dir]) == 0
    files = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    tids = {}
    for e in events:
        if e.get("name") in ("readback", "upload", "track"):
            tids.setdefault(e["name"], set()).add(e.get("tid"))
    assert set(tids) == {"readback", "upload", "track"}
    # One writer thread, a feed thread a phase, the caller's thread.
    assert len(tids["track"]) == 1
    assert not (tids["readback"] & tids["upload"]) and not (tids["track"] & tids["upload"])
    assert not tids["readback"] & tids["track"]
