"""The port's benchmark tools (``video_annotator_tpu_torch/tools/{run,soak,
host_feed,bracket}.py``) against the JAX package's ``benchmarks/*.py``,
loaded by path, on the CPU: the configs, the result records, the input
generators byte for byte, the soak's segment and RSS arithmetic on a
synthetic timeline; and each tool's own run at a small size with
``--device cpu``."""

import importlib.util
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_streaming import few_threads  # noqa: F401 (autouse fixture)
from video_annotator_tpu_torch.io import native
from video_annotator_tpu_torch.io.y4m import Y4MReader
from video_annotator_tpu_torch.tools import bracket, host_feed, run, soak

ROOT = Path(__file__).resolve().parent.parent
STAMP_KEYS = {"git_sha", "captured_at_utc", "torch", "cuda", "backend"}


def load(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                  ROOT / "benchmarks" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jrun():
    return load("run")


@pytest.fixture(scope="module")
def jsoak():
    return load("soak")


@pytest.fixture(scope="module")
def jhost_feed():
    return load("host_feed")


def test_configs_are_jaxs(jrun):
    assert list(run.CONFIGS) == list(jrun.CONFIGS)


@pytest.mark.parametrize("extra", [None, {"geometry": "3840x2880", "analyse_fps": 51.2}])
def test_result_keys_and_values_are_jaxs(jrun, extra):
    args = ("4k_gyro_fused", 1234.5678, 64, 60.0)
    assert run._result(*args, extra=extra) == jrun._result(*args, extra=extra)


def test_best_of_takes_the_fastest_of_the_trials(monkeypatch):
    monkeypatch.setattr(run, "TRIALS", 3)
    monkeypatch.setattr(run, "TRIAL_SLEEP", 0.0)
    waits = iter([0.03, 0.01, 0.02])
    calls = []

    def fn():
        calls.append(1)
        time.sleep(next(waits))

    best = run._best_of(fn, trials=5)  # at most TRIALS
    assert len(calls) == 3 and 0.01 <= best < 0.02


def test_paired_stacks_repeat_the_last_frame():
    frames = [torch.full((2, 3), float(i)) for i in range(6)]
    stacks = run.paired_stacks(frames, 4)
    assert [s[:, 0, 0].tolist() for s in stacks] == [[0, 1, 2, 3, 4], [4, 5, 5, 5, 5]]


class Recorder:
    """A writer that keeps the frames it is given."""
    frames = []

    def __init__(self, *args, **kwargs):
        type(self).frames = []

    def write(self, planes):
        type(self).frames.append(tuple(np.array(p) for p in planes))

    def close(self):
        pass


def test_soak_input_is_jaxs_byte_for_byte(jsoak, monkeypatch, tmp_path):
    import video_annotator_tpu.io.video as jvideo

    n, w, h = 5, 96, 64
    monkeypatch.setattr(jvideo, "open_writer", lambda *a, **k: Recorder())
    jsoak.make_input(str(tmp_path / "unused.mp4"), n, w, h)
    want = Recorder.frames
    path = str(tmp_path / "soak.y4m")
    soak.make_input(path, n, w, h)
    reader = Y4MReader(path)
    got = [tuple(np.array(p) for p in f) for f in reader]
    reader.close()
    assert len(got) == len(want) == n
    for g, wnt in zip(got, want):
        for a, b in zip(g, wnt):
            assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)


def test_host_feed_clip_is_jaxs_byte_for_byte(jhost_feed, monkeypatch, tmp_path):
    import video_annotator_tpu.io.native as jnative

    w, h, frames = 96, 64, 18
    monkeypatch.setattr(jnative, "NativeVideoWriter", Recorder)
    jhost_feed.make_clip(str(tmp_path / "a.mp4"), w, h, frames)
    want = Recorder.frames
    monkeypatch.setattr(native, "NativeVideoWriter", Recorder)
    host_feed.make_clip(str(tmp_path / "b.mp4"), w, h, frames)
    got = Recorder.frames
    assert len(got) == len(want) == frames
    for g, wnt in zip(got, want):
        assert all(np.array_equal(a, b) for a, b in zip(g, wnt))


class FakeChild:
    """A render child whose /proc status reads the RSS timeline given."""

    def __init__(self, timeline_mb):
        self.timeline = list(timeline_mb)
        self.pid = 424242
        self.returncode = None
        self.read = threading.Event()

    def poll(self):
        if self.timeline:
            return None
        self.returncode = 0
        self.read.set()
        return 0

    def communicate(self):
        self.read.wait(10)
        return "", None


@pytest.mark.parametrize("timeline", [[300, 900, 1200, 1210, 1205, 1215, 1220, 1230, 1250, 1240],
                                      [500, 520], []])
def test_rss_timeline_arithmetic_is_jaxs(jsoak, monkeypatch, timeline):
    """``_run_render``'s peak, plateau and late slope from one sampled
    timeline, against the JAX tool's on the same samples."""
    def run_render(module):
        child = FakeChild(timeline)

        def fake_open(path, *a, **k):
            assert path == f"/proc/{child.pid}/status"
            import io
            return io.StringIO(f"Name:\tpython\nVmRSS:\t{child.timeline.pop(0) * 1024} kB\n")

        monkeypatch.setattr(subprocess, "Popen", lambda *a, **k: child)
        monkeypatch.setattr(module, "open", fake_open, raising=False)
        monkeypatch.setattr(time, "sleep", lambda s: None)
        out = module._run_render(["render"], {})
        out.pop("dt")
        return out

    assert run_render(soak) == run_render(jsoak)


def fake_children(monkeypatch, modules, tmp_path):
    """Render children with made-up timings and RSS, the same sequence for
    every module's ``run_soak``; the clock advances by each child's dt."""
    clock = [1000.0]
    monkeypatch.setattr(time, "time", lambda: clock[0])

    def make(module):
        results = iter([
            dict(dt=9.0, peak_mb=2900, steady_mb=2100, slope_mb_per_min=3.0),  # warm-up
            dict(dt=6.0, peak_mb=3100, steady_mb=2200, slope_mb_per_min=12.0),
            dict(dt=7.5, peak_mb=3300, steady_mb=2250, slope_mb_per_min=30.0),
            dict(dt=8.0, peak_mb=3600, steady_mb=2300, slope_mb_per_min=45.0),
            dict(dt=20.0, peak_mb=1500, steady_mb=1300, slope_mb_per_min=0.0),  # cpu, low
            dict(dt=50.0, peak_mb=1560, steady_mb=1350, slope_mb_per_min=6.0),  # cpu, high
        ])

        def fake_run_render(args, env):
            r = next(results)
            clock[0] += r["dt"]
            return dict(r)

        def fake_make_input(path, n, w, h):
            Path(path).write_bytes(b"\0")
            made.append(path)

        monkeypatch.setattr(module, "_run_render", fake_run_render)
        monkeypatch.setattr(module, "make_input", fake_make_input)

    made = []
    for m in modules:
        make(m)
    return made


@pytest.mark.parametrize("attribution", [True, False])
def test_soak_segments_and_rss_are_jaxs(jsoak, monkeypatch, tmp_path, attribution):
    """``run_soak``'s segment fps, decay gate, RSS ceiling and attribution
    on one timeline of children, against the JAX tool's formulas; the
    tunnel keys under the card's names."""
    made = fake_children(monkeypatch, (soak, jsoak), tmp_path)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the port's clip
    w, h = 37, 23  # a clip name no other run uses (the JAX tool's is in /tmp)
    try:
        want = jsoak.run_soak(300, w, h, attribution=attribution, max_rss_mb=3500.0)
        got = soak.run_soak(300, w, h, attribution=attribution, max_rss_mb=3500.0,
                            device="cpu", source="y4m")
    finally:
        for p in made:
            Path(p).unlink(missing_ok=True)
    assert got.pop("source") == "y4m" and got.pop("device") == "cpu"
    if attribution:
        att = got["rss_attribution"]
        for old, new in (("tunnel_excess_mb_per_frame", "card_excess_mb_per_frame"),
                         ("tunnel_slope_mb_per_frame", "card_slope_mb_per_frame")):
            att[old] = att.pop(new)
    assert got == want
    assert want["peak_rss_ok"] is False and want["decay_free"] is True


@pytest.mark.parametrize("tool,argv", [
    (run, ["--configs", "720p_undistort_cpu"]),
    (soak, ["--frames", "6"]),
    (host_feed, ["--frames", "4"]),
    (bracket, ["--pairs", "1"]),
])
def test_tools_exit_1_without_a_card(tool, argv, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out.json"
    assert tool.main([*argv, "--out", str(out)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()


def stamped(record, backend="cpu"):
    assert STAMP_KEYS <= set(record) and record["backend"] == backend
    return record


def test_run_writes_stamped_json_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the child's torch, as few_threads here
    out = tmp_path / "run.json"
    rc = run.main(["--configs", "720p_undistort_cpu", "--device", "cpu", "--trials", "1",
                   "--sleep", "0", "--out", str(out)])
    assert rc == 0
    (row,) = json.loads(out.read_text())
    stamped(row)
    assert row["config"] == "720p_undistort_cpu" and row["value"] > 0
    assert row["frames_timed"] == 300 and row["launches"] == {}


def test_soak_writes_stamped_json_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = tmp_path / "soak.json"
    rc = soak.main(["--device", "cpu", "--source", "y4m", "--frames", "6", "--width", "160",
                    "--height", "120", "--no-attribution", "--out", str(out)])
    assert rc == 0
    r = stamped(json.loads(out.read_text()))
    assert r["source"] == "y4m" and len(r["segment_fps"]) == 3 and r["rss_ok"]
    assert (tmp_path / "soak_in_160x120_6.y4m").exists()


def test_write_once_leaves_no_partial_file(tmp_path):
    """A write cut short leaves nothing under the final name; the next call
    writes it, and a later one keeps it."""
    path = str(tmp_path / "clip.y4m")

    def cut(part):
        Path(part).write_bytes(b"half")
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        soak.write_once(path, cut)
    assert list(tmp_path.iterdir()) == []
    assert soak.write_once(path, lambda part: Path(part).write_bytes(b"whole"))
    assert not soak.write_once(path, cut)
    assert Path(path).read_bytes() == b"whole" and len(list(tmp_path.iterdir())) == 1


def test_soak_mp4_source_needs_the_native_writer(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "load_writer_library", lambda: None)
    with pytest.raises(RuntimeError, match="native writer not built"):
        soak.make_input(str(tmp_path / "in.mp4"), 2, 32, 16)


@pytest.mark.skipif(not native.native_available(), reason="native libraries not built")
def test_host_feed_decodes_through_the_native_loader(tmp_path):
    out = tmp_path / "host_feed.json"
    rc = host_feed.main(["--device", "cpu", "--w", "160", "--h", "96", "--frames", "6",
                         "--loaders", "1", "2", "--out", str(out)])
    assert rc == 0
    clip, one, two = (stamped(r) for r in json.loads(out.read_text()))
    assert clip["frames"] == 6 and one["frames"] == 6 and two["frames"] == 12
    assert one["value"] > 0 and two["loaders"] == 2


def test_host_feed_exits_1_without_the_native_loader(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(native, "native_available", lambda: False)
    assert host_feed.main(["--device", "cpu", "--out", str(tmp_path / "x.json")]) == 1
    assert "make -C native" in capsys.readouterr().err


def test_bracket_writes_stamped_json_on_the_cpu(tmp_path):
    out = tmp_path / "bracket.json"
    rc = bracket.main(["--device", "cpu", "--size", "160x120", "--pairs", "2", "--trials", "1",
                       "--out", str(out)])
    assert rc == 0
    r = stamped(json.loads(out.read_text()))
    assert len(r["pairs"]) == 2 and r["best_multistream_fps"] > 0
    assert r["geometry"] == "160x120" and r["row6_bound_ms_per_frame"] > 0
    assert all(p["slope_ms_per_output_mpix"] == pytest.approx(
        0.5 * (p["slope_ms_per_frame_before"] + p["slope_ms_per_frame_after"])
        / (int(r["output"].split("x")[0]) * int(r["output"].split("x")[1]) / 1e6), rel=1e-3,
        abs=1e-5) for p in r["pairs"])


def test_tool_modules_run_as_scripts():
    """``python -m video_annotator_tpu_torch.tools.<name> --help``, the four
    run as ``__main__`` in one child process (one torch import)."""
    script = """if True:
        import runpy, sys
        for name in ("run", "soak", "host_feed", "bracket"):
            sys.argv = [name, "--help"]
            try:
                runpy.run_module(f"video_annotator_tpu_torch.tools.{name}", run_name="__main__")
            except SystemExit as e:
                print(f"=== {name} rc={e.code}", flush=True)
        """
    done = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          cwd=ROOT, timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]
    parts = done.stdout.split("=== ")
    for name, text in zip(("run", "soak", "host_feed", "bracket"), parts[:-1]):
        assert "--device" in text, name
    assert [p.split("\n")[0] for p in parts[1:]] == [
        f"{name} rc=0" for name in ("run", "soak", "host_feed", "bracket")]
