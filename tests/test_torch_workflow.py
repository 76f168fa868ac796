"""The torch port's host-side subcommands on the CPU, held against the JAX
package: chapter lookup and ``join`` (``io/gopro.py``), ``probe``, the
match workflow (``workflow.py``: metadata, tagging, lockfile claims,
``stabilise`` on the CPU, ``split``'s resume with its child render
stubbed, ``encode``) and the CLI surface of ``join``, ``compare``,
``workflow`` and ``probe``."""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

from test_torch_pipeline import ANGLE_TOL_DEG, angle_deg
from test_torch_streaming import few_threads  # noqa: F401 (autouse fixture)
from video_annotator_tpu import cli as jcli
from video_annotator_tpu import workflow as jworkflow
from video_annotator_tpu.io import gopro as jgopro
from video_annotator_tpu.pipeline import compare as jcompare
from video_annotator_tpu.pipeline.render import RenderOptions as JRenderOptions
from video_annotator_tpu.pipeline.trajectory import Trajectory as JTrajectory
from video_annotator_tpu_torch import cli as tcli
from video_annotator_tpu_torch import workflow as tworkflow
from video_annotator_tpu_torch.io import gopro as tgopro
from video_annotator_tpu_torch.io import native as tnative
from video_annotator_tpu_torch.io.video import VideoMeta, open_reader, open_writer
from video_annotator_tpu_torch.pipeline import compare as tcompare
from video_annotator_tpu_torch.pipeline import render as trender
from video_annotator_tpu_torch.pipeline.trajectory import Trajectory


def write_clip(path, n=8, w=96, h=64, seed=0):
    """A y4m clip of a texture sliding one pixel a frame (the JAX workflow
    tests' clip)."""
    wr = open_writer(str(path), VideoMeta(w, h, Fraction(10, 1)))
    base = np.random.default_rng(seed).integers(0, 255, (h, w), np.uint8)
    for i in range(n):
        wr.write((np.roll(base, i, axis=1), np.full((h // 2, w // 2), 128, np.uint8),
                  np.full((h // 2, w // 2), 128, np.uint8)))
    wr.close()
    return str(path)


def write_synthetic(path, uri):
    """The frames of a synthetic clip as a y4m file."""
    r = open_reader(uri)
    wr = open_writer(str(path), r.meta)
    for planes in r:
        wr.write(tuple(np.asarray(p) for p in planes))
    wr.close()
    r.close()


def outcome(fn, *args, **kw):
    try:
        return ("value", fn(*args, **kw))
    except Exception as e:  # compared, not handled
        return ("raise", type(e).__name__, str(e))


# --- chapters and join ------------------------------------------------------


@pytest.mark.parametrize("names,code", [
    (["GOPR0001.MP4", "GP010001.MP4", "GP020001.MP4"], "0001"),
    (["GOPR0002.mp4"], "0002"),
    (["GOPR0003.y4m", "GP010003.y4m", "GP030003.y4m"], "0003"),  # stops at the gap
    (["GOPR0004.MP4", "GP010004.mp4"], "0004"),  # the first chapter's extension only
    (["GP010005.MP4"], "0005"),  # no first chapter
    ([], "0006"),
])
def test_find_source_segments_matches_jax(tmp_path, names, code):
    for n in names:
        (tmp_path / n).write_bytes(b"")
    assert outcome(tgopro.find_source_segments, code, str(tmp_path)) == \
        outcome(jgopro.find_source_segments, code, str(tmp_path))


@pytest.mark.parametrize("out_name", ["joined.y4m", "match_0001.y4m"])
def test_join_y4m_chapters_writes_jax_bytes(tmp_path, out_name):
    """Three y4m chapters joined raw: the same bytes as the JAX join, by
    the y4m route, and the frame count the JAX count gives."""
    d = tmp_path
    for i, name in enumerate(["GOPR0001.y4m", "GP010001.y4m", "GP020001.y4m"]):
        write_clip(d / name, n=3 + i, seed=i)
    got, want = str(d / ("t_" + out_name)), str(d / ("j_" + out_name))
    assert tgopro.join("0001", got, directory=str(d)) == "y4m"
    jgopro.join("0001", want, directory=str(d))
    with open(got, "rb") as g, open(want, "rb") as w:
        assert g.read() == w.read()
    assert tgopro.count_frames(got) == jgopro.count_frames(want) == 12


def test_join_takes_the_native_route_where_it_builds(tmp_path):
    """MP4 chapters go through the native stream copy first, as in JAX:
    the same frames as the JAX join's output."""
    if not (tnative.native_concat_available() and tnative.native_writer_available()):
        pytest.skip("native libraries not built (make -C native)")
    from test_torch_native import decode
    from test_torch_native import write_clip as write_mp4

    for i, name in enumerate(["GOPR0007.MP4", "GP010007.MP4"]):
        write_mp4(tmp_path / name, n=6, seed=i)
    got, want = str(tmp_path / "t.mp4"), str(tmp_path / "j.mp4")
    assert tgopro.join("0007", got, directory=str(tmp_path)) == "native"
    jgopro.join("0007", want, directory=str(tmp_path))
    got_frames = decode(tnative.NativeVideoSource(got))
    want_frames = decode(tnative.NativeVideoSource(want))
    assert len(got_frames) == len(want_frames) == 12
    for g, w in zip(got_frames, want_frames):
        for gp, wp in zip(g, w):
            np.testing.assert_array_equal(gp, wp)


# --- probe ------------------------------------------------------------------


def test_probe_matches_jax_on_y4m_synthetic_and_telemetry(tmp_path):
    from video_annotator_tpu_torch.io.synthetic import SyntheticSource, write_telemetry_mp4

    clip = write_clip(tmp_path / "clip.y4m")
    src = "synthetic://shaky?w=64&h=48&n=8"
    telemetry = str(tmp_path / "telemetry.mp4")
    write_telemetry_mp4(telemetry, SyntheticSource.from_uri(src).config, (0.1, -0.99, 0.05))
    for source in (clip, src, telemetry):
        assert tcli.probe(source) == jcli.probe(source), source
    out = tcli.probe(telemetry)
    assert out["video"] is None and out["gpmf"]["gyro"]["samples"] > 0


def test_probe_raises_as_jax_on_an_unreadable_file(tmp_path):
    missing = str(tmp_path / "missing.mp4")
    got, want = outcome(tcli.probe, missing), outcome(jcli.probe, missing)
    assert got == want and got[:2] == ("raise", "ValueError")


def test_cli_probe_prints_the_dict(tmp_path, capsys):
    clip = write_clip(tmp_path / "clip.y4m")
    assert tcli.main(["probe", clip]) == 0
    assert json.loads(capsys.readouterr().out) == jcli.probe(clip)


# --- the match workflow -----------------------------------------------------


def test_match_meta_json_is_byte_equal(tmp_path):
    sets = [(0.0, 1.5, "21-15"), (1.5, 3.25, ""), (4, 7, "11-9")]
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tworkflow.MatchMeta("1234", [tworkflow.MatchSet(*s) for s in sets]).save(str(tmp_path / "t"))
    jworkflow.MatchMeta("1234", [jworkflow.MatchSet(*s) for s in sets]).save(str(tmp_path / "j"))
    got = (tmp_path / "t" / "match_1234.json").read_bytes()
    assert got == (tmp_path / "j" / "match_1234.json").read_bytes()
    back = tworkflow.MatchMeta.load("1234", str(tmp_path / "j"))
    assert [dataclasses.astuple(s) for s in back.sets] == [tuple(s) for s in sets]


def test_tag_non_interactive_matches_jax(tmp_path, capsys):
    sets = json.dumps([{"start": 0, "end": 0.5, "score": "5-3"}, {"start": 1, "end": 2}])
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tworkflow.tag("7777", str(tmp_path / "t"), sets_json=sets)
    tout = capsys.readouterr().out
    jworkflow.tag("7777", str(tmp_path / "j"), sets_json=sets)
    assert tout.replace("/t/", "/j/") == capsys.readouterr().out
    assert (tmp_path / "t" / "match_7777.json").read_bytes() == \
        (tmp_path / "j" / "match_7777.json").read_bytes()


def test_claim_lockfile(tmp_path):
    lock = str(tmp_path / "x.lock")
    assert tworkflow._claim(lock)
    assert not tworkflow._claim(lock)  # the second worker loses
    assert not jworkflow._claim(lock)  # and so does the JAX package's
    os.unlink(lock)
    assert tworkflow._claim(lock)


def test_stabilise_matches_jax_and_is_idempotent(tmp_path):
    """Each chapter's trajectory on the CPU within the tracked analyser's
    tolerance of JAX's, marked complete, and left alone by a second run.
    The chapters are synthetic shaky clips at 640x480, as the tracked
    analyser's own tests use."""
    d = tmp_path
    write_synthetic(d / "GOPR5555.y4m", "synthetic://shaky?w=640&h=480&n=12&seed=1")
    write_synthetic(d / "GP015555.y4m", "synthetic://shaky?w=640&h=480&n=6&seed=2")
    tworkflow.stabilise("5555", str(d), concurrency=2, device="cpu")
    for seg in ("GOPR5555.y4m", "GP015555.y4m"):
        tpath = str(d / seg) + ".traj.npz"
        assert os.path.exists(tpath) and os.path.exists(tpath + ".complete")
        assert not os.path.exists(tpath + ".lock")
    got = Trajectory.load(str(d / "GOPR5555.y4m.traj.npz"))
    mtime = os.path.getmtime(str(d / "GOPR5555.y4m.traj.npz"))
    (d / "j").mkdir()
    os.link(d / "GOPR5555.y4m", d / "j" / "GOPR5555.y4m")
    jworkflow.stabilise("5555", str(d / "j"), concurrency=1)
    want = JTrajectory.load(str(d / "j" / "GOPR5555.y4m.traj.npz"))
    assert got.num_frames == want.num_frames == 12
    assert angle_deg(got.rotations(), np.asarray(want.rotations())).max() <= ANGLE_TOL_DEG
    tworkflow.stabilise("5555", str(d), device="cpu")  # skipped: file untouched
    assert os.path.getmtime(str(d / "GOPR5555.y4m.traj.npz")) == mtime


class StubRun:
    """``subprocess.run`` for split's child renders: records the command
    and writes the output file the render would."""

    def __init__(self, rc=0):
        self.calls = []
        self.rc = rc

    def __call__(self, cmd, **kw):
        self.calls.append(cmd)
        if self.rc == 0:
            with open(cmd[5], "wb") as f:
                f.write(b"rendered")
        return subprocess.CompletedProcess(cmd, self.rc, "", "render failed")


def test_split_renders_with_the_port_and_resumes(tmp_path, monkeypatch, capsys):
    d = str(tmp_path)
    write_clip(tmp_path / "match_9999.y4m", n=20)
    tworkflow.MatchMeta("9999", [tworkflow.MatchSet(0.0, 0.8, "11-9"),
                                 tworkflow.MatchSet(1.0, 1.9, "11-7")]).save(d)
    run = StubRun()
    monkeypatch.setattr(tworkflow.subprocess, "run", run)
    tworkflow.split("9999", d, concurrency=1, render_args=["--stabilise", "smooth"])
    joined = str(tmp_path / "match_9999.y4m")
    assert run.calls == [
        [sys.executable, "-m", "video_annotator_tpu_torch", "render", joined,
         str(tmp_path / f"match_9999_set{i}.y4m"), "-s", s, "-e", e, "--stabilise", "smooth"]
        for i, s, e in ((1, "0.0", "0.8"), (2, "1.0", "1.9"))]
    for i in (1, 2):
        out = tmp_path / f"match_9999_set{i}.y4m"
        assert out.exists() and (tmp_path / f"match_9999_set{i}.y4m.complete").exists()
        assert not (tmp_path / f"match_9999_set{i}.y4m.lock").exists()
    tworkflow.split("9999", d)  # resume: nothing rendered again
    assert len(run.calls) == 2
    assert capsys.readouterr().out.count("already rendered") == 2


def test_split_skips_a_claimed_set_and_reports_a_failed_render(tmp_path, monkeypatch, capsys):
    d = str(tmp_path)
    write_clip(tmp_path / "match_8888.y4m")
    tworkflow.MatchMeta("8888", [tworkflow.MatchSet(0, 0.3), tworkflow.MatchSet(0.3, 0.6)]).save(d)
    (tmp_path / "match_8888_set1.y4m.lock").write_text("4242")
    run = StubRun(rc=1)
    monkeypatch.setattr(tworkflow.subprocess, "run", run)
    tworkflow.split("8888", d)
    out = capsys.readouterr().out
    assert "set 1: claimed by another worker" in out
    assert "set 2: FAILED" in out and "render failed" in out
    assert len(run.calls) == 1 and not (tmp_path / "match_8888_set2.y4m.complete").exists()
    assert not (tmp_path / "match_8888_set2.y4m.lock").exists()


def test_split_without_join_errors_as_jax(tmp_path):
    d = str(tmp_path)
    tworkflow.MatchMeta("1111", [tworkflow.MatchSet(0, 1)]).save(d)
    got = outcome(tworkflow.split, "1111", d)
    assert got == outcome(jworkflow.split, "1111", d) and got[1] == "FileNotFoundError"


def test_encode_writes_each_set_once(tmp_path, capsys):
    d = str(tmp_path)
    tworkflow.MatchMeta("4444", [tworkflow.MatchSet(0, 1), tworkflow.MatchSet(1, 2)]).save(d)
    write_clip(tmp_path / "match_4444_set1.y4m", n=5)
    tworkflow.encode("4444", d)
    out = capsys.readouterr().out
    assert "set 1: encoded 5 frames" in out and "set 2: no render found" in out
    final = str(tmp_path / "match_4444_set1_final.mp4")
    r = open_reader(final)
    assert (r.meta.width, r.meta.height, len(list(r))) == (96, 64, 5)
    r.close()
    tworkflow.encode("4444", d)
    assert "set 1: already encoded" in capsys.readouterr().out


# --- the CLI ----------------------------------------------------------------


def _subparsers(parser):
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return sub.choices


@pytest.mark.parametrize("command", ["join", "compare", "workflow", "probe"])
def test_cli_subcommand_surface_matches_jax(command):
    """The JAX CLI's options, plus ``--device`` where the subcommand runs
    on a device (the port's form of ``JAX_PLATFORMS=cpu``)."""
    want = {a.dest: a for a in _subparsers(jcli.build_parser())[command]._actions}
    got = {a.dest: a for a in _subparsers(tcli.build_parser())[command]._actions}
    extra = {"device"} if command in ("compare", "workflow") else set()
    assert set(got) == set(want) | extra
    for dest in extra:
        assert (got[dest].default, got[dest].choices) == ("cuda", ("cuda", "cpu"))
    for dest, w in want.items():
        for attr in ("option_strings", "default", "choices", "nargs", "const", "required"):
            assert getattr(got[dest], attr) == getattr(w, attr), (dest, attr)


def options_dict(o):
    d = dataclasses.asdict(o)
    d["preset"] = getattr(d["preset"], "value", d["preset"])
    return d


@pytest.mark.parametrize("argv", [
    ["compare", "in.y4m", "grid.y4m"],
    ["compare", "in.y4m", "grid.y4m", "--compare", "none,smooth,vidstab", "--preset",
     "gopro_h4b_wide43_measured", "--stabilise-radius", "12", "--no-cell-labels", "-v"],
])
def test_cli_compare_builds_jax_options(monkeypatch, argv):
    """``compare`` forces ``--stabilise none`` and renders the grid with the
    RenderOptions the JAX CLI builds for the same command line."""
    seen = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tcompare, "render_compare",
                        lambda s, d, m, o, device: seen.update(torch=(s, d, m, o, device)))
    monkeypatch.setattr(jcompare, "render_compare",
                        lambda s, d, m, o: seen.update(jax=(s, d, m, o)))
    assert tcli.main(list(argv)) == 0
    assert jcli.main(list(argv)) == 0
    (ts, td, tm, to, dev), (js, jd, jm, jo) = seen["torch"], seen["jax"]
    assert (ts, td, tm, dev) == (js, jd, jm, "cuda")
    assert to.stabilise == "none"
    assert options_dict(to) == options_dict(jo)


def test_cli_workflow_dispatches_like_jax(tmp_path, monkeypatch):
    """Each workflow action reaches the port's function with the JAX CLI's
    arguments; ``stabilise`` asks for the card, ``split`` leaves that to
    its child renders, and ``stabilise`` analyses with the JAX package's
    default RenderOptions."""
    calls = []
    for name in ("tag", "stabilise", "split", "encode"):
        monkeypatch.setattr(tworkflow, name,
                            lambda *a, _n=name, **k: calls.append((_n, a, k)))
    monkeypatch.setattr(tgopro, "join", lambda *a, **k: calls.append(("join", a, k)))
    d = str(tmp_path)
    base = ["--directory", d]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(["workflow", "stabilise", "0001"] + base) == 1
    assert tcli.main(["workflow", "split", "0001", "--render-args", "--crop 100:80"] + base) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tcli.main(["workflow", "stabilise", "0001", "--concurrency", "2"] + base) == 0
    assert tcli.main(["workflow", "tag", "0001", "--sets-json", "[]"] + base) == 0
    assert tcli.main(["workflow", "join", "0001"] + base) == 0
    assert tcli.main(["workflow", "encode", "0001", "--encoder", "mp4v"] + base) == 0
    assert calls == [
        ("split", ("0001", d, 1, ["--crop", "100:80"]), {}),
        ("stabilise", ("0001", d, 2), {"device": "cuda"}),
        ("tag", ("0001", d, "[]"), {}),
        ("join", ("0001", f"{d}/match_0001.mp4"), {"directory": d}),
        ("encode", ("0001", d, "mp4v"), {}),
    ]
    assert options_dict(trender.RenderOptions()) == options_dict(JRenderOptions())
