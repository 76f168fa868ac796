"""The torch port's ``--compare`` grid on the CPU, held against the JAX
package's ``pipeline/compare.py``: the grid solver, the mode parser, and
the tiled output video, byte for byte within one count when both
packages warp with the same trajectories (the JAX analysers' own, handed
to the port, so that only the warps and the tiling are compared)."""

import json
import os
from fractions import Fraction

import numpy as np
import pytest
import torch

from test_torch_pipeline import assert_u8_close, read_frames
from test_torch_streaming import few_threads  # noqa: F401 (autouse fixture)
from video_annotator_tpu.models import deshake as jdeshake
from video_annotator_tpu.models import similarity as jsimilarity
from video_annotator_tpu.pipeline import compare as jcompare
from video_annotator_tpu.pipeline.render import RenderOptions as JRenderOptions
from video_annotator_tpu_torch import cli as tcli
from video_annotator_tpu_torch.models import FILTER_ALIASES
from video_annotator_tpu_torch.pipeline import compare as tcompare
from video_annotator_tpu_torch.pipeline import render as trender
from video_annotator_tpu_torch.pipeline.trajectory import Trajectory

OPTS = dict(stabilise_radius=2, preset=None, input_dfov=120.0)


@pytest.mark.parametrize("n", range(1, 10))
def test_comparison_grid_size_matches_jax(n):
    got = tcompare.comparison_grid_size(n)
    assert got == jcompare.comparison_grid_size(n)
    assert got[0] * got[1] >= n


@pytest.mark.parametrize("mode", [
    "none", "fixed", "smooth", "vidstab", "deshake", "dewobble", "similarity:none",
    "vidstab:fixed", "deshake:none", "dewobble:smooth", "deshake_opencl", "rotation:fixed",
])
def test_parse_mode_matches_jax(mode):
    family, stabilise, lock = jcompare._parse_mode(mode)
    assert not lock
    assert tcompare._parse_mode(mode) == (family, stabilise, lock)


@pytest.mark.parametrize("mode,match", [
    ("smooth+shiny", "suffix"), ("vidstab:fixd", "fixd"), ("optical", "unknown"),
    ("vidstab+lock", "lock"), ("dewobble:wobbly", "wobbly"),
])
def test_parse_mode_rejects_what_jax_rejects(mode, match):
    with pytest.raises(ValueError, match=match):
        jcompare._parse_mode(mode)
    with pytest.raises(ValueError, match=match):
        tcompare._parse_mode(mode)


@pytest.mark.parametrize("mode", ["smooth+lock", "horizon", "none+lock", "dewobble+lock"])
def test_parse_mode_horizon_cells_match_jax(mode):
    """The horizon-locked cells, which raised until ``smoothing/horizon.py``
    was ported, now parse as in the JAX package, with the lock flag set."""
    want = jcompare._parse_mode(mode)
    assert want[2] is True
    assert tcompare._parse_mode(mode) == want


def to_port(jtraj):
    return Trajectory(params=np.array(jtraj.params), kind=jtraj.kind, fps=jtraj.fps,
                      width=jtraj.width, height=jtraj.height, source=jtraj.source)


def render_both(monkeypatch, tmp_path, src, modes, **kw):
    """Render the grid with the JAX package, then with the port fed the
    trajectories the JAX analysers returned. Returns both videos."""
    seen = {}

    def recording(name, fn):
        def wrapper(*args, **kwargs):
            seen[name] = fn(*args, **kwargs)
            return seen[name]
        return wrapper

    monkeypatch.setattr(jcompare, "analyse", recording("rotation", jcompare.analyse))
    monkeypatch.setattr(jsimilarity, "analyse_similarity",
                        recording("similarity", jsimilarity.analyse_similarity))
    monkeypatch.setattr(jdeshake, "analyse_deshake",
                        recording("deshake", jdeshake.analyse_deshake))
    jdest, tdest = str(tmp_path / "jax.y4m"), str(tmp_path / "torch.y4m")
    jcompare.render_compare(src, jdest, modes, JRenderOptions(**OPTS, **kw))
    for name, attr in (("rotation", "analyse"), ("similarity", "analyse_similarity"),
                       ("deshake", "analyse_deshake")):
        if name in seen:
            monkeypatch.setattr(tcompare, attr,
                                lambda *a, _t=to_port(seen[name]), **k: _t)
    tcompare.render_compare(src, tdest, modes, trender.RenderOptions(**OPTS, **kw),
                            device="cpu")
    return read_frames(jdest), read_frames(tdest), seen


@pytest.mark.parametrize("modes,labels", [
    (["none", "smooth"], True),
    (["none", "smooth", "vidstab", "deshake"], True),
    (["none", "smooth", "vidstab", "deshake"], False),
    (["fixed", "vidstab:fixed", "deshake:none"], False),
])
def test_render_compare_matches_jax(monkeypatch, tmp_path, modes, labels):
    src = "synthetic://shaky?w=192&h=144&n=6&fps=30&seed=5&shake=0.005"
    (jmeta, jframes), (tmeta, tframes), seen = render_both(
        monkeypatch, tmp_path, src, modes, cell_labels=labels)
    assert set(seen) == {tcompare._parse_mode(m)[0] for m in modes}
    assert (tmeta.width, tmeta.height, tmeta.fps) == (jmeta.width, jmeta.height, jmeta.fps)
    assert len(tframes) == len(jframes) == 6
    for tf, jf in zip(tframes, jframes):
        for tp, jp in zip(tf, jf):
            assert_u8_close(tp, jp)
    rows, cols = tcompare.comparison_grid_size(len(modes))
    y = tframes[2][0]
    h, w = y.shape[0] // rows, y.shape[1] // cols
    for i in range(len(modes)):  # every family rendered content into its cell
        r, c = divmod(i, cols)
        assert y[r * h:(r + 1) * h, c * w:(c + 1) * w].std() > 5, i


def test_render_compare_own_analysers_end_to_end(tmp_path):
    """The port's own analysers feed the four-way grid; the stabilised
    cell differs from the raw one."""
    src = "synthetic://shaky?w=320&h=240&n=6&fps=30&seed=4&shake=0.004"
    dest = str(tmp_path / "cmp.y4m")
    prof = trender.StageProfiler()
    tcompare.render_compare(src, dest, ["none", "smooth", "vidstab", "deshake"],
                            trender.RenderOptions(**OPTS), profiler=prof, device="cpu")
    meta, frames = read_frames(dest)
    assert len(frames) == meta.num_frames == 6
    y, u, v = frames[-1]
    assert u.shape == v.shape == (y.shape[0] // 2, y.shape[1] // 2)
    h, w = y.shape[0] // 2, y.shape[1] // 2
    assert np.abs(y[:h, :w].astype(np.float32) - y[:h, w:].astype(np.float32)).mean() > 0.1
    assert {"decode", "track", "warp", "encode"} <= set(prof.totals()[0])


@pytest.mark.parametrize("modes", [["none", "smooth"], ["none"], ["vidstab", "deshake"]])
def test_render_compare_honours_the_trim_window(tmp_path, modes):
    """Frames 6..11; an all-'none' grid sizes its placeholder trajectory
    to the window, not to the clip."""
    src = "synthetic://shaky?w=192&h=144&n=12&fps=30&seed=7&shake=0.004"
    dest = str(tmp_path / "trim.y4m")
    tcompare.render_compare(src, dest, modes,
                            trender.RenderOptions(start=0.2, duration=0.2, **OPTS),
                            device="cpu")
    meta, frames = read_frames(dest)
    assert len(frames) == meta.num_frames == 6
    if modes == ["none"]:  # the window's first frame, not the clip's
        whole = str(tmp_path / "whole.y4m")
        tcompare.render_compare(src, whole, modes, trender.RenderOptions(**OPTS),
                                device="cpu")
        np.testing.assert_array_equal(frames[0][0], read_frames(whole)[1][6][0])


def test_render_compare_frame_rate(tmp_path):
    src = "synthetic://shaky?w=192&h=144&n=4&fps=30&seed=7&shake=0.004"
    dest = str(tmp_path / "fr.y4m")
    tcompare.render_compare(src, dest, ["none", "smooth"],
                            trender.RenderOptions(frame_rate=15.0, **OPTS), device="cpu")
    meta, frames = read_frames(dest)
    assert meta.fps == Fraction(15, 1) and len(frames) == 4


def test_compare_chroma_padding_is_neutral(tmp_path):
    """Deshake warps at the input size while the rotation cell auto-fits
    larger: the padding is 128 in chroma, never 0 (saturated green)."""
    src = "synthetic://shaky?w=192&h=144&n=3&fps=30&seed=4&shake=0.004"
    dest = str(tmp_path / "cmp.y4m")
    tcompare.render_compare(src, dest, ["smooth", "deshake"],
                            trender.RenderOptions(**OPTS), device="cpu")
    y, u, v = read_frames(dest)[1][0]
    assert u.min() > 0 and v.min() > 0
    assert u[0, -1] == 128 and v[0, -1] == 128 and y[0, -1] == 0  # the padding itself


def test_compare_cell_labels_touch_only_the_top_left_of_each_cell(tmp_path):
    src = "synthetic://shaky?w=192&h=144&n=2&fps=30&seed=4&shake=0.004"
    modes = ["none", "smooth"]
    labeled, plain = str(tmp_path / "lab.y4m"), str(tmp_path / "plain.y4m")
    tcompare.render_compare(src, labeled, modes, trender.RenderOptions(**OPTS),
                            device="cpu")
    tcompare.render_compare(src, plain, modes,
                            trender.RenderOptions(cell_labels=False, **OPTS), device="cpu")
    (ly, lu, lv), (py, pu, pv) = read_frames(labeled)[1][0], read_frames(plain)[1][0]
    assert np.array_equal(lu, pu) and np.array_equal(lv, pv)
    rows, cols = tcompare.comparison_grid_size(2)
    ch, cw = ly.shape[0] // rows, ly.shape[1] // cols
    diff = ly.astype(np.int16) - py.astype(np.int16)
    for i in range(2):
        r, c = divmod(i, cols)
        cell = diff[r * ch:(r + 1) * ch, c * cw:(c + 1) * cw]
        assert np.abs(cell[: ch // 2, : cw // 2]).max() > 60
        assert np.abs(cell[ch // 2:, :]).max() == 0
        assert np.abs(cell[:, cw // 2:]).max() == 0


def test_render_compare_rejects_rolling_shutter(tmp_path):
    with pytest.raises(ValueError, match="rolling-shutter"):
        tcompare.render_compare("synthetic://shaky?w=96&h=64&n=2", str(tmp_path / "x.y4m"),
                                ["none"], trender.RenderOptions(rolling_shutter=1.0, **OPTS),
                                device="cpu")


@pytest.mark.parametrize("kw", [
    dict(interp="bicubic"), dict(projection="equirect"), dict(crop_rect="64:48"),
    dict(prefilter="auto"), dict(debug=True),
])
def test_render_compare_refuses_unported_options(monkeypatch, tmp_path, kw):
    """Every option once refused here now renders the grid as the JAX
    package does, from the JAX analysers' trajectories: ``--interp``,
    ``--projection`` and ``--prefilter`` (K1's modes; at this size no tile
    of the prefilter's level map engages, as the JAX CPU fallback's global
    level does not), ``--crop W:H`` (the canvas's centred 64x48, cut on
    the device before the readback) and ``--debug`` (no HUD on a grid, as
    in the JAX package)."""
    src = "synthetic://shaky?w=96&h=64&n=2"
    (jmeta, jframes), (tmeta, tframes), _ = render_both(
        monkeypatch, tmp_path, src, ["none", "vidstab"], cell_labels=False, **kw)
    assert (tmeta.width, tmeta.height, len(tframes)) == (jmeta.width, jmeta.height, 2)
    if "crop_rect" in kw:
        assert (tmeta.width, tmeta.height) == (64, 48)
    for tf, jf in zip(tframes, jframes):
        for tp, jp in zip(tf, jf):
            assert_u8_close(tp, jp)


def test_cli_compare_reaches_render_compare(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tcompare, "render_compare",
                        lambda *a, **k: calls.append((a, k)))
    rc = tcli.main(["render", "in.y4m", "grid.y4m", "--compare",
                    "none, smooth,vidstab,deshake", "--no-cell-labels"])
    assert rc == 0 and len(calls) == 1
    (source, dest, modes, options), kwargs = calls[0]
    assert (source, dest, modes) == ("in.y4m", "grid.y4m",
                                     ["none", "smooth", "vidstab", "deshake"])
    assert options.cell_labels is False and kwargs == {"device": "cuda"}


def test_cli_reports_an_unported_compare_mode(monkeypatch, capsys):
    """A pipeline error: a malformed ``--crop`` spec stops the CLI with the
    JAX CLI's message (a ``SystemExit``, which exits 1) before any render
    or card check; the compare modes themselves all parse now."""
    import video_annotator_tpu.cli as jcli

    spec = "foo(1):48"
    argv = ["render", "synthetic://shaky?w=96&h=64&n=2", "grid.y4m",
            "--compare", "none,horizon", "--crop", spec]
    with pytest.raises(SystemExit) as want:
        jcli._render_options(jcli.build_parser().parse_args(argv))
    monkeypatch.setattr(tcompare, "render_compare",
                        lambda *a, **k: pytest.fail("rendered a malformed crop"))
    with pytest.raises(SystemExit) as got:
        tcli.main(argv)
    assert str(got.value.code) == str(want.value.code)
    assert "is not W:H[:X:Y]" in str(got.value.code)
    assert [tcompare._parse_mode(m)[0] for m in ("none", "horizon")] == ["rotation"] * 2


def test_cli_filter_takes_every_alias(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(trender, "render", lambda s, d, o, device: seen.append(o.filter))
    for alias in FILTER_ALIASES:
        assert tcli.main(["render", "in.y4m", "out.y4m", "--filter", alias]) == 0
    assert seen == list(FILTER_ALIASES)


def test_cli_trace_writes_the_stages_into_a_chrome_trace(monkeypatch, tmp_path, capsys):
    """``--trace DIR`` wraps the render call in a torch.profiler session
    that writes a Chrome trace into DIR and prints the JAX CLI's line;
    the render's profiler opens each stage as a range of the trace (on the CPU, with the render stubbed: the CLI needs a card to render;
    on one, the trace also holds the CUDA kernels, which ``chip_smoke.py``
    checks)."""
    calls = []

    def fake_render(source, dest, options, device, profiler):
        with torch.profiler.record_function("fake_render"), profiler.stage("track"):
            calls.append((source, dest, device))
            torch.ones(8).sum()

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(trender, "render", fake_render)
    trace_dir = str(tmp_path / "trace")
    assert tcli.main(["render", "in.y4m", "out.y4m", "--trace", trace_dir]) == 0
    assert calls == [("in.y4m", "out.y4m", "cuda")]
    assert f"device trace written to {trace_dir}" in capsys.readouterr().out
    files = os.listdir(trace_dir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(os.path.join(trace_dir, files[0])) as f:
        trace = json.load(f)
    assert any(e.get("name") == "fake_render" for e in trace["traceEvents"])
    assert any(e.get("name") == "track" for e in trace["traceEvents"])
